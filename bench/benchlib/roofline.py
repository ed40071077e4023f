"""Peaks of one NVIDIA H100 SXM and the operations and bytes of the
program's attention kernels, computed from shapes.

Frozen copies: the peaks of ``src/repro_torch/roofline/analysis.py``
(``F32_FLOPS``, ``F64_TC_FLOPS``, ``HBM_BW``; NVIDIA's data sheet, dense
rates at 700 W), and of ``chip_smoke.py``'s ``bound``, ``paged_per_block``
and the byte and operation counts of ``k1_record`` and ``k2_record``
(every pool block that holds a VALID slot read once, plus each input and
output tensor once).
"""
from __future__ import annotations

import math

F32_FLOPS = 67e12          # FLOP/s, fp32 on the CUDA cores (TF32 off)
F64_TC_FLOPS = 67e12       # FLOP/s, fp64 on the tensor cores (K2's products)
HBM_BW = 3.35e12           # bytes/s, HBM3
PEAKS = {"f32": F32_FLOPS, "f64tc": F64_TC_FLOPS}
SCALE_LANES = 16


def bound_s(bytes_: float, flops: float, peak: str = "f32") -> float:
    """The least time the card could take: bytes over HBM or operations
    over the peak of the units that run them, the larger."""
    return max(bytes_ / HBM_BW, flops / PEAKS[peak])


def paged_per_block(BS: int, H: int, D: int) -> int:
    """Bytes of one pool block: K and V codes (one byte a lane) and their
    bf16 scales."""
    return BS * H * (2 * D + 2 * 2 * (D // SCALE_LANES))


def k1_tick(blocks: int, n_valid: int, n_buf: int, L: int, R: int,
            H: int, gq: int, D: int, NB: int, BS: int) -> tuple:
    """(bytes, flops) of one K1 launch (every layer and slot of a tick):
    ``blocks`` pool blocks that hold a VALID slot, ``n_valid`` VALID slots
    and ``n_buf`` buffer entries attended, over all layers and slots."""
    q = L * R * H * gq * D * 4
    planes = 2 * L * R * NB * BS            # slot state and bits, 1 B each
    tables = R * L * NB * 4
    out = q
    buffers = 2 * n_buf * H * D * 2
    bytes_ = blocks * paged_per_block(BS, H, D) + q + planes + tables \
        + R * 4 + out + buffers
    return bytes_, 4 * H * gq * D * (n_valid + n_buf)


def k2_chunk(n_valid: int, rows: int, H: int, gq: int, D: int, NB: int,
             BS: int) -> tuple:
    """(bytes, flops) of one K2 launch (one layer of a prefill chunk of
    ``rows`` queries over a pool holding ``n_valid`` VALID slots, none
    evicted, so ceil(n_valid / BS) blocks)."""
    GQ = rows * gq
    blocks = math.ceil(n_valid / BS)
    bytes_ = blocks * paged_per_block(BS, H, D) + H * GQ * D * 4 \
        + 2 * NB * BS + NB * 4 + H * GQ * D * 4 + 2 * H * GQ * 4
    return bytes_, 4 * H * GQ * D * n_valid


def prefill_chunks(prompt_len: int, big: int, g: int) -> list:
    """(start, rows) of the engine's prefill chunks of a prompt: ``big``
    rows while that many remain, then g-row chunks (the last padded)."""
    out, s0 = [], 0
    while big and prompt_len - s0 >= big:
        out.append((s0, big))
        s0 += big
    out += [(s, g) for s in range(s0, prompt_len, g)]
    return out
