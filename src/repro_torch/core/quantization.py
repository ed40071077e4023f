"""TBQ data formats: FP8-E4M3 group scales over NVFP4, ternary and int8 codes.

Ports ``repro/core/quantization.py`` (the channel-group cache path):
``e4m3_round``, ``_e4m3_next_up``, ``_group_scale``, the nvfp4 / ternary /
int codecs, ``quantize_group``, ``dequantize_group`` and
``dequantize_by_bitcode``; and the comparison and accounting half: the
KIVI per-channel baseline (``quantize_per_channel`` /
``dequantize_per_channel``), per-tensor FP8 (``quantize_fp8`` /
``dequantize_fp8``), true 2- and 4-bit storage (``pack_nibbles`` /
``unpack_nibbles``, ``pack_ternary`` / ``unpack_ternary``) and the
paper's memory accounting (``cache_bits_per_element``).  The results are
bit-exact to the reference: one uint8 code per element (low bits used) and
E4M3-valued float32 scales, one per ``g`` channels (per channel for KIVI,
one f32 scale per tensor for FP8).  Nothing here launches a kernel, on
either device (the reference has none for them either).
"""
from __future__ import annotations

from typing import Tuple

import torch

F8 = torch.float8_e4m3fn
E4M3_MAX = 448.0
NVFP4_MAX = 6.0
NVFP4_THRESHOLDS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)
GROUP = 16
SCALE_EPS = 2 ** -16
QMAX = {2: 1.0, 4: NVFP4_MAX, 8: 127.0}


def e4m3_round(x: torch.Tensor) -> torch.Tensor:
    """Round ``x`` to the FP8-E4M3 grid (returned in f32)."""
    return x.clamp(-E4M3_MAX, E4M3_MAX).to(F8).to(torch.float32)


def _e4m3_next_up(s: torch.Tensor) -> torch.Tensor:
    """Next E4M3 value above ``s`` (positive, on the grid): an exact bit
    increment of the f8 pattern, correct in the subnormal range too."""
    bits = s.to(F8).view(torch.uint8)
    up = (bits + 1).view(F8).to(torch.float32)
    # the increment past the top of the grid is NaN: stay at the maximum
    return torch.where(s >= E4M3_MAX, torch.full_like(up, E4M3_MAX), up)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once, as IEEE division, on both devices: CUDA
    divides by a Python scalar as a product with its reciprocal, which can
    land one ulp off; a tensor divisor on the same device (filled there:
    no copy from the host) is divided."""
    return x / x.new_full((), c)


def _group_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """E4M3 group scale, bumped one grid step when round-to-nearest lands
    below ``amax / qmax`` so that ``|x| / s`` never exceeds ``qmax``."""
    raw = _div(amax.clamp_min(SCALE_EPS), qmax)
    s = e4m3_round(raw)
    s = torch.where(s * qmax < amax, _e4m3_next_up(s), s)
    return s.clamp_min(SCALE_EPS)


def nvfp4_encode(x: torch.Tensor) -> torch.Tensor:
    """x (pre-scaled, |x| <= 6) -> uint8 codes ``s << 3 | mag_idx``."""
    sign = (x < 0).to(torch.uint8)
    mag = x.abs()
    idx = torch.zeros_like(sign)
    for t in NVFP4_THRESHOLDS:
        idx = idx + (mag >= t).to(torch.uint8)
    return (sign << 3) | idx


def nvfp4_decode(codes: torch.Tensor) -> torch.Tensor:
    c = codes.to(torch.int32)
    sign = 1.0 - 2.0 * ((c >> 3) & 1).to(torch.float32)
    idx = c & 7
    exp = (idx >> 1).to(torch.float32)
    man = (idx & 1).to(torch.float32)
    mag = torch.where(idx < 2, 0.5 * man,
                      (1.0 + 0.5 * man) * torch.exp2(exp - 1.0))
    return sign * mag


def ternary_encode(x: torch.Tensor) -> torch.Tensor:
    """x (pre-scaled, |x| <= 1) -> uint8 codes {0: zero, 1: +1, 3: -1}."""
    v = torch.round(x).clamp(-1, 1).to(torch.int32)
    return torch.where(v < 0, 3, v).to(torch.uint8)


def ternary_decode(codes: torch.Tensor) -> torch.Tensor:
    c = codes.to(torch.int32) & 3
    one = torch.ones((), dtype=torch.float32, device=codes.device)
    return torch.where(c == 3, -one, torch.where(c == 1, one, 0.0 * one))


def int_encode(x: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    v = torch.round(x).clamp(-qmax - 1, qmax).to(torch.int32)
    return (v & (2 ** bits - 1)).to(torch.uint8)


def int_decode(codes: torch.Tensor, bits: int) -> torch.Tensor:
    c = codes.to(torch.int32) & (2 ** bits - 1)
    return torch.where(c >= 2 ** (bits - 1), c - 2 ** bits, c).to(
        torch.float32)


def _groups(x: torch.Tensor, g: int) -> torch.Tensor:
    d = x.shape[-1]
    if d % g:
        raise ValueError(f"head_dim {d} not divisible by group {g}")
    return x.reshape(*x.shape[:-1], d // g, g)


def quantize_group(x: torch.Tensor, bits: int, g: int = GROUP
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along channel groups of ``g``: x [..., d] ->
    (codes uint8 [..., d], scales f32 [..., d // g] on the E4M3 grid)."""
    if bits not in QMAX:
        raise ValueError(f"unsupported bits={bits}")
    xg = _groups(x.to(torch.float32), g)
    amax = xg.abs().amax(dim=-1)
    scale = _group_scale(amax, QMAX[bits])
    return _encode(xg / scale[..., None], bits).reshape(x.shape), scale


def _encode(y: torch.Tensor, bits: int) -> torch.Tensor:
    if bits == 4:
        return nvfp4_encode(y)
    if bits == 2:
        return ternary_encode(y)
    return int_encode(y, 8)


def _decode(codes: torch.Tensor, bits: int) -> torch.Tensor:
    if bits == 4:
        return nvfp4_decode(codes)
    if bits == 2:
        return ternary_decode(codes)
    if bits == 8:
        return int_decode(codes, 8)
    raise ValueError(f"unsupported bits={bits}")


def dequantize_group(codes: torch.Tensor, scales: torch.Tensor, bits: int,
                     g: int = GROUP) -> torch.Tensor:
    vg = _groups(_decode(codes, bits), g)
    return (vg * scales[..., None].to(torch.float32)).reshape(codes.shape)


def dequantize_by_bitcode(codes: torch.Tensor, scales: torch.Tensor,
                          bits_arr: torch.Tensor, g: int = GROUP
                          ) -> torch.Tensor:
    """Dequantize with a per-element bit width in {2, 4, 8}; ``bits_arr``
    broadcasts against ``codes[..., :1]`` (e.g. one width per token)."""
    vals = torch.where(bits_arr == 2, ternary_decode(codes),
                       torch.where(bits_arr == 4, nvfp4_decode(codes),
                                   int_decode(codes, 8)))
    vg = _groups(vals, g)
    return (vg * scales[..., None].to(torch.float32)).reshape(codes.shape)


# ---------------------------------------------------------------------------
# KIVI-style per-channel key quantization (comparison only)
# ---------------------------------------------------------------------------

def quantize_per_channel(x: torch.Tensor, bits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KIVI per-channel: one scale per channel, shared across the token
    group.  x [g_tokens, d] -> (codes uint8 [g, d], scales f32 [d])."""
    if bits not in QMAX:
        raise ValueError(f"unsupported bits={bits}")
    xf = x.to(torch.float32)
    scale = _group_scale(xf.abs().amax(dim=0), QMAX[bits])
    return _encode(xf / scale[None, :], bits), scale


def dequantize_per_channel(codes: torch.Tensor, scales: torch.Tensor,
                           bits: int) -> torch.Tensor:
    return _decode(codes, bits) * scales[None, :]


# ---------------------------------------------------------------------------
# FP8 per-tensor (the paper's highest-precision option for R thoughts)
# ---------------------------------------------------------------------------

def quantize_fp8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (codes ``float8_e4m3fn``, one f32 scale): amax maps to 448."""
    xf = x.to(torch.float32)
    scale = _div(xf.abs().amax().clamp_min(SCALE_EPS), E4M3_MAX)
    return (xf / scale).to(F8), scale


def dequantize_fp8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


# ---------------------------------------------------------------------------
# Packing: two 4-bit codes per byte (element 2i low), four 2-bit codes per
# byte (element 4i lowest)
# ---------------------------------------------------------------------------

def _pack(codes: torch.Tensor, per: int, width: int) -> torch.Tensor:
    """``per`` codes of ``width`` bits into a byte, as the reference packs
    them: the codes are not masked (a nibble code above 15 spills into its
    neighbour's bits in both packages); the shifts wrap in uint8."""
    d = codes.shape[-1]
    if d % per:
        raise ValueError(f"last axis {d} is not a multiple of {per}")
    c = codes.to(torch.uint8).reshape(*codes.shape[:-1], d // per, per)
    out = c[..., 0]
    for i in range(1, per):
        out = out | (c[..., i] << (width * i))
    return out


def _unpack(packed: torch.Tensor, per: int, width: int) -> torch.Tensor:
    mask = (1 << width) - 1
    parts = [(packed >> (width * i)) & mask for i in range(per)]
    return torch.stack(parts, dim=-1).reshape(*packed.shape[:-1],
                                              packed.shape[-1] * per)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """[..., d] 4-bit codes (uint8) -> [..., d // 2] packed uint8."""
    return _pack(codes, 2, 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    return _unpack(packed, 2, 4)


def pack_ternary(codes: torch.Tensor) -> torch.Tensor:
    """[..., d] 2-bit codes -> [..., d // 4] packed uint8 (true 2-bit
    storage, what the memory accounting counts for T thoughts)."""
    return _pack(codes & 3, 4, 2)


def unpack_ternary(packed: torch.Tensor) -> torch.Tensor:
    return _unpack(packed, 4, 2)


# ---------------------------------------------------------------------------
# Memory accounting (paper Sec. 2: Mem(KV) proportional to
# (I + b Lgen) a beta)
# ---------------------------------------------------------------------------

def cache_bits_per_element(bits: int, g: int = GROUP,
                           physical_nibble_plane: bool = True) -> float:
    """Bits per element with the E4M3 group scale (8 / g bits).  The CT
    cache keeps every code below 8 bits in a nibble
    (``physical_nibble_plane``); False gives the paper's 2-bit-packed T."""
    payload = 4.0 if (physical_nibble_plane and bits < 8) else float(bits)
    return payload + 8.0 / g
