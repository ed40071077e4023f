"""Kernel wrappers with device dispatch (ports ``repro/kernels/ops.py``).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take, on either device.  Then, for tensors on the CPU
it computes its kernel's plain version (``kernels/ref.py``); for CUDA
tensors it launches the hand-written CUDA kernel (``csrc/*.cu``, built by
``kernels/build.py``) or raises — there is no fallback.  It adds one to its
entry of :data:`LAUNCHES` where it launches the kernel and nowhere else,
and one to its entry of :data:`DISPATCHES` where it either launches the
kernel or computes the plain version: on the card the two counts agree,
and on the CPU the second is what ``analysis/census.py`` counts.

Kernels (TPU kernel each replaces in brackets):

* ``paged_decode_attention_fused``   K1 [ct_paged_attention_fused]
                                     (also at head_dim 112, zamba2's)
* ``paged_decode_attention_batched`` K2 [ct_paged_attention_batched]
* ``paged_decode_attention``         K2 through the single-request wrapper
                                     [ct_paged_attention]
* ``prefill_attention_stats``        K3 [flash_prefill(return_stats=True)]
* ``prefill_attention``              K3, stats discarded [flash_prefill]
* ``tbq_group_quant``                K4 [group_quant]
* ``tbq_commit_quant``               K4, one launch per CT cache commit
* ``mamba_scan``                     K5 [mamba_scan]

``buffer_attention`` and ``thinkv_decode_attention`` are the reference's
plain-array helpers of the single-request controller around the wrapper;
``local_heads`` is a rank's share of a head axis under tensor-parallel
serving (``distributed/sharding.py``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import build
from repro_torch.kernels import ref as R

LAUNCHES = {"ct_paged_attention_fused": 0, "ct_paged_attention_batched": 0,
            "ct_paged_attention": 0, "flash_prefill": 0, "group_quant": 0,
            "mamba_scan": 0}

DISPATCHES = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        DISPATCHES[k] = 0


def _plain(name: str) -> None:
    """A wrapper computes its kernel's plain version (CPU tensors)."""
    DISPATCHES[name] += 1


def local_heads(x: torch.Tensor, dim: int, rank: int, n: int
                ) -> torch.Tensor:
    """Rank ``rank``'s contiguous share of the head axis ``dim`` of ``x``
    over ``n`` ranks (the axis must divide by ``n``).  Queries are laid
    out kv-head-major (``Hq = H * gq``), so a contiguous ``Hq / n`` share
    is exactly the queries of the rank's kv heads.  No kernel step reads
    across heads, so a launch over a rank's share computes that share of
    the one-rank launch.  A view, no copy."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"head axis of {size} does not divide over {n} "
                         f"ranks")
    return x.narrow(dim, rank * (size // n), size // n)


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {devs}")
    return False


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


HEAD_DIMS = (16, 32, 64, 128, 256)      # K2's and K3's instances
K1_HEAD_DIMS = (16, 32, 64, 112, 128, 256)    # K1's (112: zamba2-7b's)


def _check_head_dim(kernel: str, d: int, dims=HEAD_DIMS) -> None:
    """A head_dim ``kernel`` has an instance for (:data:`HEAD_DIMS` for K2
    and K3, :data:`K1_HEAD_DIMS` for K1)."""
    if d not in dims:
        raise ValueError(f"{kernel} takes head_dim "
                         f"{', '.join(map(str, dims))} (got {d})")


def _check_paged(d: int, group: int, *planes: torch.Tensor) -> None:
    """What the paged kernels take besides their head_dim: whole scale
    groups, code planes readable 4 bytes at a time."""
    if d % group or group % 4:
        raise ValueError(f"paged attention kernels take head_dim in groups "
                         f"of a multiple of 4 (got D={d}, group={group})")
    if any(p.data_ptr() % 4 for p in planes):
        raise ValueError("code planes must be 4-byte aligned")


def _aligned(what: str, n: int, *ts: torch.Tensor) -> None:
    if any(t.data_ptr() % n for t in ts):
        raise ValueError(f"{what} must be {n}-byte aligned")


K2_ROWS = 64            # query rows per K2 block (csrc/ct_paged_attention.cu)
OUT_COLS = 128          # output columns per K2 or K3 block at most
                        # (out_cols in csrc/f64_mma.cuh)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kv_splits(r: int, h: int, gq: int, nb: int, sms: int, d: int) -> int:
    """How many shares K2 cuts each (slot, kv head, 64-row tile, column
    slice) walk of the live pool blocks into: enough that about two blocks
    run on each of the card's ``sms`` SMs, at most one share per table
    entry and 32.  Head_dim ``d`` above :data:`OUT_COLS` is cut into column
    slices of that width, each its own block.  The split count sets the
    order in which the merge adds the partial sums, so ``h`` is the
    MODEL's kv-head count even when a launch covers a rank's share of the
    heads: every rank then splits each head's walk as one rank does, and
    its output is that share of the one-rank launch's, bit for bit."""
    tiles = r * h * -(-gq // K2_ROWS) * max(1, d // OUT_COLS)
    return max(1, min(2 * sms // tiles, nb, 32))


def _launch(name: str, fn: str, *args) -> None:
    rc = build.kernel(fn)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1
    DISPATCHES[name] += 1


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def paged_decode_attention_fused(qh, k_codes, v_codes, k_scales, v_scales,
                                 slot_state, slot_bits, block_table,
                                 buf_k, buf_v, buf_len, *, group: int = 16):
    """A whole decode tick's attention in one launch: every layer and slot,
    quantized pool merged with the fp TBQ buffer.

    qh [L, R, H, GQ, D] f32; planes [L, NP, BS, H, ...] (codes uint8,
    scales bf16); slot_state/slot_bits [L, R, NB, BS] uint8; block_table
    [R, L, NB] int32 raw; buf_k/buf_v [L, R, G, H, D] bf16; buf_len [R]
    int32.  Returns the final out [L, R, H, GQ, D] f32.
    """
    args = (qh, k_codes, v_codes, k_scales, v_scales, slot_state, slot_bits,
            block_table, buf_k, buf_v, buf_len)
    on_cpu = _on_cpu(*args)
    L, r, h, gq, d = qh.shape
    np_, bs = k_codes.shape[1:3]
    nb = block_table.shape[-1]
    g = buf_k.shape[2]
    _check("qh", qh, torch.float32)
    for n, t in (("k_codes", k_codes), ("v_codes", v_codes)):
        _check(n, t, torch.uint8, (L, np_, bs, h, d))
    for n, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        _check(n, t, torch.bfloat16, (L, np_, bs, h, d // group))
    for n, t in (("slot_state", slot_state), ("slot_bits", slot_bits)):
        _check(n, t, torch.uint8, (L, r, nb, bs))
    _check("block_table", block_table, torch.int32, (r, L, nb))
    for n, t in (("buf_k", buf_k), ("buf_v", buf_v)):
        _check(n, t, torch.bfloat16, (L, r, g, h, d))
    _check("buf_len", buf_len, torch.int32, (r,))
    if on_cpu:
        _plain("ct_paged_attention_fused")
        return R.ct_paged_attention_fused_ref(*args, group=group)
    _check_head_dim("K1", d, K1_HEAD_DIMS)
    _check_paged(d, group, k_codes, v_codes)
    if group != 16 or bs % 4:
        raise ValueError(f"K1 takes a scale per 16 lanes and a block size "
                         f"that is a multiple of 4 (got group={group}, "
                         f"BS={bs})")
    _aligned("the code planes", 16, k_codes, v_codes)
    _aligned("scale planes", 4, k_scales, v_scales)
    _aligned("buffer planes", 16, buf_k, buf_v)
    out = torch.empty_like(qh)
    _launch("ct_paged_attention_fused", "ct_paged_attention_fused",
            *map(_ptr, args), _ptr(out), L, r, h, gq, d, np_, bs, nb, g,
            group, 1.0 / math.sqrt(d))
    return out


def paged_decode_attention_batched(qh, k_codes, v_codes, k_scales, v_scales,
                                   slot_state, slot_bits, block_table, *,
                                   group: int = 16,
                                   split_heads: Optional[int] = None):
    """Paged attention over the shared pool for one layer, every slot.

    qh [R, H, GQ, D] f32; planes [NP, BS, H, ...]; slot_state/slot_bits
    [R, NB, BS] uint8; block_table [R, NB] int32 raw.  ``split_heads`` is
    the model's kv-head count when H is a rank's share of it (the walk's
    split count follows it, :func:`kv_splits`); None means H.  Returns
    (out [R, H, GQ, D], m [R, H, GQ, 1], l [R, H, GQ, 1]) f32.
    """
    return _batched("ct_paged_attention_batched", qh, k_codes, v_codes,
                    k_scales, v_scales, slot_state, slot_bits, block_table,
                    group, split_heads)


def paged_decode_attention(q, k_codes, v_codes, k_scales, v_scales,
                           slot_state, slot_bits, block_table, *,
                           group: int = 16):
    """Single-request paged attention (the wrapper ``ct_paged_attention``):
    the PHYSICAL ``[NP, BS]`` metadata is gathered through the raw table
    ``[NB]`` (``ref.logical_metadata``: an unmapped -1 entry reads block 0
    with its state masked to FREE), then one K2 launch with R = 1, counted
    as
    ``LAUNCHES["ct_paged_attention"]``.

    q [Hq, D] f32; planes [NP, BS, H, ...]; slot_state/slot_bits [NP, BS]
    uint8; block_table [NB] int32.  Returns (out [Hq, D], m [H, GQ, 1],
    l [H, GQ, 1]) f32.
    """
    _on_cpu(q, k_codes, v_codes, k_scales, v_scales, slot_state, slot_bits,
            block_table)
    hq, d = q.shape
    np_, bs, h = k_codes.shape[:3]
    if hq % h:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {h}")
    _check("q", q, torch.float32)
    for n, t in (("slot_state", slot_state), ("slot_bits", slot_bits)):
        _check(n, t, torch.uint8, (np_, bs))
    _check("block_table", block_table, torch.int32)
    if block_table.dim() != 1:
        raise ValueError(f"block_table: expected [NB], got "
                         f"{tuple(block_table.shape)}")
    state, bits = R.logical_metadata(slot_state, slot_bits, block_table)
    out, m, l = _batched("ct_paged_attention",
                         q.reshape(1, h, hq // h, d), k_codes, v_codes,
                         k_scales, v_scales, state[None], bits[None],
                         block_table[None], group)
    return out[0].reshape(hq, d), m[0], l[0]


def _batched(name, qh, k_codes, v_codes, k_scales, v_scales, slot_state,
             slot_bits, block_table, group, split_heads=None):
    """K2's checks and launch, counted under ``name``."""
    args = (qh, k_codes, v_codes, k_scales, v_scales, slot_state, slot_bits,
            block_table)
    on_cpu = _on_cpu(*args)
    r, h, gq, d = qh.shape
    np_, bs = k_codes.shape[:2]
    nb = block_table.shape[-1]
    _check("qh", qh, torch.float32)
    for n, t in (("k_codes", k_codes), ("v_codes", v_codes)):
        _check(n, t, torch.uint8, (np_, bs, h, d))
    for n, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        _check(n, t, torch.bfloat16, (np_, bs, h, d // group))
    for n, t in (("slot_state", slot_state), ("slot_bits", slot_bits)):
        _check(n, t, torch.uint8, (r, nb, bs))
    _check("block_table", block_table, torch.int32, (r, nb))
    _check_head_dim("K2", d)
    split_heads = h if split_heads is None else int(split_heads)
    if split_heads % h:
        raise ValueError(f"split_heads {split_heads} is not a multiple of "
                         f"the launch's {h} kv heads")
    if on_cpu:
        _plain(name)
        return R.ct_paged_attention_batched_ref(*args, group=group)
    _check_paged(d, group, k_codes, v_codes)
    if group != 16 or bs % 8 or bs > 32:
        raise ValueError(f"K2 takes a scale per 16 lanes and a block size "
                         f"of 8, 16, 24 or 32 (got group={group}, BS={bs})")
    _aligned("qh and the code planes", 16, qh, k_codes, v_codes)
    _aligned("scale planes", 4, k_scales, v_scales)
    out = torch.empty_like(qh)
    m = torch.empty((r, h, gq, 1), dtype=torch.float32, device=qh.device)
    l = torch.empty_like(m)
    ns = kv_splits(r, split_heads, gq, nb, _sm_count(qh.device.index or 0),
                   d)
    part = torch.empty((ns, r, h, gq, d) if ns > 1 else (0,),
                       dtype=torch.float32, device=qh.device)
    pml = torch.empty((ns, r, h, gq, 2) if ns > 1 else (0,),
                      dtype=torch.float32, device=qh.device)
    _launch(name, "ct_paged_attention_batched", *map(_ptr, args), _ptr(out),
            _ptr(m), _ptr(l), _ptr(part), _ptr(pml), r, h, gq, d, np_, bs,
            nb, group, ns, 1.0 / math.sqrt(d))
    return out, m, l


def buffer_attention(q, buf_k, buf_v, buf_len):
    """Flash stats over one request's full-precision TBQ buffer (plain
    torch, as in the reference).  q [Hq, D]; buf_k/buf_v [G, H, D];
    buf_len [] int.  Returns (out [Hq, D], m [H, GQ, 1], l [H, GQ, 1])."""
    hq, d = q.shape
    h = buf_k.shape[1]
    out, m, l = R.buffer_attention_batched_ref(
        q.reshape(1, h, hq // h, d), buf_k[None], buf_v[None],
        buf_len.reshape(1))
    return out[0].reshape(hq, d), m[0], l[0]


def thinkv_decode_attention(dims, cache, view, q: torch.Tensor,
                            layer: int) -> torch.Tensor:
    """One layer's ThinKV decode attention for a single request: its paged
    pool through :func:`paged_decode_attention` (the request's view is its
    physical pool, so the table is the identity) merged with the fp buffer.

    ``dims``/``cache``/``view`` are ``core.ct_cache``'s CacheDims, CTCache
    and PoolView; q [Hq, D] f32.  Returns out [Hq, D] f32.
    """
    hq, d = q.shape
    table = torch.arange(dims.NB, dtype=torch.int32, device=q.device)
    shp = (dims.NB, dims.BS)
    out_p, m_p, l_p = paged_decode_attention(
        q, view.k_codes[layer], view.v_codes[layer], view.k_scales[layer],
        view.v_scales[layer], cache.slot_state[layer].reshape(shp),
        cache.slot_bits[layer].reshape(shp), table, group=Q.GROUP)
    out_b, m_b, l_b = buffer_attention(q, cache.buf_k[layer],
                                       cache.buf_v[layer], cache.buf_len)
    h = m_p.shape[0]
    merged = R.merge_flash_ref(out_p.reshape(h, -1, d), m_p, l_p,
                               out_b.reshape(h, -1, d), m_b, l_b)
    return merged.reshape(hq, d)


def prefill_attention_stats(q, k, v, *, causal: bool = True, window: int = 0,
                            n_valid: Optional[int] = None):
    """Blocked causal attention with per-query flash stats.

    q [S, Hq, D], k/v [S, H, D] f32.  ``n_valid`` masks the keys at index
    ``>= n_valid`` (a padded prefill chunk).  Returns (out [S, Hq, D],
    m [S, Hq, 1], l [S, Hq, 1]).
    """
    on_cpu = _on_cpu(q, k, v)
    s_len, hq, d = q.shape
    h = k.shape[1]
    if hq % h:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {h}")
    _check("q", q, torch.float32)
    _check("k", k, torch.float32, (s_len, h, d))
    _check("v", v, torch.float32, (s_len, h, d))
    _check_head_dim("K3", d)
    if on_cpu:
        _plain("flash_prefill")
        kv_valid = None if n_valid is None else \
            torch.arange(s_len) < n_valid
        return R.flash_prefill_stats_ref(q, k, v, causal=causal,
                                         window=window, kv_valid=kv_valid)
    _aligned("q, k and v", 16, q, k, v)
    out = torch.empty_like(q)
    m = torch.empty((s_len, hq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch("flash_prefill", "flash_prefill_stats", _ptr(q), _ptr(k),
            _ptr(v), _ptr(out), _ptr(m), _ptr(l), s_len, hq, h, d,
            int(causal), int(window),
            s_len if n_valid is None else int(n_valid), 1.0 / math.sqrt(d))
    return out, m, l


def prefill_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Blocked causal attention for prefill (``flash_prefill`` without
    stats): K3, whose flash stats are discarded.  q [S, Hq, D], k/v
    [S, H, D] f32 -> out [S, Hq, D]."""
    return prefill_attention_stats(q, k, v, causal=causal, window=window)[0]


def mamba_scan(x, dt, b, c, a):
    """Mamba-1 selective scan from ``h_0 = 0`` (K5).

    x, dt [S, di] or [B, S, di]; b, c [S, N] or [B, S, N]; a [di, N]
    (negative); all f32, N <= 16.  Returns y shaped like x, f32.  A
    leading batch axis makes one launch for every row.
    """
    on_cpu = _on_cpu(x, dt, b, c, a)
    if x.dim() not in (2, 3):
        raise ValueError(f"x: expected [S, di] or [B, S, di], got "
                         f"{tuple(x.shape)}")
    *lead, s_len, di = x.shape
    n = a.shape[-1]
    if not 1 <= n <= 16:
        raise ValueError(f"mamba_scan takes a state size of 1 to 16 "
                         f"(got N={n})")
    _check("x", x, torch.float32)
    _check("dt", dt, torch.float32, x.shape)
    _check("b", b, torch.float32, (*lead, s_len, n))
    _check("c", c, torch.float32, (*lead, s_len, n))
    _check("a", a, torch.float32, (di, n))
    if on_cpu:
        _plain("mamba_scan")
        return R.mamba_scan_ref(x, dt, b, c, a)
    y = torch.empty_like(x)
    _launch("mamba_scan", "mamba_scan", _ptr(x), _ptr(dt), _ptr(b), _ptr(c),
            _ptr(a), _ptr(y), lead[0] if lead else 1, s_len, di, n)
    return y


def tbq_group_quant(x: torch.Tensor, bits: int, group: int = 16):
    """TBQ group quantization: x [N, D] f32 -> (codes uint8 [N, D],
    scales bf16 [N, D // group]), bit-exact to ``quantize_group``."""
    if bits not in (2, 4, 8):
        raise ValueError(f"unsupported bits={bits}")
    on_cpu = _on_cpu(x)
    n, d = x.shape
    if d % group:
        raise ValueError(f"D={d} not divisible by group {group}")
    _check("x", x, torch.float32)
    if on_cpu:
        _plain("group_quant")
        return R.group_quant_ref(x, bits, group)
    if group != Q.GROUP:
        raise ValueError(f"K4 takes a scale per {Q.GROUP} lanes (got "
                         f"group={group})")
    _aligned("x", 16, x)
    codes = torch.empty((n, d), dtype=torch.uint8, device=x.device)
    scales = torch.empty((n, d // group), dtype=torch.bfloat16,
                         device=x.device)
    _launch("group_quant", "group_quant", _ptr(x), _ptr(codes),
            _ptr(scales), n, d, group, bits)
    return codes, scales


def tbq_commit_quant(buf_k: torch.Tensor, buf_v: torch.Tensor,
                     bits: torch.Tensor, levels):
    """One CT cache commit's quantization in one K4 launch: the bf16 TBQ
    buffers buf_k/buf_v [..., D] at the width ``bits`` (an int32 scalar
    tensor on their device, ``policy.psi_bits``) resolves to against the
    policy's precision ``levels``: the bits if they are a level, else the
    first level (the reference's selection chain).  Returns (k codes uint8,
    k scales bf16 [..., D // 16], v codes, v scales), bit-exact to
    ``ref.group_quant_commit_ref``; nothing is read back to the host."""
    levels = tuple(int(b) for b in levels)
    if not levels or any(b not in (2, 4, 8) for b in levels):
        raise ValueError(f"precision levels must be a non-empty subset of "
                         f"(2, 4, 8) (got {levels})")
    on_cpu = _on_cpu(buf_k, buf_v, bits)
    d, group = buf_k.shape[-1], Q.GROUP
    if d % group:
        raise ValueError(f"D={d} not divisible by group {group}")
    _check("buf_k", buf_k, torch.bfloat16)
    _check("buf_v", buf_v, torch.bfloat16, buf_k.shape)
    _check("bits", bits, torch.int32, ())
    if not buf_k.device == buf_v.device == bits.device:
        raise ValueError(f"buffers and bits on different devices: "
                         f"{buf_k.device}, {buf_v.device}, {bits.device}")
    if on_cpu:
        _plain("group_quant")
        return R.group_quant_commit_ref(buf_k, buf_v, bits, levels)
    _aligned("buf_k and buf_v", 16, buf_k, buf_v)
    shape, dev = buf_k.shape, buf_k.device
    kc, vc = (torch.empty(shape, dtype=torch.uint8, device=dev)
              for _ in range(2))
    ks, vs = (torch.empty((*shape[:-1], d // group), dtype=torch.bfloat16,
                          device=dev) for _ in range(2))
    _launch("group_quant", "group_quant_commit", _ptr(buf_k), _ptr(buf_v),
            _ptr(kc), _ptr(vc), _ptr(ks), _ptr(vs), _ptr(bits),
            buf_k.numel() // group, levels[0],
            sum(1 << b for b in set(levels)))
    return kc, ks, vc, vs
