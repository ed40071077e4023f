"""Plain PyTorch versions of every kernel of the port (K1-K5, K4's
one-launch commit and the single-request ``ct_paged_attention`` wrapper),
and of the CUDA kernels' decompositions: K1's warp-split walk
(``ct_paged_attention_fused_warps_ref``), K2's split-KV walk
(``ct_paged_attention_split_ref``) and K5's split state lanes
(``mamba_scan_lanes_ref``).

Ports ``repro/kernels/ref.py``.  Each function has its kernel's exact
interface, so ``ops`` can take it for a CPU tensor, the CPU tests can hold
it against the JAX oracles, and ``chip_smoke.py`` can hold each CUDA
kernel against it on the card.  Batch axes the reference ``vmap``s over
are written out (``mamba_scan_ref`` also takes an optional leading batch
axis, which K5 does).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import quantization as Q

NEG_INF = -1e30
VALID = 1


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or kept in f64 (a plain version evaluated in f64)."""
    return t if t.dtype == torch.float64 else t.float()


def _masked_softmax_stats(s: torch.Tensor, valid: torch.Tensor):
    """Flash stats of masked scores: (p / l, m, l) over the last axis."""
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return p / l.clamp_min(1e-30), m, l


def ct_paged_attention_batched_ref(qh, k_codes, v_codes, k_scales, v_scales,
                                   slot_state, slot_bits, block_table, *,
                                   group: int = 16):
    """Paged attention over the shared quantized pool, one layer, every slot.

    qh [R, H, GQ, D]; planes [NP, BS, H, ...]; slot_state/slot_bits
    [R, NB, BS] logical; block_table [R, NB] raw (-1 clamped: unmapped
    slots are FREE).  Returns (out [R, H, GQ, D], m, l [R, H, GQ, 1]).
    """
    r, _, _, d = qh.shape
    nb, bs = slot_state.shape[1:]
    n = nb * bs
    table = block_table.clamp_min(0).long()

    def take(plane):
        return plane[table].reshape(r, n, *plane.shape[2:])

    bits = slot_bits.reshape(r, n).to(torch.int32)[..., None, None]
    k = Q.dequantize_by_bitcode(take(k_codes), take(k_scales).float(), bits,
                                g=group)                     # [R, n, H, D]
    v = Q.dequantize_by_bitcode(take(v_codes), take(v_scales).float(), bits,
                                g=group)
    valid = (slot_state.reshape(r, n) == VALID)[:, None, None, :]
    s = torch.einsum("rhgd,rnhd->rhgn", qh.float(), k) / math.sqrt(d)
    p, m, l = _masked_softmax_stats(s, valid)
    return torch.einsum("rhgn,rnhd->rhgd", p, v), m, l


def ct_paged_attention_split_ref(qh, k_codes, v_codes, k_scales, v_scales,
                                 slot_state, slot_bits, block_table, *,
                                 splits: int, group: int = 16):
    """K2's split-KV walk in plain torch, the CUDA kernel's decomposition
    of :func:`ct_paged_attention_batched_ref`: per slot, the live logical
    blocks (those holding a VALID slot, in table order) are cut into
    ``splits`` shares, share s taking ``[s n // splits, (s + 1) n //
    splits)`` of the n live blocks; each share gives a partial (unnormalised
    out, m, l) (an empty one ``(0, -1e30, 0)``) and the partials are merged
    as ``merge_splits_kernel`` does.  Same signature and result as the
    batched version."""
    outs, ms, ls = [], [], []
    for i in range(qh.shape[0]):
        live = _live_blocks(slot_state[i])
        n = live.numel()
        parts = [_pool_partial(qh[i:i + 1], k_codes, v_codes, k_scales,
                               v_scales, slot_state[i:i + 1],
                               slot_bits[i:i + 1], block_table[i:i + 1],
                               live[s * n // splits:(s + 1) * n // splits],
                               group) for s in range(splits)]
        out, m, l = _merge_partials(parts)
        outs.append(out)
        ms.append(m)
        ls.append(l)
    return torch.cat(outs), torch.cat(ms), torch.cat(ls)


def _live_blocks(state):
    """The logical blocks of one slot's [NB, BS] state that hold a VALID
    slot, in table order (the kernels' compacted walk)."""
    return torch.nonzero((state == VALID).any(-1)).flatten()


def _pool_partial(qh, k_codes, v_codes, k_scales, v_scales, slot_state,
                  slot_bits, block_table, blocks, group):
    """One share of a slot's pool walk (``blocks``, logical indices) as an
    unnormalised partial (out * l, m, l); an empty share is (0, -1e30, 0)."""
    if blocks.numel():
        o, m, l = ct_paged_attention_batched_ref(
            qh, k_codes, v_codes, k_scales, v_scales, slot_state[:, blocks],
            slot_bits[:, blocks], block_table[:, blocks], group=group)
        return o * l, m, l
    m = qh.new_full(qh.shape[:-1] + (1,), NEG_INF)
    return torch.zeros_like(qh), m, torch.zeros_like(m)


def _merge_partials(parts):
    """The flash merge of unnormalised partials (acc, m, l): (out, m, l) with
    out = sum_s e^(m_s - M) acc_s / max(L, 1e-30), M = max_s m_s and
    L = sum_s e^(m_s - M) l_s (rows no share saw keep M = -1e30, L = 0)."""
    m = torch.stack([p[1] for p in parts]).amax(0)
    w = [torch.exp(p[1] - m) for p in parts]
    l = sum(wi * p[2] for wi, p in zip(w, parts))
    acc = sum(wi * p[0] for wi, p in zip(w, parts))
    return acc / l.clamp_min(1e-30), m, l


def logical_metadata(slot_state, slot_bits, block_table):
    """PHYSICAL ``[NP, BS]`` slot_state/slot_bits -> the request's logical
    ``[NB, BS]`` view through its raw table ``[NB]``.  An unmapped (-1)
    entry gathers physical block 0 with its state masked to FREE, so -1
    means "no tokens here" whatever block 0 holds."""
    safe = block_table.clamp_min(0).long()
    state = torch.where((block_table >= 0)[:, None], slot_state[safe], 0)
    return state.to(slot_state.dtype), slot_bits[safe]


def ct_paged_attention_ref(q, k_codes, v_codes, k_scales, v_scales,
                           slot_state, slot_bits, block_table, *,
                           group: int = 16):
    """Single-request paged attention (the reference's
    ``ct_paged_attention_ref``): physical metadata through
    :func:`logical_metadata`, then the batched version with R = 1.

    q [Hq, D]; planes [NP, BS, H, ...]; slot_state/slot_bits [NP, BS];
    block_table [NB] raw.  Returns (out [Hq, D], m, l [H, GQ, 1]).
    """
    hq, d = q.shape
    h = k_codes.shape[2]
    state, bits = logical_metadata(slot_state, slot_bits, block_table)
    out, m, l = ct_paged_attention_batched_ref(
        q.reshape(1, h, hq // h, d), k_codes, v_codes, k_scales, v_scales,
        state[None], bits[None], block_table[None], group=group)
    return out[0].reshape(hq, d), m[0], l[0]


def buffer_attention_batched_ref(qh, buf_k, buf_v, buf_len):
    """Flash stats over the full-precision TBQ buffer of every slot.

    qh [R, H, GQ, D]; buf_k/buf_v [R, G, H, D]; buf_len [R].
    """
    d = qh.shape[-1]
    g = buf_k.shape[1]
    valid = (torch.arange(g, device=qh.device)[None, :]
             < buf_len[:, None])[:, None, None, :]
    s = torch.einsum("rhgd,rnhd->rhgn", qh.float(),
                     buf_k.float()) / math.sqrt(d)
    p, m, l = _masked_softmax_stats(s, valid)
    return torch.einsum("rhgn,rnhd->rhgd", p, buf_v.float()), m, l


def merge_flash_ref(out_a, m_a, l_a, out_b, m_b, l_b):
    """Merge two flash partitions; out [..., D], m/l [..., 1]."""
    m = torch.maximum(m_a, m_b)
    ca, cb = torch.exp(m_a - m), torch.exp(m_b - m)
    l = (l_a * ca + l_b * cb).clamp_min(1e-30)
    return out_a * (l_a * ca / l) + out_b * (l_b * cb / l)


def ct_paged_attention_fused_ref(qh, k_codes, v_codes, k_scales, v_scales,
                                 slot_state, slot_bits, block_table,
                                 buf_k, buf_v, buf_len, *, group: int = 16):
    """A whole decode tick's attention: per layer, the paged pool merged
    with the fp TBQ buffer.

    qh [L, R, H, GQ, D]; planes [L, NP, BS, H, ...]; slot_state/slot_bits
    [L, R, NB, BS]; block_table [R, L, NB] raw; buf_k/buf_v
    [L, R, G, H, D]; buf_len [R].  Returns [L, R, H, GQ, D] f32.
    """
    outs = []
    for l in range(qh.shape[0]):
        out_p, m_p, l_p = ct_paged_attention_batched_ref(
            qh[l], k_codes[l], v_codes[l], k_scales[l], v_scales[l],
            slot_state[l], slot_bits[l], block_table[:, l], group=group)
        out_b, m_b, l_b = buffer_attention_batched_ref(qh[l], buf_k[l],
                                                       buf_v[l], buf_len)
        outs.append(merge_flash_ref(out_p, m_p, l_p, out_b, m_b, l_b))
    return torch.stack(outs)


def ct_paged_attention_fused_warps_ref(qh, k_codes, v_codes, k_scales,
                                       v_scales, slot_state, slot_bits,
                                       block_table, buf_k, buf_v, buf_len, *,
                                       warps: int = 4, group: int = 16):
    """K1's walk in plain torch, the CUDA kernel's decomposition of
    :func:`ct_paged_attention_fused_ref`: per (layer, slot), the items of
    the walk are the live logical blocks (those holding a VALID slot, in
    table order) and then the fp TBQ buffer; warp w of ``warps`` takes items
    w, w + warps, ...; each warp's unnormalised partial (out, m, l) over its
    items (an empty one ``(0, -1e30, 0)``) is merged with the others.  Same
    signature and result as the fused version."""
    out = torch.empty(qh.shape, dtype=torch.float32, device=qh.device)
    for li in range(qh.shape[0]):
        for i in range(qh.shape[1]):
            q = qh[li, i:i + 1]
            live = _live_blocks(slot_state[li, i])
            parts = []
            for w in range(warps):
                mine = live[w::warps]
                acc, m, l = _pool_partial(
                    q, k_codes[li], v_codes[li], k_scales[li], v_scales[li],
                    slot_state[li, i:i + 1], slot_bits[li, i:i + 1],
                    block_table[i:i + 1, li], mine, group)
                if (live.numel() - w) % warps == 0:     # the buffer item
                    ob, mb, lb = buffer_attention_batched_ref(
                        q, buf_k[li, i:i + 1], buf_v[li, i:i + 1],
                        buf_len[i:i + 1])
                    o, m, l = _merge_partials([(acc, m, l),
                                               (ob * lb, mb, lb)])
                    acc = o * l
                parts.append((acc, m, l))
            out[li, i] = _merge_partials(parts)[0][0]
    return out


def group_quant_ref(x: torch.Tensor, bits: int, group: int = 16):
    """x [N, D] -> (codes uint8 [N, D], scales bf16 [N, D // group])."""
    codes, scales = Q.quantize_group(x, bits, group)
    return codes, scales.to(torch.bfloat16)


def group_quant_commit_ref(buf_k: torch.Tensor, buf_v: torch.Tensor,
                           bits: torch.Tensor, levels):
    """One commit's quantization as the reference selects it
    (``_quantize_group_by_thought``): K and V [..., D] quantized at every
    precision level in ``levels``, the first level's result replaced by
    the level equal to ``bits`` (a 0-d tensor).  Returns (k codes, k scales
    bf16, v codes, v scales)."""
    def quant(x, b):
        codes, scales = group_quant_ref(x.float().reshape(-1, x.shape[-1]),
                                        b)
        return codes.reshape(x.shape), scales.reshape(*x.shape[:-1], -1)

    out = None
    for b in levels:
        q = (*quant(buf_k, b), *quant(buf_v, b))
        if out is None:
            out = q
            continue
        sel = bits == b
        out = tuple(torch.where(sel, new, old) for new, old in zip(q, out))
    return out


def flash_prefill_stats_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            kv_valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Causal GQA attention with per-query flash stats.

    q [S, Hq, D], k/v [T, H, D]; ``kv_valid`` [T] bool masks padded keys.
    Returns (out [S, Hq, D] f32, m [S, Hq, 1], l [S, Hq, 1]); all three in
    f64 when q, k and v are f64.
    """
    s_len, hq, d = q.shape
    t_len, h, _ = k.shape
    gq = hq // h
    qh = _wide(q.reshape(s_len, h, gq, d))
    scores = torch.einsum("shgd,thd->hgst", qh, _wide(k)) / math.sqrt(d)
    i = torch.arange(s_len, device=q.device)[:, None]
    j = torch.arange(t_len, device=q.device)[None, :]
    mask = torch.ones((s_len, t_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i + (t_len - s_len)
    if window > 0:
        mask &= j > i + (t_len - s_len) - window
    if kv_valid is not None:
        mask &= kv_valid[None, :]
    p, m, l = _masked_softmax_stats(scores, mask[None, None])
    out = torch.einsum("hgst,thd->shgd", p, _wide(v))

    def to_q(a):                                  # [h, g, s, 1] -> [s, hq, 1]
        return a[..., 0].permute(2, 0, 1).reshape(s_len, hq, 1)
    return out.reshape(s_len, hq, d), to_q(m), to_q(l)


def flash_prefill_ref(q, k, v, *, causal: bool = True, window: int = 0):
    return flash_prefill_stats_ref(q, k, v, causal=causal, window=window)[0]


def mamba_scan_ref(x, dt, b, c, a) -> torch.Tensor:
    """Mamba-1 selective scan, sequential over time from ``h_0 = 0``:
    ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``, ``y_t = h_t . C_t``.

    x, dt [..., S, di]; b, c [..., S, N]; a [di, N] (negative).  Leading
    batch axes are optional (the reference's is unbatched).  Returns
    y [..., S, di] f32.
    """
    x, dt, b, c, a = (t.float() for t in (x, dt, b, c, a))
    h = x.new_zeros(x.shape[:-2] + a.shape)
    ys = []
    for t in range(x.shape[-2]):
        dt_t = dt[..., t, :, None]
        h = torch.exp(dt_t * a) * h + (dt_t * x[..., t, :, None]) * \
            b[..., t, None, :]
        ys.append((h * c[..., t, None, :]).sum(-1))
    return torch.stack(ys, dim=-2)


def mamba_scan_lanes_ref(x, dt, b, c, a, *, lanes: int = 2,
                         state: int = 16) -> torch.Tensor:
    """K5's arithmetic order in plain torch, the CUDA kernel's decomposition
    of :func:`mamba_scan_ref`: the N state lanes of a channel are padded
    to ``state`` (A, B and C zero past N) and split over ``lanes`` threads
    of ``state // lanes`` lanes each; a thread sums its lanes' h_t[n] C_t[n]
    in order, and the threads' partials are summed by a butterfly (pairs
    of neighbours first).  Same signature and result as the plain scan."""
    x, dt, b, c, a = (t.float() for t in (x, dt, b, c, a))
    pad = state - a.shape[-1]
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, pad))
    c = torch.nn.functional.pad(c, (0, pad))
    per = state // lanes
    h = x.new_zeros(x.shape[:-2] + a.shape)
    ys = []
    for t in range(x.shape[-2]):
        dt_t = dt[..., t, :, None]
        h = torch.exp(dt_t * a) * h + (dt_t * x[..., t, :, None]) * \
            b[..., t, None, :]
        hc = (h * c[..., t, None, :]).unflatten(-1, (lanes, per))
        part = hc[..., 0]
        for k in range(1, per):
            part = part + hc[..., k]
        step = 1                       # the xor butterfly over the lanes
        while step < lanes:
            part = part + part.unflatten(-1, (-1, 2, step)).flip(-2) \
                .flatten(-3)
            step *= 2
        ys.append(part[..., 0])
    return torch.stack(ys, dim=-2)
