"""ThinKV controller for a single request (ports ``repro/core/thinkv.py``:
``decode_attention_ref``, ``layer_sparsity``, ``step_token``,
``compression_ratio``) -- the generation loop of the paper's Listing 1:

    for each generated token:
        q, k, v = project_qkv(h)
        cache, view = append_token(cache, view, k, v)  # TBQ buffer / commit
        h = attention(q, cache, view)                  # CT paged attention
        if step % tau == 0:
            cache = refresh(cache, view, sparsity)     # classify + TBE

The request's quantized planes are its own paged ``PoolView``
(``[L, NB, BS, H, ...]``, the identity block table).  The attention read
goes through ``kernels.ops.thinkv_decode_attention`` (the single-request
``ct_paged_attention`` wrapper over K2, merged with the fp buffer);
:func:`decode_attention_ref` here is its plain oracle.  As in the port's
cache, updates happen in place and ``lax.cond`` is a host branch (one read
of ``num_tokens`` per token).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.config import ThinKVConfig
from repro_torch.core import ct_cache as CC
from repro_torch.core.thoughts import row_sparsity

NEG_INF = -1e30


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [Hq, D] x k [N, H, D] -> scores [H, Hq // H, N]."""
    hq, d = q.shape
    h = k.shape[1]
    return torch.einsum("hgd,nhd->hgn", q.reshape(h, hq // h, d),
                        k) / math.sqrt(d)


def decode_attention_ref(dims: CC.CacheDims, cache: CC.CTCache,
                         view: CC.PoolView, q: torch.Tensor, layer: int,
                         return_probs: bool = False):
    """Plain decode attention of one layer over (paged cache ∪ buffer).

    q [Hq, D] (RoPE applied).  Returns out [Hq, D] (and, with
    ``return_probs``, probs [H, GQ, NS + G] and validity [NS + G])."""
    k_c, v_c, valid_c = CC.dequant_layer(dims, cache, view, layer)
    buf_valid = torch.arange(dims.G, device=q.device) < cache.buf_len
    k = torch.cat([k_c, cache.buf_k[layer].float()], 0)
    v = torch.cat([v_c, cache.buf_v[layer].float()], 0)
    valid = torch.cat([valid_c, buf_valid], 0)
    s = torch.where(valid, _gqa_scores(q.float(), k), NEG_INF)
    p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("hgn,nhd->hgd", p, v).reshape(q.shape)
    if return_probs:
        return out, p, valid
    return out


def layer_sparsity(dims: CC.CacheDims, cache: CC.CTCache, view: CC.PoolView,
                   q: torch.Tensor, layer: int) -> torch.Tensor:
    """Decode-step sparsity of one calibrated layer (paper App. C.2: GQA
    max-pool over the group, renormalize, measure)."""
    _, p, valid = decode_attention_ref(dims, cache, view, q, layer,
                                       return_probs=True)
    pooled = torch.where(valid, p.amax(dim=1), NEG_INF)
    renorm = torch.softmax(torch.log(pooled.clamp_min(1e-30)), dim=-1)
    return row_sparsity(renorm, valid.expand_as(renorm)).mean()


def step_token(cfg: ThinKVConfig, dims: CC.CacheDims, cache: CC.CTCache,
               view: CC.PoolView, k_t: torch.Tensor, v_t: torch.Tensor,
               sparsity: Optional[torch.Tensor] = None, policy=None
               ) -> Tuple[CC.CTCache, CC.PoolView]:
    """One generation step's cache updates: append k_t/v_t [L, H, D]
    (+ commit), and at tau boundaries the thought refresh with the supplied
    sparsity.  Updates in place; returns (cache, view)."""
    CC.append_token(cfg, dims, cache, view, k_t, v_t, policy=policy)
    if sparsity is not None and \
            int(cache.num_tokens) % cfg.refresh_interval == 0:
        CC.refresh(cfg, dims, cache, view, sparsity, policy=policy)
    return cache, view


def compression_ratio(cfg: ThinKVConfig, dims: CC.CacheDims,
                      cache: CC.CTCache, full_tokens: int) -> dict:
    """ThinKV footprint vs an uncompressed bf16 cache of ``full_tokens``."""
    stats = CC.memory_stats(dims, cache)
    full_bytes = full_tokens * 2 * 2 * dims.H * dims.D * dims.L
    phys = float(stats["physical_bytes"].sum())
    ratio = (phys + CC.metadata_bytes(dims) + CC.buffer_bytes(dims)) / \
        max(full_bytes, 1)
    return {**stats, "footprint_frac": ratio, "full_bytes": full_bytes}
