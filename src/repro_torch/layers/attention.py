"""GQA attention projections (ports ``repro/layers/attention.py``:
``_project_qkv``, ``qkv_decode``, ``out_proj`` and the small-sequence
``_dense_attention`` used by the dense forward).  Keys are cached post-RoPE.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig, PositionEmbedding
from repro_torch.layers.rope import apply_rope, rope_freqs

NEG_INF = -1e30


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x [..., D] -> q [..., Hq, hd], k/v [..., Hkv, hd] (pre-RoPE)."""
    hd = cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    lead = x.shape[:-1]
    return (q.reshape(*lead, cfg.num_heads, hd),
            k.reshape(*lead, cfg.num_kv_heads, hd),
            v.reshape(*lead, cfg.num_kv_heads, hd))


def rope_qk(q, k, positions, cfg: ModelConfig):
    """RoPE on q/k [..., T, heads, hd] at ``positions`` [..., T]."""
    if cfg.position_embedding != PositionEmbedding.ROPE:
        return q, k
    cos, sin = rope_freqs(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def qkv_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
               position: torch.Tensor):
    """One token per row: x [R, D] at positions [R] ->
    (q [R, Hq, hd], k [R, Hkv, hd], v [R, Hkv, hd]), RoPE applied."""
    q, k, v = _project_qkv(p, x, cfg)
    q, k = rope_qk(q, k, position, cfg)
    return q, k, v


def out_proj(p: dict, attn: torch.Tensor) -> torch.Tensor:
    """attn [..., Hq, hd] -> [..., D]."""
    return attn.reshape(*attn.shape[:-2], -1) @ p["wo"]


def dense_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, S, Hq, hd] x k/v [B, T, Hkv, hd] -> [B, S, Hq, hd]; GQA
    broadcast, materialized [S, T] scores (short sequences)."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qh = q.reshape(b, s, hkv, hq // hkv, hd).float()
    scores = torch.einsum("bshgd,bthd->bhgst", qh, k.float()) / math.sqrt(hd)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i + (t - s)
    if window > 0:
        mask &= j > i + (t - s) - window
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(b, s, hq, hd).to(q.dtype)
