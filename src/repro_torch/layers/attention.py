"""GQA attention (ports ``repro/layers/attention.py``: ``_project_qkv``,
``qkv_decode``, ``out_proj``, ``_full_attention`` with its small-sequence
dense path and its q-chunked exact path above 2048 query rows,
``attn_forward`` (causal, non-causal for an encoder, or over external
keys and values for cross attention), ``attn_prefill_with_cache``,
``cross_kv`` and ``decode_attend_fullkv``).  Keys are cached post-RoPE;
with learned positions (whisper) ``rope_qk`` leaves q and k as they
are.

``attn_forward`` takes the reference's ring branch (context parallelism,
``distributed/ring_attention.py``) exactly where the reference does: a
mesh installed by ``sharding.set_constraint_mesh`` with a ``model`` axis
that divides S, causal attention without a window, and the query heads
not divisible by |model| or d_model/|model| < 128.

``attn_forward_split`` is the sharded train step's attention (causal,
an encoder's, or cross attention) over this rank's blocks of the weights
split over ``model``
(``distributed/sharding.py``, the compute split): where the kv heads
divide |model| (GQA groups stay whole) ``wq`` / ``wk`` / ``wv`` are
column products over this rank's heads, ``wo`` a row product, and the
ranks' outputs are summed over ``model``; otherwise the projected q, k
and v are gathered over ``model``, every rank attends over all heads, and
``wo``'s row product over this rank's block of the output is summed as
before.  No weight is gathered over ``model`` either way.

Not ported: the reference's ``REPRO_BF16_SCORES`` toggle (a measurement
switch for bf16 score tiles on XLA's CPU backend) and its
``REPRO_NO_RING`` switch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig, PositionEmbedding
from repro_torch.distributed import sharding as SH
from repro_torch.layers.common import wide
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
    qh = wide(q.reshape(b, s, hkv, hq // hkv, hd))
    scores = torch.einsum("bshgd,bthd->bhgst", qh, wide(k)) / math.sqrt(hd)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i + (t - s)
    if window > 0:
        mask &= j > i + (t - s) - window
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, wide(v))
    return out.reshape(b, s, hq, hd).to(q.dtype)


# query rows above which the full-sequence path is chunked over queries
_CHUNK_THRESHOLD = 2048
_Q_CHUNK = 512


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_chunk: int = _Q_CHUNK):
    """Exact attention over q chunks (the reference's
    ``_chunked_attention``): scores are [B, H, GQ, q_chunk, T] per chunk,
    never [S, T] per head.  Normalised after the value product, as the
    reference does.  q [B, S, Hq, hd], k/v [B, T, Hkv, hd]."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qc = q_chunk
    while s % qc:
        qc //= 2
    kf, vf = wide(k), wide(v)
    j = torch.arange(t, device=q.device)[None, :]
    outs = []
    for c0 in range(0, s, qc):
        qh = wide(q[:, c0:c0 + qc].reshape(b, qc, hkv, hq // hkv, hd))
        scores = torch.einsum("bshgd,bthd->bhgst", qh, kf) / math.sqrt(hd)
        i = c0 + torch.arange(qc, device=q.device)[:, None] + (t - s)
        mask = torch.ones((qc, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= j <= i
        if window > 0:
            mask &= j > i - window
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.exp(scores - scores.amax(-1, keepdim=True))
        denom = probs.sum(-1)                             # [b, h, g, s]
        out = torch.einsum("bhgst,bthd->bshgd", probs, vf)
        out = out / denom.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append(out.reshape(b, qc, hq, hd).to(q.dtype))
    return torch.cat(outs, 1)


def full_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """The reference's ``_full_attention``: the chunked path above
    ``_CHUNK_THRESHOLD`` query rows, the dense one below."""
    if q.shape[1] > _CHUNK_THRESHOLD:
        return chunked_attention(q, k, v, causal=causal, window=window)
    return dense_attention(q, k, v, causal=causal, window=window)


def attn_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, *, causal: bool = True,
                 kv_override=None) -> torch.Tensor:
    """Full-sequence attention over x [B, S, D] -> [B, S, D]: causal, or
    not (an encoder); ``kv_override`` (k, v) [B, T, Hkv, hd] supplies
    external keys and values (cross attention, already encoder-side) and
    makes the attention non-causal, as the reference's does."""
    q, k, v = _project_qkv(p, x, cfg)
    q, k = rope_qk(q, k, positions, cfg)
    if kv_override is not None:
        k, v = kv_override
        causal = False
    if causal and cfg.sliding_window == 0 and ring_selected(cfg, q.shape[1]):
        from repro_torch.distributed.ring_attention import ring_attention
        return out_proj(p, ring_attention(q, k, v, SH.constraint_mesh()))
    out = full_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return out_proj(p, out)


def attn_forward_split(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       positions: torch.Tensor, mesh, *, causal: bool = True,
                       kv=None) -> torch.Tensor:
    """``attn_forward`` of the replicated x [B, S, D] from this rank's
    blocks of the weights (``wq`` / ``wk`` / ``wv`` [D, cols], ``wo``
    [rows, D], whole along D; a block narrower than its weight is split
    over ``model``), returning the replicated [B, S, D] (see the module
    docstring): causal or not (an encoder), or, with ``kv`` the replicated
    encoder states [B, T, D], cross attention (keys and values projected
    from ``kv`` without bias, as ``cross_kv``; non-causal).  Whole weights
    run ``attn_forward``."""
    split = {w: p[w].shape[-1] < n for w, n in (
        ("wq", cfg.q_dim), ("wk", cfg.kv_dim), ("wv", cfg.kv_dim))}
    split_o = p["wo"].shape[0] < cfg.q_dim
    if not any(split.values()) and not split_o:
        return attn_forward(p, x, cfg, positions, causal=causal,
                            kv_override=None if kv is None
                            else cross_kv(p, kv, cfg))
    tp = SH.model_size(mesh)
    # this rank's heads (q heads [r·Hq/tp, ...) and their kv heads), or,
    # where GQA groups would break, every head from gathered projections
    heads = cfg.num_kv_heads % tp == 0 and all(split.values()) and split_o
    src = {"wq": x, "wk": x if kv is None else kv,
           "wv": x if kv is None else kv}
    marked: dict = {}                   # to_model of each input, once

    def proj(w: str, bias: str) -> torch.Tensor:
        inp = src[w]
        if split[w]:
            if id(inp) not in marked:
                marked[id(inp)] = SH.to_model(inp, mesh)
            inp = marked[id(inp)]
        y = inp @ p[w]
        if split[w] and not heads:
            y = SH.gather_model(y, mesh, -1)
        if cfg.qkv_bias and (kv is None or w == "wq"):
            y = y + (SH.split_model(p[bias], mesh, -1) if heads else p[bias])
        return y

    n = tp if heads else 1
    lead, kv_lead = x.shape[:-1], src["wk"].shape[:-1]
    q = proj("wq", "bq").reshape(*lead, cfg.num_heads // n, cfg.head_dim)
    k = proj("wk", "bk").reshape(*kv_lead, cfg.num_kv_heads // n,
                                 cfg.head_dim)
    v = proj("wv", "bv").reshape(*kv_lead, cfg.num_kv_heads // n,
                                 cfg.head_dim)
    if kv is None:
        q, k = rope_qk(q, k, positions, cfg)
    else:                               # cross keys carry no rotation
        q = rope_qk(q, q, positions, cfg)[0]
    out = full_attention(q, k, v, causal=causal and kv is None,
                         window=cfg.sliding_window)
    out = out.reshape(*lead, -1)
    if not split_o:
        return out @ p["wo"]
    if not heads:
        out = SH.split_model(out, mesh, -1)
    return SH.from_model(out @ p["wo"], mesh)


def ring_selected(cfg: ModelConfig, seq: int) -> bool:
    """Does causal, unwindowed attention over ``seq`` rows take the ring
    branch?  Only under an installed constraint mesh with a ``model`` axis
    dividing ``seq``, where head sharding breaks down: the query heads do
    not divide |model|, or d_model/|model| < 128."""
    mesh = SH.constraint_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return False
    tp = SH.axes_size(mesh, "model")
    return seq % tp == 0 and (cfg.num_heads % tp != 0
                              or cfg.d_model // tp < 128)


def attn_prefill_with_cache(p: dict, x: torch.Tensor, cfg: ModelConfig,
                            positions: torch.Tensor):
    """Causal attention over x [B, S, D]: (y [B, S, D], k, v [B, S, Hkv,
    hd] post-RoPE), the FullKV prefill's cache rows."""
    q, k, v = _project_qkv(p, x, cfg)
    q, k = rope_qk(q, k, positions, cfg)
    out = full_attention(q, k, v, causal=True, window=cfg.sliding_window)
    return out_proj(p, out), k, v


def cross_kv(p: dict, enc: torch.Tensor, cfg: ModelConfig):
    """Encoder-side keys and values for cross attention: enc [..., T, D]
    -> k, v [..., T, Hkv, hd] (no bias, no rotation)."""
    hd = cfg.head_dim
    k = (enc @ p["wk"]).reshape(*enc.shape[:-1], cfg.num_kv_heads, hd)
    v = (enc @ p["wv"]).reshape(*enc.shape[:-1], cfg.num_kv_heads, hd)
    return k, v


def decode_attend_fullkv(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                         window: int = 0) -> torch.Tensor:
    """One token per request over an explicit cache (the FullKV baseline),
    batched over requests where the reference ``vmap``s: q [B, Hq, hd];
    k_cache/v_cache [B, T, Hkv, hd] post-RoPE; cache_len [B] valid rows.
    Scores and values in f32; returns [B, Hq, hd] in q's dtype."""
    b, t, hkv, hd = k_cache.shape
    hq = q.shape[1]
    qh = q.reshape(b, hkv, hq // hkv, hd).float()
    s = torch.einsum("bhgd,bthd->bhgt", qh, k_cache.float()) / math.sqrt(hd)
    pos = torch.arange(t, device=q.device)[None]
    clen = cache_len.to(torch.int64)[:, None]
    valid = pos < clen
    if window > 0:
        valid &= pos > clen - 1 - window
    valid = valid[:, None, None]
    pr = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    pr = torch.where(valid, pr, 0.0)
    out = torch.einsum("bhgt,bthd->bhgd", pr, v_cache.float())
    return out.reshape(b, hq, hd).to(q.dtype)
