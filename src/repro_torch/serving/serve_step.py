"""Serving steps (ports ``repro/serving/serve_step.py``: its dense, MoE,
VLM, SSM, hybrid and encoder-decoder branches).

Each maker returns a function of ``(params, batch)`` with the reference's
batch keys and shapes (``repro/models/factory.py::input_specs``):

* ``make_prefill_step``: the full forward over the prompts ``tokens
  [B, S]``, last-token logits ``[B, V]`` (only the last row is
  unembedded).  For the VLM family ``patches [B, P, frontend_dim]`` in
  the batch are projected and prepended (``lm.assemble_inputs``: the
  forward runs over P + S rows); the encoder-decoder encodes ``frames
  [B, T_enc, D]`` first.  For the SSM family every layer's selective scan
  is one K5 launch for the whole batch (``kernels.ops.mamba_scan``);
* ``make_decode_step_fullkv``: ONE new token per request against an
  explicit cache.  Dense: ``tokens [B]``, ``positions [B]``,
  ``k_cache`` / ``v_cache [B, L, T, Hkv, hd]``, ``cache_len [B]`` ->
  ``(logits, k_cache, v_cache)``; the encoder-decoder also takes the
  static ``cross_k`` / ``cross_v [B, L, T_enc, Hkv, hd]``.  SSM:
  ``conv_state [B, L, W, di]`` and ``ssm_state [B, L, di, N]`` ->
  ``(logits, conv, h)``.  Hybrid: ``conv_state [B, L, W, di + 2 g N]``,
  ``ssm_state [B, L, nh, hp, N]`` and the shared block's caches ``[B,
  n_attn, T, Hkv, hd]`` -> ``(logits, conv, h, k_cache, v_cache)``;
* ``make_decode_step_thinkv``: one token per request against each
  request's CT pool in paged layout (``k_codes`` / ``v_codes`` uint8
  ``[B, n_attn, NB, BS, Hkv, hd]``, ``k_scales`` / ``v_scales`` bf16
  ``[B, n_attn, NB, BS, Hkv, hd / 16]``, ``slot_state`` / ``slot_bits``
  uint8 ``[B, n_attn, NS]``) and its bf16 TBQ buffer (``buf_k`` /
  ``buf_v [B, n_attn, G, Hkv, hd]``, ``buf_len [B]``), where ``n_attn =
  cfg.num_attention_layers()``: every layer but for the hybrid, whose
  pool holds one layer per shared-block invocation.  The new token's k/v
  are written into the buffer at ``buf_len``, the pool and the buffer are
  attended with ``buf_len + 1`` rows, and the step returns ``(logits,
  buf_k, buf_v, buf_len + 1)`` (the hybrid's ``(logits, conv, h, buf_k,
  buf_v, buf_len + 1)``); commit and refresh are separate steps.
  ``backend="reference"`` dequantizes the pool densely in the reference's
  numerics (bf16 dequantized operands, f32 accumulation, pool and buffer
  attended apart and merged by their flash stats); ``backend="kernel"``
  reads pool and buffer with ONE K1 launch per attention layer (per
  shared-block invocation for the hybrid) for the whole batch
  (``ops.paged_decode_attention_fused`` at L 1, R B).  The
  encoder-decoder's cross KV arrives TBQ'd at 4 bits (``cross_k_codes``
  / ``cross_v_codes`` uint8 ``[B, L, T_enc, Hkv, hd]``, ``cross_k_scales``
  / ``cross_v_scales`` bf16 ``[B, L, T_enc, Hkv, hd / 16]``, never
  evicted): it is dequantized to bf16 and attended over all T_enc rows in
  plain torch on both backends, as the reference computes it outside any
  kernel.  For the SSM family (attention-free) it is the FullKV step.

The MoE family takes the dense paths, with the reference's routing groups:
the prefill step routes the B·S prompt tokens together (``lm.backbone``),
the FullKV and ThinKV decode steps route each request's token alone (the
reference ``vmap``s one request), while K1 stays one launch per layer for
the batch.  The VLM family takes the dense paths too: its decode steps
are the dense ones, at the ``positions`` the batch gives (after an image
prefix, past its P rows).  Not ported: the reference's
``REPRO_F32_DEQUANT`` and ``REPRO_CONCAT_BUF`` toggles of the reference
backend, which measured a GSPMD rematerialisation of the pool under XLA
and have no PyTorch meaning.  The reference jits these steps; the port
runs them eagerly.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.config import ArchFamily, ModelConfig, ThinKVConfig
from repro_torch.core import quantization as Q
from repro_torch.kernels import ops as K
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers import ssm as S
from repro_torch.layers.norms import rmsnorm
from repro_torch.models import encdec, hybrid, lm, ssm_lm

NEG_INF = -1e30


def make_prefill_step(model, cfg: ModelConfig) -> Callable:
    """(params, batch) -> last-token logits [B, V]; ``batch["tokens"]``
    [B, S] (and for the VLM family optionally ``batch["patches"]``, for
    the encoder-decoder ``batch["frames"]``).  ``model`` is the factory's
    ``Model`` (unused, as in the reference)."""
    hidden = {ArchFamily.SSM: ssm_lm.hidden_fn,
              ArchFamily.HYBRID: hybrid.hidden_fn,
              ArchFamily.ENCDEC: encdec.hidden_fn}.get(cfg.family)
    if hidden is not None:
        @torch.no_grad()
        def step(params, batch):
            h = hidden(params, batch, cfg)
            return E.unembed(params.embed_params, h[:, -1], cfg)
        return step

    @torch.no_grad()
    def step(params, batch):
        h, positions = lm.assemble_inputs(params, batch, cfg)
        h, _ = lm.backbone(params, h, cfg, positions)
        return params.unembed(h[:, -1])
    return step


def make_decode_step_fullkv(cfg: ModelConfig) -> Callable:
    """(params, batch) -> (logits [B, V], k_cache, v_cache) for the dense,
    MoE, VLM and encoder-decoder families, (logits, conv_state, ssm_state)
    for the SSM family, (logits, conv_state, ssm_state, k_cache, v_cache)
    for the hybrid."""
    if cfg.family == ArchFamily.SSM:
        @torch.no_grad()
        def step(params, batch):
            lg, new = ssm_lm.decode_step(
                params, batch["tokens"],
                S.Mamba1State(batch["conv_state"], batch["ssm_state"]), cfg)
            return lg, new.conv, new.h
        return step
    if cfg.family == ArchFamily.HYBRID:
        @torch.no_grad()
        def step(params, batch):
            lg, new, kc, vc = hybrid.decode_step_fullkv(
                params, batch["tokens"], batch["positions"],
                S.Mamba2State(batch["conv_state"], batch["ssm_state"]),
                batch["k_cache"], batch["v_cache"], batch["cache_len"], cfg)
            return lg, new.conv, new.h, kc, vc
        return step
    if cfg.family == ArchFamily.ENCDEC:
        @torch.no_grad()
        def step(params, batch):
            return encdec.decode_step_fullkv(
                params, batch["tokens"], batch["positions"],
                batch["k_cache"], batch["v_cache"], batch["cache_len"],
                batch["cross_k"], batch["cross_v"], cfg)
        return step

    @torch.no_grad()
    def step(params, batch):
        return lm.decode_step_fullkv(
            params, batch["tokens"], batch["positions"], batch["k_cache"],
            batch["v_cache"], batch["cache_len"], cfg)
    return step


# ---------------------------------------------------------------------------
# ThinKV decode: the pool read of one layer, for every request
# ---------------------------------------------------------------------------

def _flash_part(q, k, v, valid):
    """Flash-stats attention over one partition, batched over requests:
    q [B, Hq, hd] and k/v [B, N, H, hd] hold bf16 values, valid [B, N].
    Products of bf16 values accumulate in f32 (the reference's
    ``preferred_element_type``); the normalised probabilities are rounded
    to bf16 before the value product, as the reference rounds them.
    Returns (out [B, H, GQ, hd], m, l [B, H, GQ, 1]) f32."""
    b, hq, hd = q.shape
    h = k.shape[2]
    qh = q.reshape(b, h, hq // h, hd).float()
    s = torch.einsum("bhgd,bnhd->bhgn", qh, k.float()) / math.sqrt(hd)
    mask = valid[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    p = (p / l.clamp_min(1e-30)).to(torch.bfloat16).float()
    out = torch.einsum("bhgn,bnhd->bhgd", p, v.float())
    return out, m, l


def _merge_parts(a, b):
    (oa, ma, la), (ob, mb, lb) = a, b
    m = torch.maximum(ma, mb)
    ca, cb = torch.exp(ma - m), torch.exp(mb - m)
    l = (la * ca + lb * cb).clamp_min(1e-30)
    out = oa * (la * ca / l) + ob * (lb * cb / l)
    return out.reshape(out.shape[0], -1, out.shape[-1])


def _pool_attention(q, batch, l: int, bk, bv, n_buf):
    """The reference backend's read of layer ``l``: every request's pool
    dequantized densely to bf16, attended apart from its buffer (bk/bv
    [B, G, H, hd] with ``n_buf`` [B] rows) and merged by the flash stats.
    q [B, Hq, hd] -> [B, Hq, hd] in q's dtype."""
    b = q.shape[0]

    def flat(name):
        a = batch[name][:, l]
        return a.reshape(b, -1, *a.shape[3:])
    bits = batch["slot_bits"][:, l].to(torch.int32)[..., None, None]
    kd, vd = (Q.dequantize_by_bitcode(flat(c), flat(s).float(), bits)
              .to(torch.bfloat16)
              for c, s in (("k_codes", "k_scales"), ("v_codes", "v_scales")))
    qb = q.to(torch.bfloat16)
    g = bk.shape[1]
    part_p = _flash_part(qb, kd, vd, batch["slot_state"][:, l] == 1)
    part_b = _flash_part(qb, bk.to(torch.bfloat16), bv.to(torch.bfloat16),
                         torch.arange(g, device=q.device)[None]
                         < n_buf[:, None])
    return _merge_parts(part_p, part_b).to(q.dtype)


def _pool_attention_kernel(q, batch, l: int, bk, bv, n_buf):
    """The kernel backend's read of layer ``l``: ONE K1 launch for every
    request (the reference ``vmap``s one launch per request).  The batch's
    code and scale planes, contiguous [B, L, NB, BS, ...], are one pool of
    B·L·NB blocks as they lie, and request r's table row maps its logical
    block j to (r·L + l)·NB + j, so no plane is copied; only the layer's
    slot planes (2·B·NS bytes) are made contiguous as K1's [1, B, NB, BS]
    metadata.  q [B, Hq, hd] -> [B, Hq, hd] in q's dtype."""
    kc, ks = batch["k_codes"], batch["k_scales"]
    b, n_layers, nb, bs, h, hd = kc.shape
    hq = q.shape[1]
    dev = q.device

    def pool(a):
        return a.reshape(1, b * n_layers * nb, bs, h, a.shape[-1])

    def meta(name):
        return batch[name][:, l].reshape(1, b, nb, bs).contiguous()
    table = ((torch.arange(b, device=dev)[:, None] * n_layers + l) * nb
             + torch.arange(nb, device=dev)[None]).to(torch.int32)
    out = K.paged_decode_attention_fused(
        q.reshape(1, b, h, hq // h, hd).float().contiguous(),
        pool(kc), pool(batch["v_codes"]), pool(ks), pool(batch["v_scales"]),
        meta("slot_state"), meta("slot_bits"), table[:, None],
        bk[None], bv[None], n_buf.to(torch.int32), group=Q.GROUP)
    return out.reshape(b, hq, hd).to(q.dtype)


_POOL_READS = {"reference": _pool_attention,
               "kernel": _pool_attention_kernel}


def _cross_attention(batch, t_enc: torch.Tensor):
    """The encoder-decoder's cross attention of layer ``i`` over its TBQ'd
    cross KV: codes and scales dequantized at 4 bits to bf16, every T_enc
    row attended (plain torch on both backends, as in the reference)."""
    def attend(i, qc):
        kv = [Q.dequantize_group(batch[f"cross_{n}_codes"][:, i],
                                 batch[f"cross_{n}_scales"][:, i].float(), 4)
              .to(torch.bfloat16) for n in ("k", "v")]
        return A.decode_attend_fullkv(qc, *kv, t_enc)
    return attend


def make_decode_step_thinkv(cfg: ModelConfig, tk: ThinKVConfig, *,
                            backend: str = "reference") -> Callable:
    """(params, batch) -> (logits [B, V], buf_k, buf_v, buf_len + 1) for the
    dense, MoE, VLM and encoder-decoder families, (logits, conv_state,
    ssm_state, buf_k, buf_v, buf_len + 1) for the hybrid (batch keys in
    the module docstring; a MoE layer routes each request's token alone);
    the FullKV step for the attention-free SSM family."""
    if backend not in _POOL_READS:
        raise ValueError(f"unknown backend {backend!r}")
    if cfg.family == ArchFamily.SSM:
        return make_decode_step_fullkv(cfg)
    pool_read = _POOL_READS[backend]

    @torch.no_grad()
    def step(params, batch):
        batch = {k: v.contiguous() for k, v in batch.items()}
        token, pos, buf_len = batch["tokens"], batch["positions"], \
            batch["buf_len"]
        buf_k, buf_v = batch["buf_k"].clone(), batch["buf_v"].clone()
        b, g = buf_k.shape[0], buf_k.shape[2]
        rows = torch.arange(b, device=token.device)
        # dynamic_update_index_in_dim clamps the row into the buffer
        at = buf_len.long().clamp(0, g - 1)
        n_buf = buf_len + 1

        def attend(i, p_attn, x1):
            """Attention layer ``i`` of the pool: the new row into the
            buffer, then the pool and the buffer read together."""
            q, k, v = A.qkv_decode(p_attn, x1, cfg, pos)
            buf_k[rows, i, at] = k.to(buf_k.dtype)
            buf_v[rows, i, at] = v.to(buf_v.dtype)
            return pool_read(q, batch, i, buf_k[:, i].contiguous(),
                             buf_v[:, i].contiguous(), n_buf)

        if cfg.family == ArchFamily.HYBRID:
            attn = params.shared["attn"]
            h, st = hybrid.decode_layers(
                params, E.embed(params.embed_params, token, cfg),
                S.Mamba2State(batch["conv_state"], batch["ssm_state"]), cfg,
                lambda a, x1: attend(a, attn, x1))
            return params.unembed(h), st.conv, st.h, buf_k, buf_v, n_buf
        if cfg.family == ArchFamily.ENCDEC:
            t_enc = torch.full((b,), batch["cross_k_codes"].shape[2],
                               dtype=torch.int32, device=token.device)
            h = encdec.decode_layers(
                params, token, pos, cfg,
                lambda i, lp, x1: attend(i, lp["self_attn"], x1),
                _cross_attention(batch, t_enc))
            return params.unembed(h), buf_k, buf_v, n_buf
        h = E.embed(params.embed_params, token, cfg)
        for i in range(cfg.num_layers):
            lp = params.layer(i)
            o = attend(i, lp["attn"], rmsnorm(lp["norm1"], h, cfg.norm_eps))
            h = lm.mlp_residual(lp, h + A.out_proj(lp["attn"], o), cfg,
                                tokens_alone=True)
        h = rmsnorm({"scale": params.final_norm}, h, cfg.norm_eps)
        return params.unembed(h), buf_k, buf_v, n_buf
    return step
