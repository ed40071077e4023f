"""Whisper-style encoder-decoder (ports ``repro/models/encdec.py``: ``init``,
``encode``, ``decode_train``, ``logits_fn``, ``hidden_fn``,
``cross_caches``, ``decode_step_fullkv``).

Whisper's conventions: pre-norm LayerNorm, learned positions (``enc_pos``
``[encoder_seq, D]``, ``dec_pos`` ``[4096, D]``), a plain GELU MLP,
multi-head attention, tied embeddings (scaled by sqrt(d_model), as the
reference scales every tied embedding).  The conv/mel frontend is a stub:
the encoder takes precomputed frame embeddings ``frames [B, T_enc, D]``.
The decoder's self-attention cache is what ThinKV manages; the cross
attention's keys and values are computed once from the encoder states
(``cross_caches``) and, on the ThinKV path, TBQ-quantized but never
evicted (``serving/serve_step.py``).  Python loops replace the reference's
``lax.scan``; the decode step is batched over a leading B axis where the
reference's is per request.  Left out: ``remat`` and ``loss_fn``
(training, ROADMAP queue 1 item 16).

Weights keep the reference's layout: each encoder and decoder weight
stacked on a leading ``[L]`` axis, ``x @ W`` with W ``[in, out]``;
:data:`EncDecLM.sources` maps each to its key path in the reference's tree.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.config import ArchFamily, ModelConfig
from repro_torch.device import resolve_device, set_f32_numerics
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers.common import dense_init_, embed_init_
from repro_torch.layers.mlp import mlp
from repro_torch.layers.norms import layernorm

MAX_DEC_POS = 4096          # the reference's ``init(max_dec_pos=4096)``
_ATTN = ("wq", "wk", "wv", "wo")
_NORM = ("scale", "bias")


def _stack_params(cfg: ModelConfig, stack: str, attns, norms):
    """{name: (shape without L, path in the reference's tree)} of one
    stack's layer: its attention blocks, LayerNorms and plain MLP."""
    d, ff = cfg.d_model, cfg.d_ff
    out = {}
    for a in attns:
        shapes = {"wq": (d, cfg.q_dim), "wk": (d, cfg.kv_dim),
                  "wv": (d, cfg.kv_dim), "wo": (cfg.q_dim, d)}
        if cfg.qkv_bias:
            shapes.update(bq=(cfg.q_dim,), bk=(cfg.kv_dim,),
                          bv=(cfg.kv_dim,))
        for w, s in shapes.items():
            out[f"{stack}_{a}_{w}"] = (s, (stack, a, w))
    for n in norms:
        for k in _NORM:
            out[f"{stack}_{n}_{k}"] = ((d,), (stack, n, k))
    out[f"{stack}_w_up"] = ((d, ff), (stack, "mlp", "w_up"))
    out[f"{stack}_w_down"] = ((ff, d), (stack, "mlp", "w_down"))
    return out


class EncDecLM(nn.Module):
    """Encoder and decoder weights (no gradients: the port serves)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.family != ArchFamily.ENCDEC:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab_size
        params = {"embedding": ((V, d), ("embed", "embedding")),
                  "enc_pos": ((cfg.encoder_seq, d), ("enc_pos",)),
                  "dec_pos": ((MAX_DEC_POS, d), ("dec_pos",))}
        if not cfg.tie_embeddings:
            params["lm_head"] = ((d, V), ("embed", "lm_head"))
        for n in ("enc_norm", "final_norm"):
            for k in _NORM:
                params[f"{n}_{k}"] = ((d,), (n, k))
        for stack, L, attns, norms in (
                ("encoder", cfg.encoder_layers, ("attn",),
                 ("norm1", "norm2")),
                ("decoder", cfg.num_layers, ("self_attn", "cross_attn"),
                 ("norm1", "norm2", "norm3"))):
            for name, (s, path) in _stack_params(cfg, stack, attns,
                                                 norms).items():
                params[name] = ((L, *s), path)
        self.sources: Dict[str, Tuple[str, ...]] = {
            n: path for n, (_, path) in params.items()}
        for name, (shape, _) in params.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "EncDecLM":
        """Seeded init with the reference's distributions: N(0, 0.02)
        embeddings, truncated-normal positions at std 0.02 and fan-in
        projections, LayerNorms at scale 1 and bias 0, zero qkv biases."""
        gen = torch.Generator(device=self.embedding.device).manual_seed(seed)
        embed_init_(self.embedding, gen)
        for name, p in self.named_parameters():
            if name in ("enc_pos", "dec_pos"):
                dense_init_(p, gen, scale=0.02)
            elif name.endswith("_scale"):
                p.fill_(1.0)
            elif name.endswith("_bias") or name[-3:] in ("_bq", "_bk",
                                                         "_bv"):
                p.zero_()
            elif name != "embedding":
                dense_init_(p, gen)
        return self

    @property
    def embed_params(self) -> dict:
        if self.cfg.tie_embeddings:
            return {"embedding": self.embedding}
        return {"embedding": self.embedding, "lm_head": self.lm_head}

    def norm(self, name: str) -> dict:
        return {k: getattr(self, f"{name}_{k}") for k in _NORM}

    def layer(self, stack: str, i: int) -> dict:
        """Layer ``i`` of ``stack`` ("encoder" or "decoder") as the
        reference's nested dict."""
        out: dict = {}
        for name, path in self.sources.items():
            if path[0] == stack:
                group, key = path[1:]
                out.setdefault(group, {})[key] = getattr(self, name)[i]
        return out

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        return E.unembed(self.embed_params, h, self.cfg)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.float32) -> EncDecLM:
    """Random weights from ``seed`` on ``device`` (the card by default)."""
    return EncDecLM(cfg, resolve_device(device), dtype).reset_parameters(seed)


@torch.no_grad()
def encode(params: EncDecLM, frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """frames [B, T_enc, D] (stub embeddings) -> encoder states [B, T_enc,
    D]: non-causal self-attention layers."""
    set_f32_numerics()
    t = frames.shape[1]
    h = frames + params.enc_pos[None, :t].to(frames.dtype)
    positions = torch.arange(t, device=frames.device)[None]
    for i in range(cfg.encoder_layers):
        lp = params.layer("encoder", i)
        h = h + A.attn_forward(lp["attn"], layernorm(lp["norm1"], h), cfg,
                               positions, causal=False)
        h = h + mlp(lp["mlp"], layernorm(lp["norm2"], h), "gelu", False)
    return layernorm(params.norm("enc_norm"), h)


@torch.no_grad()
def decode_hidden(params: EncDecLM, tokens: torch.Tensor, enc: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The teacher-forced decoder's final-norm hidden states [B, S, D]."""
    set_f32_numerics()
    s = tokens.shape[1]
    h = E.embed(params.embed_params, tokens, cfg)
    h = h + params.dec_pos[None, :s].to(h.dtype)
    positions = torch.arange(s, device=tokens.device)[None]
    for i in range(cfg.num_layers):
        lp = params.layer("decoder", i)
        h = h + A.attn_forward(lp["self_attn"], layernorm(lp["norm1"], h),
                               cfg, positions, causal=True)
        kv = A.cross_kv(lp["cross_attn"], enc, cfg)
        h = h + A.attn_forward(lp["cross_attn"], layernorm(lp["norm2"], h),
                               cfg, positions, kv_override=kv)
        h = h + mlp(lp["mlp"], layernorm(lp["norm3"], h), "gelu", False)
    return layernorm(params.norm("final_norm"), h)


def decode_train(params: EncDecLM, tokens: torch.Tensor, enc: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder -> logits [B, S, V]."""
    return params.unembed(decode_hidden(params, tokens, enc, cfg))


def logits_fn(params: EncDecLM, batch: Dict[str, torch.Tensor],
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits [B, S, V] of ``batch["tokens"]`` over the encoding of
    ``batch["frames"]``, and the auxiliary loss (0)."""
    enc = encode(params, batch["frames"], cfg)
    lg = decode_train(params, batch["tokens"], enc, cfg)
    return lg, lg.new_zeros(())


def hidden_fn(params: EncDecLM, batch: Dict[str, torch.Tensor],
              cfg: ModelConfig) -> torch.Tensor:
    """The decoder's final-norm hidden states [B, S, D]."""
    return decode_hidden(params, batch["tokens"],
                         encode(params, batch["frames"], cfg), cfg)


@torch.no_grad()
def cross_caches(params: EncDecLM, enc: torch.Tensor, cfg: ModelConfig):
    """Every decoder layer's cross-attention keys and values, computed
    once: (k, v) [L, B, T_enc, Hkv, hd]."""
    kv = [A.cross_kv(params.layer("decoder", i)["cross_attn"], enc, cfg)
          for i in range(cfg.num_layers)]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


def decode_layers(params: EncDecLM, token: torch.Tensor, pos: torch.Tensor,
                  cfg: ModelConfig, attend_self, attend_cross
                  ) -> torch.Tensor:
    """One token per request through the decoder: token, pos [B]; for
    layer ``i`` ``attend_self(i, lp, x1)`` and ``attend_cross(i, qc)`` give
    the self- and cross-attention outputs [B, Hq, hd] (the caller holds
    the caches).  Returns the final-norm hidden [B, D]."""
    set_f32_numerics()
    h = E.embed(params.embed_params, token, cfg)
    at = pos.long().clamp(0, params.dec_pos.shape[0] - 1)
    h = h + params.dec_pos[at].to(h.dtype)
    for i in range(cfg.num_layers):
        lp = params.layer("decoder", i)
        o = attend_self(i, lp, layernorm(lp["norm1"], h))
        h = h + A.out_proj(lp["self_attn"], o)
        qc, _, _ = A.qkv_decode(lp["cross_attn"], layernorm(lp["norm2"], h),
                                cfg, pos)
        h = h + A.out_proj(lp["cross_attn"], attend_cross(i, qc))
        h = h + mlp(lp["mlp"], layernorm(lp["norm3"], h), "gelu", False)
    return layernorm(params.norm("final_norm"), h)


@torch.no_grad()
def decode_step_fullkv(params: EncDecLM, token: torch.Tensor,
                       pos: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, cache_len: torch.Tensor,
                       cross_k: torch.Tensor, cross_v: torch.Tensor,
                       cfg: ModelConfig):
    """FullKV decode with static cross KV, batched over requests: token,
    pos, cache_len [B]; k_cache/v_cache [B, L, T, Hkv, hd] (the new row
    written at ``cache_len``, clamped to T - 1, and attended with
    ``cache_len + 1`` rows); cross_k/cross_v [B, L, T_enc, Hkv, hd], all
    T_enc rows attended.  Returns (logits [B, V], new k_cache, new
    v_cache)."""
    b = token.shape[0]
    rows = torch.arange(b, device=token.device)
    at = cache_len.long().clamp(0, k_cache.shape[2] - 1)
    kc, vc = k_cache.clone(), v_cache.clone()
    t_enc = torch.full((b,), cross_k.shape[2], dtype=torch.int32,
                       device=token.device)

    def attend_self(i, lp, x1):
        q, k, v = A.qkv_decode(lp["self_attn"], x1, cfg, pos)
        kc[rows, i, at] = k.to(kc.dtype)
        vc[rows, i, at] = v.to(vc.dtype)
        return A.decode_attend_fullkv(q, kc[:, i], vc[:, i], cache_len + 1)

    def attend_cross(i, qc):
        return A.decode_attend_fullkv(qc, cross_k[:, i], cross_v[:, i], t_enc)

    h = decode_layers(params, token, pos, cfg, attend_self, attend_cross)
    return params.unembed(h), kc, vc
