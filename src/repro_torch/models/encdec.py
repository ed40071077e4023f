"""Whisper-style encoder-decoder (ports ``repro/models/encdec.py``: ``init``,
``encode``, ``decode_train``, ``logits_fn``, ``hidden_fn``, ``loss_fn``,
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
reference's is per request.  ``remat`` checkpoints each decoder layer of
the training forward (the encoder is not, as in the reference).

``encode``, ``decode_hidden``, ``hidden_fn`` and ``loss_fn`` also take a
rank's blocks of the weights (``lm.Weights``) under the sharded train
step's compute split: each layer's blocks gathered over the dp axes in
the layer (in the decoder's remat'd body, so again when it is
recomputed), the encoder's non-causal and the decoder's causal
self-attention, the cross attention (its keys and values projected from
the replicated encoder states, marked ``to_model`` in each layer) and
the GELU MLP split over ``model`` (``attn_forward_split``,
``mlp_split``); the LayerNorms replicated; the embedding and the tied
head vocab-parallel where the vocabulary divides |model| (whisper-
medium's 51,865 does not: its embedding stays whole over ``model``).

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
from repro_torch.layers.common import dense_init_, embed_init_, remat
from repro_torch.layers.mlp import mlp, mlp_split
from repro_torch.layers.norms import layernorm
from repro_torch.models.lm import Weights, gather_layer
from repro_torch.models.losses import batch_nll

MAX_DEC_POS = 4096          # the reference's ``init(max_dec_pos=4096)``
_ATTN = ("wq", "wk", "wv", "wo")
_NORM = ("scale", "bias")
# each stack's attention blocks and LayerNorms
_STACKS = {"encoder": (("attn",), ("norm1", "norm2")),
           "decoder": (("self_attn", "cross_attn"), ("norm1", "norm2",
                                                     "norm3"))}


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
    """Encoder and decoder weights (registered without gradients; a trainer
    turns them on)."""

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
        for stack, L in (("encoder", cfg.encoder_layers),
                         ("decoder", cfg.num_layers)):
            attns, norms = _STACKS[stack]
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


def _names(cfg: ModelConfig, stack: str) -> Dict[str, Tuple[str, str]]:
    """A layer of ``stack``'s parameter names -> (group, key) of the
    reference's layer tree."""
    attns, norms = _STACKS[stack]
    return {name: path[1:] for name, (_, path) in
            _stack_params(cfg, stack, attns, norms).items()}


def _layer_tree(lpb: dict, mesh, dims: dict, names: dict) -> dict:
    """One layer's blocks gathered over the dp axes (inside the remat'd
    body, so the recompute gathers again), as the reference's nested
    dict."""
    out: dict = {}
    for name, b in gather_layer(lpb, mesh, dims).items():
        group, key = names[name]
        out.setdefault(group, {})[key] = b
    return out


def _norm(w: Weights, name: str) -> dict:
    return {k: w.whole(f"{name}_{k}") for k in _NORM}


def _encoder_layer(lpb: dict, h: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, mesh, dims: dict) -> torch.Tensor:
    lp = _layer_tree(lpb, mesh, dims, _names(cfg, "encoder"))
    h = h + A.attn_forward_split(lp["attn"], layernorm(lp["norm1"], h), cfg,
                                 positions, mesh, causal=False)
    return h + mlp_split(lp["mlp"], layernorm(lp["norm2"], h), cfg, mesh)


def _encode(w: Weights, frames: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    set_f32_numerics()
    t = frames.shape[1]
    h = frames + w.whole("enc_pos")[None, :t].to(frames.dtype)
    positions = torch.arange(t, device=frames.device)[None]
    layers, dims = w.layers(_names(cfg, "encoder"))
    for i in range(cfg.encoder_layers):
        h = _encoder_layer(layers[i], h, positions, cfg, w.mesh, dims)
    return layernorm(_norm(w, "enc_norm"), h)


def encode(params: Union[EncDecLM, Weights], frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames [B, T_enc, D] (stub embeddings) -> encoder states [B, T_enc,
    D]: non-causal self-attention layers."""
    return _encode(Weights.of(params), frames, cfg)


def _decoder_layer(lpb: dict, h: torch.Tensor, enc: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig, mesh,
                   dims: dict) -> torch.Tensor:
    lp = _layer_tree(lpb, mesh, dims, _names(cfg, "decoder"))
    h = h + A.attn_forward_split(lp["self_attn"], layernorm(lp["norm1"], h),
                                 cfg, positions, mesh)
    h = h + A.attn_forward_split(lp["cross_attn"],
                                 layernorm(lp["norm2"], h), cfg, positions,
                                 mesh, kv=enc)
    return h + mlp_split(lp["mlp"], layernorm(lp["norm3"], h), cfg, mesh)


def _decode(w: Weights, emb: torch.Tensor, tokens: torch.Tensor,
            enc: torch.Tensor, cfg: ModelConfig, remat_layers: bool
            ) -> torch.Tensor:
    set_f32_numerics()
    s = tokens.shape[1]
    h = E.embed_split(emb, tokens, cfg, w.mesh)
    h = h + w.whole("dec_pos")[None, :s].to(h.dtype)
    positions = torch.arange(s, device=tokens.device)[None]
    layers, dims = w.layers(_names(cfg, "decoder"))
    for i in range(cfg.num_layers):
        h = remat(_decoder_layer, layers[i], h, enc, positions, cfg, w.mesh,
                  dims, enabled=remat_layers)
    return layernorm(_norm(w, "final_norm"), h)


def decode_hidden(params: Union[EncDecLM, Weights], tokens: torch.Tensor,
                  enc: torch.Tensor, cfg: ModelConfig, *,
                  remat_layers: bool = False) -> torch.Tensor:
    """The teacher-forced decoder's final-norm hidden states [B, S, D];
    ``remat_layers`` recomputes each layer in backward."""
    w = Weights.of(params)
    return _decode(w, w.whole("embedding"), tokens, enc, cfg, remat_layers)


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


def hidden_fn(params: Union[EncDecLM, Weights],
              batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
              remat_layers: bool = False) -> torch.Tensor:
    """The decoder's final-norm hidden states [B, S, D]."""
    return decode_hidden(params, batch["tokens"],
                         encode(params, batch["frames"], cfg), cfg,
                         remat_layers=remat_layers)


def loss_fn(params: Union[EncDecLM, Weights],
            batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            remat: bool = False):
    """(the chunked NLL, {"nll", "moe_aux": 0}) of the decoder's
    ``tokens`` against ``targets`` (``loss_mask`` optional) over the
    encoding of ``frames``; the head is the embedding's transpose.  From a
    rank's blocks under the compute split, the same, replicated over
    ``model``, for this rank's block of the batch (the embedding and the
    head vocab-parallel where the vocabulary splits)."""
    w = Weights.of(params)
    emb = w.whole("embedding")
    h = _decode(w, emb, batch["tokens"], _encode(w, batch["frames"], cfg),
                cfg, remat)
    loss = batch_nll(h, emb.T, batch, vocab=cfg.vocab_size, mesh=w.mesh)
    return loss, {"nll": loss, "moe_aux": loss.new_zeros(())}


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
