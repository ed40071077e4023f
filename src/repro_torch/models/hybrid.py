"""zamba2: a Mamba-2 backbone and ONE shared attention block (ports
``repro/models/hybrid.py``: ``_groups``, ``init``, ``_mamba_scan``,
``_shared_block``, ``logits_fn``, ``hidden_fn``, ``init_decode_state``,
``decode_step_fullkv``).

The shared block (attention + MLP, a single weight copy) runs after every
``hybrid_attn_every`` backbone layers: zamba2-7b's 81 layers are 13 groups
of 6 Mamba-2 layers, each followed by the shared block, then a tail of 3
Mamba-2 layers with no attention.  Only the shared block's invocations own
KV caches (``cfg.num_attention_layers()``, 13), and ThinKV manages exactly
those (``serving/serve_step.py``).  Python loops replace the reference's
``lax.scan`` over groups and layers; the decode functions are batched over
a leading B axis where the reference's are per request, ``vmap``ped by
``serve_step``.  Left out: the ``constrain`` sharding hint (no meaning on
one card), ``remat`` (training), and ``loss_fn`` (training, ROADMAP queue
1 item 16).

Weights keep the reference's layout: every backbone layer's weight stacked
on a leading ``[L]`` axis, the shared block's unstacked, ``x @ W`` with W
``[in, out]``; :data:`HybridLM.sources` maps each to its key path in the
reference's tree.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.config import ArchFamily, ModelConfig
from repro_torch.device import resolve_device, set_f32_numerics
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers import ssm as S
from repro_torch.layers.common import dense_init_, embed_init_
from repro_torch.layers.mlp import mlp
from repro_torch.layers.norms import rmsnorm

# the shared block's weights: name -> (group, key) of the reference's tree
# (``w_gate`` when the MLP is gated, the biases under qkv bias)
_SHARED = {**{w: ("attn", w) for w in ("wq", "wk", "wv", "wo", "bq", "bk",
                                       "bv")},
           **{w: ("mlp", w) for w in ("w_up", "w_gate", "w_down")}}


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups of ``hybrid_attn_every`` layers, tail layers)."""
    e = max(cfg.hybrid_attn_every, 1)
    return cfg.num_layers // e, cfg.num_layers % e


class HybridLM(nn.Module):
    """Mamba-2 backbone and shared-block weights (no gradients: the port
    serves)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.family != ArchFamily.HYBRID:
            raise ValueError(f"{cfg.name} is not a hybrid config")
        self.cfg = cfg
        L, d, ff, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
        shapes = {"embedding": (V, d), "final_norm": (d,), "norm": (L, d),
                  "wq": (d, cfg.q_dim), "wk": (d, cfg.kv_dim),
                  "wv": (d, cfg.kv_dim), "wo": (cfg.q_dim, d),
                  "norm1": (d,), "norm2": (d,), "w_up": (d, ff),
                  "w_down": (ff, d)}
        src = {"embedding": ("embed", "embedding"),
               "final_norm": ("final_norm", "scale"),
               "norm": ("layers", "norm", "scale"),
               "norm1": ("shared", "norm1", "scale"),
               "norm2": ("shared", "norm2", "scale")}
        if not cfg.tie_embeddings:
            shapes["lm_head"] = (d, V)
            src["lm_head"] = ("embed", "lm_head")
        if cfg.mlp_gated:
            shapes["w_gate"] = (d, ff)
        if cfg.qkv_bias:
            shapes.update(bq=(cfg.q_dim,), bk=(cfg.kv_dim,),
                          bv=(cfg.kv_dim,))
        for name in shapes:
            if name in _SHARED:
                src[name] = ("shared",) + _SHARED[name]
        # the mixer's gated norm is "mixer_norm" beside the layer's "norm"
        for k, s in S.mamba2_shapes(cfg).items():
            name = "mixer_norm" if k == "norm" else k
            shapes[name] = (L, *s)
            src[name] = ("layers", "mixer", k) + (("scale",) if k == "norm"
                                                  else ())
        self.sources: Dict[str, Tuple[str, ...]] = src
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "HybridLM":
        """Seeded init with the reference's distributions: N(0, 0.02)
        embeddings, truncated-normal fan-in projections, unit norms, zero
        qkv biases, the mixer's ``mamba2_params``."""
        gen = torch.Generator(device=self.embedding.device).manual_seed(seed)
        embed_init_(self.embedding, gen)
        for name in ("lm_head", "wq", "wk", "wv", "wo", "w_up", "w_gate",
                     "w_down"):
            if hasattr(self, name):
                dense_init_(getattr(self, name), gen)
        for name in ("norm", "norm1", "norm2", "final_norm"):
            getattr(self, name).fill_(1.0)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()
        S.mamba2_params_(self.mixer(slice(None)), gen, self.cfg)
        return self

    @property
    def embed_params(self) -> dict:
        if self.cfg.tie_embeddings:
            return {"embedding": self.embedding}
        return {"embedding": self.embedding, "lm_head": self.lm_head}

    def mixer(self, i) -> dict:
        """Layer ``i``'s Mamba-2 parameters (``norm`` the gated norm's
        scale)."""
        return {k: getattr(self, "mixer_norm" if k == "norm" else k)[i]
                for k in S.MAMBA2_PARAMS}

    @property
    def shared(self) -> dict:
        """The shared block's parameters as the reference's nested dict."""
        out: dict = {"norm1": {"scale": self.norm1},
                     "norm2": {"scale": self.norm2}}
        for name, (group, key) in _SHARED.items():
            if hasattr(self, name):
                out.setdefault(group, {})[key] = getattr(self, name)
        return out

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        return E.unembed(self.embed_params, h, self.cfg)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.float32) -> HybridLM:
    """Random weights from ``seed`` on ``device`` (the card by default)."""
    return HybridLM(cfg, resolve_device(device), dtype).reset_parameters(seed)


def _mamba_scan(params: HybridLM, h: torch.Tensor, cfg: ModelConfig,
                layers: range) -> torch.Tensor:
    """Backbone layers ``layers`` over h [B, S, D], pre-norm residual."""
    for i in layers:
        h = h + S.mamba2_forward(params.mixer(i),
                                 rmsnorm({"scale": params.norm[i]}, h,
                                         cfg.norm_eps), cfg)
    return h


def _shared_block(sp: dict, h: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """The shared block over h [B, S, D]: causal attention, then the MLP."""
    h = h + A.attn_forward(sp["attn"], rmsnorm(sp["norm1"], h, cfg.norm_eps),
                           cfg, positions, causal=True)
    return h + mlp(sp["mlp"], rmsnorm(sp["norm2"], h, cfg.norm_eps),
                   cfg.act, cfg.mlp_gated)


@torch.no_grad()
def hidden_fn(params: HybridLM, batch: Dict[str, torch.Tensor],
              cfg: ModelConfig) -> torch.Tensor:
    """Final-norm hidden states [B, S, D] of ``batch["tokens"]`` [B, S]."""
    set_f32_numerics()
    h = E.embed(params.embed_params, batch["tokens"], cfg)
    positions = torch.arange(h.shape[1], device=h.device)[None]
    ng, tail = _groups(cfg)
    e = cfg.hybrid_attn_every
    sp = params.shared
    for gi in range(ng):
        h = _mamba_scan(params, h, cfg, range(gi * e, (gi + 1) * e))
        h = _shared_block(sp, h, cfg, positions)
    h = _mamba_scan(params, h, cfg, range(ng * e, ng * e + tail))
    return rmsnorm({"scale": params.final_norm}, h, cfg.norm_eps)


def logits_fn(params: HybridLM, batch: Dict[str, torch.Tensor],
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits [B, S, V] and the auxiliary loss (0)."""
    h = hidden_fn(params, batch, cfg)
    return params.unembed(h), h.new_zeros(())


def init_decode_state(cfg: ModelConfig, batch: int = 1,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> S.Mamba2State:
    """Zero (conv [B, L, W, di + 2 g N], h [B, L, nh, hp, N]) states."""
    return S.mamba2_init_state(cfg, (batch, cfg.num_layers),
                               resolve_device(device))


def decode_layers(params: HybridLM, h: torch.Tensor, state: S.Mamba2State,
                  cfg: ModelConfig, attend) -> Tuple[torch.Tensor,
                                                     S.Mamba2State]:
    """One token per request through every layer: h [B, D], state
    (conv [B, L, ...], h [B, L, ...]); after each group's Mamba-2 layers
    ``attend(a, x1)`` gives invocation ``a``'s attention output [B, Hq,
    hd] for the normed hidden x1 [B, D] (the caller writes its cache).
    Returns (the final-norm hidden [B, D], the new state)."""
    ng, tail = _groups(cfg)
    e = cfg.hybrid_attn_every
    sp = params.shared
    convs, hs = [], []

    def mamba(i, h):
        y, st = S.mamba2_decode_step(
            params.mixer(i), rmsnorm({"scale": params.norm[i]}, h,
                                     cfg.norm_eps),
            S.Mamba2State(state.conv[:, i], state.h[:, i]), cfg)
        convs.append(st.conv)
        hs.append(st.h)
        return h + y

    for a in range(ng):
        for i in range(a * e, (a + 1) * e):
            h = mamba(i, h)
        o = attend(a, rmsnorm(sp["norm1"], h, cfg.norm_eps))
        h = h + A.out_proj(sp["attn"], o)
        h = h + mlp(sp["mlp"], rmsnorm(sp["norm2"], h, cfg.norm_eps),
                    cfg.act, cfg.mlp_gated)
    for i in range(ng * e, ng * e + tail):
        h = mamba(i, h)
    h = rmsnorm({"scale": params.final_norm}, h, cfg.norm_eps)
    return h, S.Mamba2State(torch.stack(convs, 1), torch.stack(hs, 1))


@torch.no_grad()
def decode_step_fullkv(params: HybridLM, token: torch.Tensor,
                       pos: torch.Tensor, state: S.Mamba2State,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       cache_len: torch.Tensor, cfg: ModelConfig):
    """FullKV decode, batched over requests: token, pos, cache_len [B];
    k_cache/v_cache [B, n_attn, T, Hkv, hd] for the shared block's
    invocations, the new row written at ``cache_len`` (clamped to T - 1)
    and attended with ``cache_len + 1`` rows.  Returns (logits [B, V], new
    state, new k_cache, new v_cache)."""
    set_f32_numerics()
    b = token.shape[0]
    rows = torch.arange(b, device=token.device)
    at = cache_len.long().clamp(0, k_cache.shape[2] - 1)
    kc, vc = k_cache.clone(), v_cache.clone()
    sp = params.shared

    def attend(a, x1):
        q, k, v = A.qkv_decode(sp["attn"], x1, cfg, pos)
        kc[rows, a, at] = k.to(kc.dtype)
        vc[rows, a, at] = v.to(vc.dtype)
        return A.decode_attend_fullkv(q, kc[:, a], vc[:, a], cache_len + 1)

    h, st = decode_layers(params, E.embed(params.embed_params, token, cfg),
                          state, cfg, attend)
    return params.unembed(h), st, kc, vc
