"""Decoder-only transformer LM, dense, mixture-of-experts or the VLM
backbone (ports ``repro/models/lm.py``: the parameter shapes of ``init``,
``assemble_inputs`` / ``backbone`` and the teacher-forced forward, and the
FullKV serving paths ``prefill`` and ``decode_step_fullkv``).

The VLM family (paligemma) ties the output head to the embedding (no
``lm_head``; embeddings scaled by sqrt(d_model), ``layers/embedding.py``)
and has a stub frontend, ``frontend_proj`` ``[frontend_dim, d_model]``:
``assemble_inputs`` prepends the projected patch embeddings of
``batch["patches"]`` ``[B, num_image_tokens, frontend_dim]`` to the
embedded text and numbers the positions over the whole sequence.

Weights stay in the reference's layout so that converting a JAX parameter
tree is a copy: ``x @ W`` with W of shape ``[in, out]``, and every layer
weight stacked on a leading ``[L]`` axis (a MoE layer's experts on a
second, ``[L, E, ...]``).  :meth:`LM.layer` returns one layer's parameters
as the nested dict the layer functions take.

The MoE FFN routes the tokens of one call together (``layers/moe.py``),
so which tokens share a routing group follows the reference path by path:
the B·S tokens of a prefill or a teacher-forced forward flattened, each
request's token alone in ``decode_step_fullkv`` (the reference ``vmap``s
one request), and what the serving engine passes (``ffn``'s
``tokens_alone``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.config import ArchFamily, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers import moe as MOE
from repro_torch.layers.common import dense_init_, embed_init_, softcap
from repro_torch.layers.mlp import mlp
from repro_torch.layers.norms import rmsnorm

_FAMILIES = (ArchFamily.DENSE, ArchFamily.MOE, ArchFamily.VLM)


def layer_params(cfg: ModelConfig) -> Dict[str, Tuple[str, str]]:
    """Parameter name -> nested key path of the reference's layer tree:
    the attention projections (with ``bq`` / ``bk`` / ``bv`` under qkv
    bias), the norms, and the MLP's or the MoE's weights."""
    out = {"wq": ("attn", "wq"), "wk": ("attn", "wk"), "wv": ("attn", "wv"),
           "wo": ("attn", "wo"),
           "norm1": ("norm1", "scale"), "norm2": ("norm2", "scale")}
    if cfg.qkv_bias:
        out.update({b: ("attn", b) for b in ("bq", "bk", "bv")})
    ffn = ("router", "w_up", "w_gate", "w_down") if cfg.moe is not None \
        else ("w_up", "w_gate", "w_down")
    group = "moe" if cfg.moe is not None else "mlp"
    out.update({w: (group, w) for w in ffn})
    return out


class LM(nn.Module):
    """Decoder weights (no gradients: the port serves)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.family not in _FAMILIES or not cfg.mlp_gated or \
                (cfg.family == ArchFamily.MOE) != (cfg.moe is not None):
            raise ValueError(
                f"{cfg.name}: models/lm.py holds gated dense, MoE and VLM "
                f"decoders; build the {cfg.family.value} family through "
                f"models/factory.py")
        self.cfg = cfg
        self.layer_params = layer_params(cfg)
        L, d, ff, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
        shapes = {
            "embedding": (V, d), "final_norm": (d,),
            "wq": (L, d, cfg.q_dim), "wk": (L, d, cfg.kv_dim),
            "wv": (L, d, cfg.kv_dim), "wo": (L, cfg.q_dim, d),
            "norm1": (L, d), "norm2": (L, d),
        }
        if not cfg.tie_embeddings:
            shapes["lm_head"] = (d, V)
        if cfg.qkv_bias:
            shapes.update(bq=(L, cfg.q_dim), bk=(L, cfg.kv_dim),
                          bv=(L, cfg.kv_dim))
        if cfg.family == ArchFamily.VLM:
            shapes["frontend_proj"] = E.frontend_stub_shapes(cfg)["proj"]
        # init scale per weight: None is the fan-in default
        self._scales: Dict[str, Optional[float]] = {}
        if cfg.moe is not None:
            for name, (shape, scale) in MOE.moe_param_shapes(cfg).items():
                shapes[name] = (L, *shape)
                self._scales[name] = scale
        else:
            shapes.update(w_up=(L, d, ff), w_gate=(L, d, ff),
                          w_down=(L, ff, d))
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))
        if cfg.moe is not None:
            # the router stays f32 whatever the weights' dtype
            self.router.data = self.router.data.float()

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "LM":
        """Seeded init with the reference's shapes and scales: truncated
        normal fan-in for dense weights (the router at 0.02, experts at
        their own fan-in, the frontend projector), N(0, 0.02) embeddings,
        unit norms, zero qkv biases."""
        gen = torch.Generator(device=self.embedding.device).manual_seed(seed)
        embed_init_(self.embedding, gen)
        for name in ("lm_head", "wq", "wk", "wv", "wo", "router", "w_up",
                     "w_gate", "w_down", "frontend_proj"):
            if hasattr(self, name):
                dense_init_(getattr(self, name), gen,
                            self._scales.get(name))
        for name in ("norm1", "norm2", "final_norm"):
            getattr(self, name).fill_(1.0)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()
        return self

    @property
    def embed_params(self) -> dict:
        if self.cfg.tie_embeddings:
            return {"embedding": self.embedding}
        return {"embedding": self.embedding, "lm_head": self.lm_head}

    @property
    def frontend_params(self) -> dict:
        return {"proj": self.frontend_proj}

    def layer(self, i: int) -> dict:
        """Layer ``i``'s parameters as the reference's nested dict."""
        out: dict = {}
        for name, (group, key) in self.layer_params.items():
            out.setdefault(group, {})[key] = getattr(self, name)[i]
        return out

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        """Logits of final hidden states h [..., D] (softcapped)."""
        return softcap(E.unembed(self.embed_params, h, self.cfg),
                       self.cfg.logit_softcap)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits [B, S, V] of tokens [B, S] (the
        reference's ``logits_fn`` for the dense family)."""
        h, positions = assemble_inputs(self, {"tokens": tokens}, self.cfg)
        return self.unembed(backbone(self, h, self.cfg, positions)[0])


def assemble_inputs(params: LM, batch: dict, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedded tokens h [B, S, D] and positions [1, S]; for the VLM
    family with ``batch["patches"]`` [B, P, frontend_dim] the projected
    patches come first (h [B, P + S, D], positions over P + S)."""
    tokens = batch["tokens"]
    h = E.embed(params.embed_params, tokens, cfg)
    if cfg.family == ArchFamily.VLM and "patches" in batch:
        img = E.frontend_stub(params.frontend_params,
                              batch["patches"].to(h.dtype))
        h = torch.cat([img, h], 1)
    return h, torch.arange(h.shape[1], device=tokens.device)[None]


def ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig,
        tokens_alone: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN on x [..., D] and its MoE auxiliary loss (0 for the
    MLP): the MoE routes every token of x in one call (flattened in order;
    groups by the reference's group-size search) or, with
    ``tokens_alone``, each token as its own group of one."""
    if cfg.moe is None:
        return mlp(lp["mlp"], x, cfg.act, cfg.mlp_gated), x.new_zeros(())
    y, aux = MOE.moe_apply(lp["moe"], x.reshape(1, -1, x.shape[-1]), cfg,
                           group=1 if tokens_alone else None)
    return y.reshape(x.shape), aux


def mlp_residual(lp: dict, h: torch.Tensor, cfg: ModelConfig,
                 tokens_alone: bool = False) -> torch.Tensor:
    """h + the FFN of its second norm (``ffn``)."""
    return h + ffn(lp, rmsnorm(lp["norm2"], h, cfg.norm_eps), cfg,
                   tokens_alone)[0]


@torch.no_grad()
def backbone(params: LM, h: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder block over hidden states h [B, S, D], then the final
    norm; returns (h, the MoE auxiliary loss summed over layers: 0 for the
    dense family).  A MoE layer routes the B·S tokens together."""
    aux = torch.zeros((), device=h.device)
    for i in range(cfg.num_layers):
        lp = params.layer(i)
        x1 = rmsnorm(lp["norm1"], h, cfg.norm_eps)
        q, k, v = A._project_qkv(lp["attn"], x1, cfg)
        q, k = A.rope_qk(q, k, positions, cfg)
        o = A.full_attention(q, k, v, causal=True,
                             window=cfg.sliding_window)
        h = h + A.out_proj(lp["attn"], o)
        m, a = ffn(lp, rmsnorm(lp["norm2"], h, cfg.norm_eps), cfg)
        h, aux = h + m, aux + a
    return rmsnorm({"scale": params.final_norm}, h, cfg.norm_eps), aux


def logits_fn(params: LM, batch: dict, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits [B, S, V] of ``batch["tokens"]`` and the
    MoE auxiliary loss (0 for the dense family), the reference's
    ``logits_fn`` interface."""
    h, positions = assemble_inputs(params, batch, cfg)
    h, aux = backbone(params, h, cfg, positions)
    return params.unembed(h), aux


@torch.no_grad()
def prefill(params: LM, batch: dict, cfg: ModelConfig):
    """FullKV prefill: (last-token logits [B, V], k_cache, v_cache
    [L, B, S, Hkv, hd] post-RoPE) of ``batch["tokens"]`` [B, S]; a MoE
    layer routes the B·S tokens together."""
    h, positions = assemble_inputs(params, batch, cfg)
    kc, vc = [], []
    for i in range(cfg.num_layers):
        lp = params.layer(i)
        x1 = rmsnorm(lp["norm1"], h, cfg.norm_eps)
        a, k, v = A.attn_prefill_with_cache(lp["attn"], x1, cfg, positions)
        h = mlp_residual(lp, h + a, cfg)
        kc.append(k)
        vc.append(v)
    h = rmsnorm({"scale": params.final_norm}, h[:, -1], cfg.norm_eps)
    return params.unembed(h), torch.stack(kc), torch.stack(vc)


@torch.no_grad()
def decode_step_fullkv(params: LM, token: torch.Tensor, pos: torch.Tensor,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       cache_len: torch.Tensor, cfg: ModelConfig):
    """FullKV decode step, batched over requests where the reference
    ``vmap``s its single-request form: token, pos, cache_len [B];
    k_cache/v_cache [B, L, T, Hkv, hd].  The new row is written at
    ``cache_len`` (clamped to T - 1, as ``dynamic_update_index_in_dim``
    clamps) in the cache's dtype (the reference requires the two equal),
    then attended with ``cache_len + 1`` rows; a MoE layer routes each
    request's token alone.  Returns (logits [B, V], new k_cache, new
    v_cache)."""
    b = token.shape[0]
    rows = torch.arange(b, device=token.device)
    at = cache_len.long().clamp(0, k_cache.shape[2] - 1)
    h = E.embed(params.embed_params, token, cfg)
    kc, vc = k_cache.clone(), v_cache.clone()
    for i in range(cfg.num_layers):
        lp = params.layer(i)
        x1 = rmsnorm(lp["norm1"], h, cfg.norm_eps)
        q, k, v = A.qkv_decode(lp["attn"], x1, cfg, pos)
        kc[rows, i, at] = k.to(kc.dtype)
        vc[rows, i, at] = v.to(vc.dtype)
        o = A.decode_attend_fullkv(q, kc[:, i], vc[:, i], cache_len + 1,
                                   window=cfg.sliding_window)
        h = mlp_residual(lp, h + A.out_proj(lp["attn"], o), cfg,
                         tokens_alone=True)
    h = rmsnorm({"scale": params.final_norm}, h, cfg.norm_eps)
    return params.unembed(h), kc, vc


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.float32) -> LM:
    """Random weights from ``seed`` on ``device`` (the card by default)."""
    return LM(cfg, resolve_device(device), dtype).reset_parameters(seed)
