"""Decoder-only transformer LM, dense, mixture-of-experts or the VLM
backbone (ports ``repro/models/lm.py``: the parameter shapes of ``init``,
``assemble_inputs`` / ``backbone`` and the teacher-forced forward,
``loss_fn``, and the FullKV serving paths ``prefill`` and
``decode_step_fullkv``).

The parameters are registered without gradients (the port serves); a
trainer turns them on (``requires_grad_``), and the shared forward
(``backbone``, ``LM.forward``, ``loss_fn``) then records for autograd.
The serving entry points (the engine, ``serving/serve_step.py``, the
FullKV paths here) run under ``torch.no_grad``.  ``remat`` checkpoints
each layer body, as the reference's ``jax.checkpoint`` of its scan body.

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

:func:`loss_fn` (with :func:`assemble_inputs` and :func:`backbone`) also
runs the sharded train step's compute split (``distributed/sharding.py``)
from a rank's blocks of the parameters (:class:`Weights`): each layer's
blocks gathered over the dp axes just before it runs (and again when
remat recomputes it), the embedding vocab-parallel, attention, MLP and
experts split over ``model`` (``layers/``), the head and the cross
entropy vocab-parallel (``models/losses.py``).  The layer functions take
the split from the blocks' shapes, so whole weights run the plain
forward.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.config import ArchFamily, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers import moe as MOE
from repro_torch.layers.common import dense_init_, embed_init_, remat, \
    softcap
from repro_torch.layers.mlp import mlp_split
from repro_torch.layers.norms import rmsnorm
from repro_torch.models.losses import batch_nll

FAMILIES = (ArchFamily.DENSE, ArchFamily.MOE, ArchFamily.VLM)


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
    """Decoder weights (registered without gradients; a trainer turns them
    on)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.family not in FAMILIES or not cfg.mlp_gated or \
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

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits [B, S, V] of tokens [B, S] (the
        reference's ``logits_fn`` for the dense family)."""
        h, positions = assemble_inputs(self, {"tokens": tokens}, self.cfg)
        return self.unembed(backbone(self, h, self.cfg, positions)[0])


class Weights:
    """A model's weights as the families' forwards read them, by
    parameter name (:func:`assemble_inputs`, :func:`backbone` and
    :func:`loss_fn` here; ``ssm_lm``, ``hybrid`` and ``encdec`` alike): a
    model's own parameters (``mesh`` None, :meth:`of`), or a rank's
    blocks under ``param_specs(mode="train")`` on a train mesh, each
    gathered over the dp axes where it is read (still split over
    ``model``; the layer functions split their compute by the blocks'
    shapes)."""

    def __init__(self, blocks: Dict[str, torch.Tensor],
                 specs: Optional[dict] = None, mesh=None):
        self.blocks, self.specs, self.mesh = blocks, specs, mesh

    @classmethod
    def of(cls, params: Union[nn.Module, "Weights"]) -> "Weights":
        return params if isinstance(params, Weights) else \
            cls(dict(params.named_parameters()))

    def dp_dim(self, name: str, stacked: bool = False) -> Optional[int]:
        """The dim of ``name``'s block (of one layer's slice when
        ``stacked``) split over the dp axes, or None."""
        if self.mesh is None:
            return None
        return SH.dp_dim(self.specs[name], self.mesh, stacked)

    def whole(self, name: str) -> torch.Tensor:
        """``name``'s weight, gathered over the dp axes."""
        return SH.gather_dp(self.blocks[name], self.mesh, self.dp_dim(name))

    def layers(self, names) -> Tuple[list, Dict[str, Optional[int]]]:
        """(each layer's blocks of the stacked weights ``names`` by name,
        the dp dim of one layer's block of each): one unbind per weight,
        whose gradient is one stack rather than a full-size zero tensor
        per layer."""
        parts = {n: self.blocks[n].unbind(0) for n in names}
        count = len(next(iter(parts.values())))
        return [{n: parts[n][i] for n in names} for i in range(count)], \
            {n: self.dp_dim(n, stacked=True) for n in names}


def head_nll(w: Weights, emb: torch.Tensor, h: torch.Tensor, batch: dict,
             cfg: ModelConfig, softcap: float = 0.0) -> torch.Tensor:
    """``batch_nll`` of the final hidden states h under a decoder's head:
    the embedding table ``emb``'s transpose when tied (this rank's
    columns of it under the split), else ``lm_head``; vocab-parallel where
    the head is split over ``model``."""
    head = emb.T if cfg.tie_embeddings else w.whole("lm_head")
    return batch_nll(h, head, batch, softcap, vocab=cfg.vocab_size,
                     mesh=w.mesh)


def gather_layer(lpb: Dict[str, torch.Tensor], mesh,
                 dims: Dict[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """One layer's blocks (by name), each split over the dp axes along
    ``dims[name]`` gathered (inside the remat'd body, so the recompute
    gathers again)."""
    return {n: SH.gather_dp(b, mesh, dims[n]) for n, b in lpb.items()}


def assemble_inputs(params: Union[LM, Weights], batch: dict,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedded tokens h [B, S, D] and positions [1, S]; for the VLM
    family with ``batch["patches"]`` [B, P, frontend_dim] the projected
    patches come first (h [B, P + S, D], positions over P + S)."""
    w = Weights.of(params)
    return _inputs(w, w.whole("embedding"), batch, cfg)


def _inputs(w: Weights, emb: torch.Tensor, batch: dict, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``assemble_inputs`` from the embedding table ``emb`` (this rank's
    rows of it under the split: ``embed_split``)."""
    h = E.embed_split(emb, batch["tokens"], cfg, w.mesh)
    if cfg.family == ArchFamily.VLM and "patches" in batch:
        img = E.frontend_stub({"proj": w.whole("frontend_proj")},
                              batch["patches"].to(h.dtype))
        h = torch.cat([img, h], 1)
    return h, torch.arange(h.shape[1], device=h.device)[None]


def ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig,
        tokens_alone: bool = False, split=None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN on x [..., D] and its MoE auxiliary loss (0 for the
    MLP): the MoE routes every token of x in one call (flattened in order;
    groups by the reference's group-size search) or, with
    ``tokens_alone``, each token as its own group of one.  ``split`` (a
    train mesh) runs it from this rank's blocks of the weights."""
    if cfg.moe is None:
        return mlp_split(lp["mlp"], x, cfg, split), x.new_zeros(())
    y, aux = MOE.moe_apply(lp["moe"], x.reshape(1, -1, x.shape[-1]), cfg,
                           group=1 if tokens_alone else None, split=split)
    return y.reshape(x.shape), aux


def mlp_residual(lp: dict, h: torch.Tensor, cfg: ModelConfig,
                 tokens_alone: bool = False) -> torch.Tensor:
    """h + the FFN of its second norm (``ffn``)."""
    return h + ffn(lp, rmsnorm(lp["norm2"], h, cfg.norm_eps), cfg,
                   tokens_alone)[0]


def _block(lpb: dict, h: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig, mesh, dims: dict
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block over h [B, S, D] from one layer's weights ``lpb``
    (by parameter name; a block split over the dp axes along
    ``dims[name]`` is gathered here, inside the remat'd body): (h, its
    MoE auxiliary loss)."""
    lp: dict = {}
    whole = gather_layer(lpb, mesh, dims)
    for name, (group, key) in layer_params(cfg).items():
        lp.setdefault(group, {})[key] = whole[name]
    h = h + A.attn_forward_split(lp["attn"],
                                 rmsnorm(lp["norm1"], h, cfg.norm_eps),
                                 cfg, positions, mesh)
    m, a = ffn(lp, rmsnorm(lp["norm2"], h, cfg.norm_eps), cfg, split=mesh)
    return h + m, a


def backbone(params: Union[LM, Weights], h: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, *, remat_layers: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder block over hidden states h [B, S, D], then the final
    norm; returns (h, the MoE auxiliary loss summed over layers: 0 for the
    dense family).  A MoE layer routes the B·S tokens together.
    ``remat_layers`` recomputes each block in backward
    (:meth:`Weights.layers` splits the stacked weights into layers)."""
    w = Weights.of(params)
    layers, dims = w.layers(layer_params(cfg))
    aux = torch.zeros((), device=h.device)
    for i in range(cfg.num_layers):
        h, a = remat(_block, layers[i], h, positions, cfg, w.mesh, dims,
                     enabled=remat_layers)
        aux = aux + a
    return rmsnorm({"scale": w.whole("final_norm")}, h, cfg.norm_eps), aux


def logits_fn(params: LM, batch: dict, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits [B, S, V] of ``batch["tokens"]`` and the
    MoE auxiliary loss (0 for the dense family), the reference's
    ``logits_fn`` interface."""
    h, positions = assemble_inputs(params, batch, cfg)
    h, aux = backbone(params, h, cfg, positions)
    return params.unembed(h), aux


def loss_fn(params: Union[LM, Weights], batch: dict, cfg: ModelConfig, *,
            remat: bool = False) -> Tuple[torch.Tensor, dict]:
    """(total loss, {"nll", "moe_aux"}) of a teacher-forced batch
    (``tokens``, ``targets`` [B, S], optional ``loss_mask`` [B, S] and,
    for the VLM family, ``patches``): the chunked NLL over the text
    positions (image positions carry no loss) plus the MoE auxiliary loss
    weighted by ``aux_loss_weight / num_layers``.  From a rank's
    :class:`Weights` under the compute split it is the same total and
    metrics, replicated over ``model``, for this rank's block of the
    batch."""
    w = Weights.of(params)
    emb = w.whole("embedding")
    h, positions = _inputs(w, emb, batch, cfg)
    h, aux = backbone(w, h, cfg, positions, remat_layers=remat)
    if cfg.family == ArchFamily.VLM and "patches" in batch:
        h = h[:, -batch["targets"].shape[1]:]
    loss = head_nll(w, emb, h, batch, cfg, cfg.logit_softcap)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    total = loss + aux_w * aux / max(cfg.num_layers, 1)
    return total, {"nll": loss, "moe_aux": aux}


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
