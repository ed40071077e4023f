"""falcon-mamba: attention-free Mamba-1 LM (ports ``repro/models/ssm_lm.py``:
``init``, ``logits_fn``, ``hidden_fn``, ``loss_fn``, ``init_decode_state``,
``decode_step``).

Weights keep the reference's stacked ``[L, ...]`` layout, so converting a
JAX parameter tree is a copy.  There is no KV cache: decode state is the
conv window and the SSM state of every layer, O(1) in sequence length, so
ThinKV does not apply.  The decode functions are batched over a leading B
axis (the reference's are per request, ``vmap``ped by ``serve_step``).
The training loss scans with the model's own differentiable recurrence
(``backend="reference"``: ``kernels/ref.py::mamba_scan_ref``, the
reference's chunked ``lax.scan``): K5 has no backward.  ``remat``
checkpoints each layer body, as the reference's ``jax.checkpoint``.
``hidden_fn`` and ``loss_fn`` also take a rank's blocks of the weights
(``lm.Weights``) under the sharded train step's compute split: each
layer's blocks gathered over the dp axes inside the remat'd body, the
mixer split over ``model`` along d_inner
(``layers/ssm.py::mamba1_forward_split``), the embedding and the tied
head vocab-parallel.  Left out: ``hidden_fn``'s ``constrain`` hint,
GSPMD's layout guidance, which has no PyTorch meaning
(``sharding.constrain``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.config import ArchFamily, ModelConfig
from repro_torch.device import resolve_device, set_f32_numerics
from repro_torch.layers import embedding as E
from repro_torch.layers import ssm as S
from repro_torch.layers.common import embed_init_, remat
from repro_torch.layers.norms import rmsnorm
from repro_torch.models.lm import Weights, gather_layer, head_nll

# parameter name -> nested key path of the reference's per-layer tree
LAYER_PARAMS = {**{k: ("mixer", k) for k in S.MAMBA1_PARAMS},
                "norm": ("norm", "scale")}


class SSMLM(nn.Module):
    """Mamba-1 LM weights (registered without gradients; a trainer turns
    them on)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.family != ArchFamily.SSM:
            raise ValueError(f"{cfg.name} is not an SSM config")
        self.cfg = cfg
        L, d = cfg.num_layers, cfg.d_model
        shapes = {"embedding": (cfg.vocab_size, d), "final_norm": (d,),
                  "norm": (L, d),
                  **{k: (L, *s) for k, s in S.mamba1_shapes(cfg).items()}}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "SSMLM":
        """Seeded init with the reference's distributions: N(0, 0.02)
        embeddings, unit norms, the mixer's ``mamba1_params``."""
        gen = torch.Generator(device=self.embedding.device).manual_seed(seed)
        embed_init_(self.embedding, gen)
        self.norm.fill_(1.0)
        self.final_norm.fill_(1.0)
        S.mamba1_params_({k: getattr(self, k) for k in S.MAMBA1_PARAMS}, gen,
                         self.cfg)
        return self

    @property
    def embed_params(self) -> dict:
        return {"embedding": self.embedding}

    def layer(self, i: int) -> dict:
        """Layer ``i``'s parameters as the reference's nested dict."""
        out: dict = {}
        for name, (group, key) in LAYER_PARAMS.items():
            out.setdefault(group, {})[key] = getattr(self, name)[i]
        return out


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.float32) -> SSMLM:
    """Random weights from ``seed`` on ``device`` (the card by default)."""
    return SSMLM(cfg, resolve_device(device), dtype).reset_parameters(seed)


def _layer(lpb: dict, h: torch.Tensor, cfg: ModelConfig, backend: str,
           mesh, dims: dict) -> torch.Tensor:
    """One layer over h [B, S, D] from its weights ``lpb`` by parameter
    name (gathered over the dp axes here, inside the remat'd body): the
    plain forward, or under a train mesh the split one."""
    lp = gather_layer(lpb, mesh, dims)
    mixer = {k: lp[k] for k in S.MAMBA1_PARAMS}
    x = rmsnorm({"scale": lp["norm"]}, h, cfg.norm_eps)
    if mesh is None:
        return h + S.mamba1_forward(mixer, x, cfg, backend=backend)
    return h + S.mamba1_forward_split(mixer, x, cfg, mesh)


def _hidden(w: Weights, emb: torch.Tensor, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, backend: str, remat_layers: bool
            ) -> torch.Tensor:
    set_f32_numerics()
    h = E.embed_split(emb, batch["tokens"], cfg, w.mesh)
    layers, dims = w.layers(LAYER_PARAMS)
    for i in range(cfg.num_layers):
        h = remat(_layer, layers[i], h, cfg, backend, w.mesh, dims,
                  enabled=remat_layers)
    return rmsnorm({"scale": w.whole("final_norm")}, h, cfg.norm_eps)


def hidden_fn(params: Union[SSMLM, Weights], batch: Dict[str, torch.Tensor],
              cfg: ModelConfig, *, backend: str = "kernel",
              remat_layers: bool = False) -> torch.Tensor:
    """Final-norm hidden states [B, S, D] of ``batch["tokens"]`` [B, S];
    every layer's scan is one K5 launch (``backend="kernel"``) or the
    plain, differentiable ``mamba_scan_ref`` (``"reference"``, and always
    from a rank's blocks); ``remat_layers`` recomputes each layer in
    backward."""
    w = Weights.of(params)
    return _hidden(w, w.whole("embedding"), batch, cfg, backend,
                   remat_layers)


def logits_fn(params: SSMLM, batch: Dict[str, torch.Tensor],
              cfg: ModelConfig, *, backend: str = "kernel"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits [B, S, V] and the auxiliary loss (0)."""
    h = hidden_fn(params, batch, cfg, backend=backend)
    return E.unembed(params.embed_params, h, cfg), h.new_zeros(())


def loss_fn(params: Union[SSMLM, Weights], batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, *, remat: bool = False):
    """(the chunked NLL, {"nll", "moe_aux": 0}) of ``tokens`` against
    ``targets`` (``loss_mask`` optional), scanning with the plain,
    differentiable recurrence; from a rank's blocks under the compute
    split, the same, replicated over ``model``, for this rank's block of
    the batch (the head vocab-parallel where the embedding splits)."""
    w = Weights.of(params)
    emb = w.whole("embedding")
    h = _hidden(w, emb, batch, cfg, "reference", remat)
    loss = head_nll(w, emb, h, batch, cfg)
    return loss, {"nll": loss, "moe_aux": loss.new_zeros(())}


def init_decode_state(cfg: ModelConfig, batch: int = 1,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> S.Mamba1State:
    """Zero (conv [B, L, W, di], h [B, L, di, N]) states."""
    return S.mamba1_init_state(cfg, (batch, cfg.num_layers),
                               resolve_device(device))


@torch.no_grad()
def decode_step(params: SSMLM, tokens: torch.Tensor, state: S.Mamba1State,
                cfg: ModelConfig) -> Tuple[torch.Tensor, S.Mamba1State]:
    """O(1) decode: tokens [B] -> (logits [B, V], new state)."""
    set_f32_numerics()
    h = E.embed(params.embed_params, tokens, cfg)
    convs, hs = [], []
    for i in range(cfg.num_layers):
        lp = params.layer(i)
        y, st = S.mamba1_decode_step(
            lp["mixer"], rmsnorm(lp["norm"], h, cfg.norm_eps),
            S.Mamba1State(state.conv[:, i], state.h[:, i]), cfg)
        h = h + y
        convs.append(st.conv)
        hs.append(st.h)
    h = rmsnorm({"scale": params.final_norm}, h, cfg.norm_eps)
    return (E.unembed(params.embed_params, h, cfg),
            S.Mamba1State(torch.stack(convs, 1), torch.stack(hs, 1)))
