"""Carry the JAX package's weights, optimizer state and cache state into
the port.

Inputs are numpy arrays (``np.asarray`` of the JAX arrays), so this module
imports neither JAX nor the JAX package.  bf16 and float8 arrays cross as
uint16 / uint8 bit views and are viewed back as ``torch.bfloat16`` /
``torch.float8_e4m3fn`` (``torch.from_numpy`` does not take ml_dtypes).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.config import ArchFamily, ModelConfig
from repro_torch.core import ct_cache as CC
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, lm, ssm_lm
from repro_torch.training.optimizer import AdamWState

_BIT_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}

Device = Optional[Union[str, torch.device]]

_MODELS = {ArchFamily.DENSE: lm.LM, ArchFamily.MOE: lm.LM,
           ArchFamily.VLM: lm.LM, ArchFamily.SSM: ssm_lm.SSMLM,
           ArchFamily.HYBRID: hybrid.HybridLM,
           ArchFamily.ENCDEC: encdec.EncDecLM}


def tensor_from_numpy(a, device: Device = None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name in _BIT_VIEWS:
        npt, tt = _BIT_VIEWS[a.dtype.name]
        t = torch.from_numpy(np.array(a.view(npt), order="C")).view(tt)
    else:
        t = torch.from_numpy(np.array(a, order="C"))
    return t.to(resolve_device(device))


def param_paths(cfg: ModelConfig) -> Dict[str, Tuple[str, ...]]:
    """Each of the port model's parameters -> its key path in the
    reference's parameter tree: ``LM`` for the dense, MoE and VLM families
    (``attn``'s ``bq`` / ``bk`` / ``bv`` under qkv bias; ``moe``'s router
    and stacked experts or ``mlp``'s weights; ``lm_head`` unless the
    embedding is tied; the VLM's ``frontend.proj``), ``SSMLM`` (tied
    embedding, no lm_head; ``mixer`` and ``norm`` per layer) for the SSM
    family, ``HybridLM`` (``embed``, stacked ``layers.{mixer,norm}``,
    ``shared.{attn,mlp,norm1,norm2}``, ``final_norm``) and ``EncDecLM``
    (``embed``, ``enc_pos``, ``dec_pos``, stacked ``encoder`` and
    ``decoder``, ``enc_norm``, ``final_norm``)."""
    if cfg.family in (ArchFamily.HYBRID, ArchFamily.ENCDEC):
        return dict(_MODELS[cfg.family](cfg, torch.device("meta")).sources)
    src = {"embedding": ("embed", "embedding"),
           "final_norm": ("final_norm", "scale")}
    if cfg.family == ArchFamily.SSM:
        layer = ssm_lm.LAYER_PARAMS
    else:
        layer = lm.layer_params(cfg)
        if not cfg.tie_embeddings:
            src["lm_head"] = ("embed", "lm_head")
        if cfg.family == ArchFamily.VLM:
            src["frontend_proj"] = ("frontend", "proj")
    for name, (group, key) in layer.items():
        src[name] = ("layers", group, key)
    return src


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Each of the port model's parameters -> its shape (no memory)."""
    return {n: tuple(p.shape) for n, p in
            _MODELS[cfg.family](cfg, torch.device("meta")).named_parameters()}


def named_from_numpy(tree: Mapping, cfg: ModelConfig) -> Dict[str, Any]:
    """A tree shaped like the reference's parameters (the parameters, their
    gradients, AdamW's moments; numpy leaves) by the port's parameter
    names."""
    out = {}
    for name, path in param_paths(cfg).items():
        leaf = tree
        for k in path:
            leaf = leaf[k]
        out[name] = leaf
    return out


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device: Device = None
                      ) -> Union[lm.LM, ssm_lm.SSMLM, hybrid.HybridLM,
                                 encdec.EncDecLM]:
    """The reference's parameter tree (numpy leaves) -> the port's model
    of ``cfg``'s family, each weight from its key path
    (:func:`param_paths`)."""
    dev = resolve_device(device)
    model = _MODELS[cfg.family](cfg, dev)
    with torch.no_grad():
        for name, a in named_from_numpy(tree, cfg).items():
            getattr(model, name).copy_(tensor_from_numpy(a, dev))
    return model


def adamw_state_from_numpy(step, m: Mapping, v: Mapping, cfg: ModelConfig,
                           device: Device = None) -> AdamWState:
    """The reference's ``AdamWState`` (its step and the m and v trees,
    numpy leaves) -> the port's, by parameter name."""
    dev = resolve_device(device)
    moments = [{k: tensor_from_numpy(a, dev).float()
                for k, a in named_from_numpy(t, cfg).items()}
               for t in (m, v)]
    return AdamWState(step=torch.tensor(int(np.asarray(step)),
                                        dtype=torch.int32, device=dev),
                      m=moments[0], v=moments[1])


def batch_from_numpy(batch: Mapping, device: Device = None) -> dict:
    """A serve step's batch (``repro/serving/serve_step.py``'s keys, numpy
    leaves) as the port's tensors: codes stay uint8, bf16 planes cross as
    their bit view, integers and f32 as they are."""
    return {k: tensor_from_numpy(v, device) for k, v in batch.items()}


def cache_from_numpy(fields: Mapping, device: Device = None) -> CC.CTCache:
    """A CTCache (per request or batched) from numpy leaves by field name."""
    return CC.CTCache(**{f: tensor_from_numpy(fields[f], device)
                         for f in CC.CTCache.FIELDS})


def pool_from_numpy(view: Sequence, refcount, device: Device = None
                    ) -> CC.GlobalPool:
    """A GlobalPool from numpy (k_codes, v_codes, k_scales, v_scales)
    planes and the refcount."""
    return CC.GlobalPool(
        CC.PoolView(*(tensor_from_numpy(p, device) for p in view)),
        tensor_from_numpy(refcount, device))
