"""Normalization (ports ``repro/layers/norms.py``: ``rmsnorm`` and
``layernorm``)."""
from __future__ import annotations

import torch

from repro_torch.layers.common import wide


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = wide(x)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * p["scale"]).to(x.dtype)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Pre-norm LayerNorm with ``scale`` and ``bias``; the variance is the
    biased one (``jnp.var``)."""
    xf = wide(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)
