"""Normalization (ports ``repro/layers/norms.py``: ``rmsnorm``)."""
from __future__ import annotations

import torch


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * p["scale"]).to(x.dtype)
