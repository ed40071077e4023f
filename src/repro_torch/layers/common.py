"""Shared layer utilities (ports ``repro/layers/common.py``): seeded
initializers, activations, logit soft-capping, ``remat`` (the models'
``jax.checkpoint`` of a layer body) and ``wide`` (the f32 upcast that
keeps an f64 tensor in f64).

Parameters are plain dicts of tensors (per-layer views of the model's
stacked weights); the initializers fill a tensor in place from an explicit
``torch.Generator`` with the reference's distributions and scales (the
numbers differ from ``jax.random``'s for the same seed).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dense_init_(t: torch.Tensor, gen: torch.Generator,
                scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal in [-2, 2] std, std = fan_in ** -0.5 (fan_in is the
    second-to-last axis: the input width of an ``x @ W`` weight, also for
    weights stacked over layers)."""
    fan_in = t.shape[-2] if t.dim() > 1 else t.shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std)


def embed_init_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return t.normal_(0.0, 0.02, generator=gen)


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r}")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-style logit soft-capping; no-op when cap == 0."""
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def remat(fn: Callable, *args, enabled: bool = True):
    """``fn(*args)``; with ``enabled`` and autograd recording, under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): only
    the inputs are kept, and backward recomputes the body."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32 (the reference's ``astype(float32)`` of its bf16 and f32
    values), or left in f64: the same forward evaluated in f64 (the card's
    check of a train step) stays f64 throughout."""
    return x if x.dtype == torch.float64 else x.float()
