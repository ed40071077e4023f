"""Gradient compression with error feedback for low-bandwidth
(cross-pod) data parallelism (ports ``repro/distributed/compression.py``:
``int8_quantize``, ``int8_dequantize``, ``ef_compress``, ``make_ef_state``,
``ef_transform``, ``compressed_psum``, ``make_cross_pod_grad_fn``).

int8 row-scaled symmetric quantization; the residual of each round is
added back before the next (EF-SGD).  ``compressed_psum`` sums the
per-rank *dequantized* values over an axis (each sender's quantization
error is local and handled by error feedback), as the reference expresses
it: the wire format it models (1 B/element + 4 B/row) is the reference's
roofline term; gloo moves the f32 values.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple, Union

import torch

from repro_torch.distributed import sharding as SH


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-scaled symmetric int8: x [..., d] -> (codes int8, scales f32
    [..., 1])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def int8_dequantize(codes: torch.Tensor, scale: torch.Tensor
                    ) -> torch.Tensor:
    return codes.float() * scale


def ef_compress(g: torch.Tensor, residual: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compression of one gradient leaf: (the gradient as
    transported, in g's dtype; the new residual)."""
    x = g.float() + residual
    if x.dim() == 0:
        return x, torch.zeros_like(x)
    codes, scale = int8_quantize(x)
    deq = int8_dequantize(codes, scale)
    return deq.to(g.dtype), x - deq


def make_ef_state(grads: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Zero f32 residuals shaped like the gradients."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def ef_transform(grads: Mapping[str, torch.Tensor],
                 state: Mapping[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """EF compression of a gradient dict -> (grads, new state)."""
    outs = {k: ef_compress(g, state[k]) for k, g in grads.items()}
    return ({k: o[0] for k, o in outs.items()},
            {k: o[1] for k, o in outs.items()})


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over the ranks of ``axis`` of each rank's int8 round trip
    of ``x``."""
    codes, scale = int8_quantize(x)
    return SH.all_reduce_sum(int8_dequantize(codes, scale), mesh, axis)


Tree = Union[torch.Tensor, Mapping[str, torch.Tensor]]


def make_cross_pod_grad_fn(loss_fn: Callable, mesh, *,
                           compress: bool = True) -> Callable:
    """The reference's data-parallel gradient over ``pod``: each rank's
    gradient of ``loss_fn(params, batch)`` on its block of the batch,
    EF-compressed when ``compress``, then averaged over the ``pod``
    ranks.  Returns ``grad_fn(params, batch, residual) -> (grads,
    residual)``: ``params`` (a tensor or a name -> tensor mapping) and
    ``residual`` (shaped like it) whole on every rank, ``batch`` this
    rank's block (the reference's ``P("pod")``); the residual returned is
    this rank's."""
    n = SH.axes_size(mesh, "pod")

    def grad_one_pod(params: Tree, batch, residual: Tree):
        single = isinstance(params, torch.Tensor)
        p = {"": params} if single else dict(params)
        r = {"": residual} if single else dict(residual)
        with torch.enable_grad():
            leaves = {k: x.detach().requires_grad_(True)
                      for k, x in p.items()}
            loss = loss_fn(leaves[""] if single else leaves, batch)
            g = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        if compress:
            g, r = ef_transform(g, r)
        g = {k: SH.all_reduce_sum(x, mesh, "pod") / n for k, x in g.items()}
        return (g[""], r[""]) if single else (g, r)

    return grad_one_pod
