"""Gradient compression with error feedback, the single-device half
(ports ``repro/distributed/compression.py``: ``int8_quantize``,
``int8_dequantize``, ``ef_compress``, ``make_ef_state``,
``ef_transform``).

int8 row-scaled symmetric quantization; the residual of each round is
added back before the next (EF-SGD).  ``compressed_psum`` and
``make_cross_pod_grad_fn``, the cross-pod all-reduce over the codes, are
ROADMAP item 16b.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


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
