"""AdamW with linear-warmup cosine decay and global-norm clipping (ports
``repro/training/optimizer.py``: ``AdamWState``, ``lr_schedule``,
``global_norm``, ``clip_by_global_norm``, ``adamw_init``,
``adamw_update``).

Parameters, gradients and the moments are name -> tensor dicts (a model's
``named_parameters``, or any mapping); ``m`` and ``v`` stay f32 whatever
the parameter dtype.  The update follows the reference's order of
operations in f32 on the parameters' device (the schedule too, from the
step count there), one leaf at a time, and writes the new parameters and
moments in place (the same roundings as the reference's new arrays): the
trainer keeps one copy of the weights and of each moment, and the
clipped gradient of one leaf at a time.  (The reference's docstring
names an Adafactor that its module does not define.)
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.config import OptimizerConfig

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


class AdamWState(NamedTuple):
    step: torch.Tensor            # int32 []
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def named(params: Params) -> Dict[str, torch.Tensor]:
    """A model's parameters by name, or a mapping as a dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to a tenth of it by
    ``decay_steps``; f32 on ``step``'s device."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (f32)."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled to at most ``max_norm`` in global norm, the norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def adamw_init(params: Params) -> AdamWState:
    """Zero f32 moments beside each parameter, step 0."""
    p = named(params)
    dev = next(iter(p.values())).device
    zeros = lambda: {k: torch.zeros(x.shape, dtype=torch.float32,
                                    device=x.device) for k, x in p.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(), v=zeros())


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: Mapping[str, torch.Tensor],
                 state: AdamWState, params: Params,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Dict[str, torch.Tensor], AdamWState, dict]:
    """One AdamW step: clip, advance the step, schedule, then per leaf
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``, bias-corrected,
    ``p -= lr (mhat / (sqrt(vhat) + eps) + wd p)``.  The parameters and the
    state's moments are updated in place.  ``gnorm`` is the global norm
    to clip by when ``grads`` are a rank's blocks of the whole gradient
    (by default that of ``grads``).  Returns (params, the new state,
    {"grad_norm", "lr"})."""
    p = named(params)
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.float()
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=sf.device), sf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=sf.device), sf)
    for k, x in p.items():
        g = grads[k]
        gf = (g * scale.to(g.dtype)).float()
        m, v = state.m[k], state.v[k]
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        del gf
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) + \
            cfg.weight_decay * x.float()
        x.copy_((x.float() - lr * delta).to(x.dtype))
    return p, AdamWState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gnorm, "lr": lr}
