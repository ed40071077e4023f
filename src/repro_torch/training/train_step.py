"""The train step: the loss's value and gradients, then AdamW, with
optional microbatch gradient accumulation and a gradient hook (ports
``repro/training/train_step.py``: ``make_loss``, ``make_train_step``).

Gradients come from ``torch.autograd.grad`` over the model's parameters
(which must require gradients: the trainer turns them on).  With
``microbatches`` > 1 the batch is split along its first axis and the
splits' gradients are summed in f32, then divided, as the reference's
``lax.scan`` accumulates them.  ``grad_transform`` hooks the gradient dict
before the optimizer (gradient compression lives there).  The step runs
no kernel of the port: attention, scans and the loss are plain PyTorch
under autograd, as the reference's are plain XLA.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.config import ModelConfig, OptimizerConfig
from repro_torch.training import optimizer as O


def make_loss(model_loss: Callable, cfg: ModelConfig, remat: bool):
    def loss(params, batch):
        return model_loss(params, batch, cfg, remat=remat)
    return loss


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, metrics), grads by parameter name) of ``loss_fn(params,
    batch)``; a parameter the loss does not reach gets a zero gradient."""
    named = O.named(params)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
    out = {k: torch.zeros_like(x) if g is None else g
           for (k, x), g in zip(named.items(), grads)}
    detach = lambda d: {k: v.detach() for k, v in d.items()}
    return (loss.detach(), detach(metrics)), out


def batch_grads(loss_fn: Callable, params, batch, microbatches: int = 1):
    """((loss, metrics), grads) of ``batch``: in one pass, or with
    ``microbatches`` > 1 over that many splits of its first axis, their
    gradients summed in f32 and divided (and their losses averaged; the
    model's metrics are then empty, as the reference returns none)."""
    if microbatches == 1:
        return value_and_grad(loss_fn, params, batch)
    grads, ltot = None, None
    for i in range(microbatches):
        mb = {k: x.reshape(microbatches, x.shape[0] // microbatches,
                           *x.shape[1:])[i] for k, x in batch.items()}
        (l, _), g = value_and_grad(loss_fn, params, mb)
        if grads is None:
            grads = {k: torch.zeros(x.shape, dtype=torch.float32,
                                    device=x.device) for k, x in g.items()}
            ltot = torch.zeros((), dtype=torch.float32, device=l.device)
        grads = {k: grads[k] + g[k] for k in grads}
        ltot = ltot + l
    return (ltot / microbatches, {}), \
        {k: g / microbatches for k, g in grads.items()}


def make_train_step(model_loss: Callable, cfg: ModelConfig,
                    opt_cfg: OptimizerConfig, *, remat: bool = True,
                    microbatches: int = 1,
                    grad_transform: Optional[Callable] = None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: ``metrics`` holds ``loss``, ``grad_norm``,
    ``lr`` and, without microbatches, the model's own (``nll``,
    ``moe_aux``), each a 0-d tensor on the parameters' device.  The
    parameters are updated in place."""
    loss_fn = make_loss(model_loss, cfg, remat)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = batch_grads(loss_fn, params, batch,
                                             microbatches)
        if grad_transform is not None:
            grads = grad_transform(grads)
        _, opt_state, opt_metrics = O.adamw_update(opt_cfg, grads,
                                                   opt_state, params)
        return params, opt_state, {"loss": loss, **opt_metrics, **metrics}

    return train_step
