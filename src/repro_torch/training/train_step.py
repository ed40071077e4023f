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

**Under a mesh** (``make_train_step(..., mesh=)``, a ``launch.mesh.
TrainMesh``) the step holds the reference's sharded step to its contract,
the one-device step: each rank holds its blocks of the parameters and of
AdamW's m and v under ``param_specs(mode="train")``
(:class:`ShardedParams`), FSDP over the dp axes and split over ``model``.
Each microbatch of the global batch is split over the dp axes
(``train_batch_specs``), ``sharding.data_parallel`` on, so a MoE layer
routes as one device does; with a loss mask each rank's NLL is weighted
by its share of the masked positions, so the mean over ranks is the
global masked mean.

Every family's compute is split along ``model`` as the reference's
GSPMD splits it (Megatron style: the family's ``loss_fn`` over a rank's
``lm.Weights``, the model bundle's ``split``; ``distributed/sharding.py``
has the collectives): attention heads, d_ff, the experts (or their d_ff
where the experts do not divide) and Mamba's d_inner as column then row
products, the embedding, the head and the cross entropy vocab-parallel.
No weight is gathered over ``model``; a layer's blocks are gathered over
the dp axes just before it runs (again when remat recomputes it) and
freed after, and the gradient of a dp-split block comes back as the mean
over dp of the gathered gradient, reduce-scattered to the block
(``sharding.gather_dp``).  The gradients of the blocks no dp axis splits
are then averaged over dp (:func:`reduce_grads`); the global norm sums
each distinct block once over the mesh; AdamW updates the blocks.  A
``grad_transform`` sees the whole gradient (every block gathered, then
cut again), as on one device.  Between steps a rank holds only its
blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig, OptimizerConfig
from repro_torch.distributed import sharding as SH
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


def batch_grads(loss_fn: Callable, params, batch, microbatches: int = 1,
                local: Optional[Callable] = None):
    """((loss, metrics), grads) of ``batch``: in one pass, or with
    ``microbatches`` > 1 over that many splits of its first axis, their
    gradients summed in f32 and divided (and their losses averaged; the
    model's metrics are then empty, as the reference returns none).
    ``local`` maps each (micro)batch to what this rank computes on (by
    default all of it)."""
    local = local or (lambda b: b)
    if microbatches == 1:
        return value_and_grad(loss_fn, params, local(batch))
    grads, ltot = None, None
    for i in range(microbatches):
        mb = {k: x.reshape(microbatches, x.shape[0] // microbatches,
                           *x.shape[1:])[i] for k, x in batch.items()}
        (l, _), g = value_and_grad(loss_fn, params, local(mb))
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
                    grad_transform: Optional[Callable] = None, mesh=None,
                    split: Optional[Callable] = None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: ``metrics`` holds ``loss``, ``grad_norm``,
    ``lr`` and, without microbatches, the model's own (``nll``,
    ``moe_aux``), each a 0-d tensor on the parameters' device.  The
    parameters are updated in place.  Under ``mesh`` the parameters are a
    :class:`ShardedParams`, the state's moments its blocks, and ``batch``
    the global batch (see the module docstring); ``split`` (the model
    bundle's, ``models/factory.py``), which a mesh needs, builds what
    ``model_loss`` takes from a rank's blocks."""
    loss_fn = make_loss(model_loss, cfg, remat)
    if mesh is not None:
        if split is None:
            raise ValueError("a sharded train step needs split= (the model "
                             "bundle's, models/factory.py): the loss runs "
                             "on a rank's blocks")
        return _sharded_step(
            lambda specs: lambda p, b: loss_fn(split(p, specs, mesh), b),
            opt_cfg, mesh, microbatches, grad_transform)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = batch_grads(loss_fn, params, batch,
                                             microbatches)
        if grad_transform is not None:
            grads = grad_transform(grads)
        _, opt_state, opt_metrics = O.adamw_update(opt_cfg, grads,
                                                   opt_state, params)
        return params, opt_state, {"loss": loss, **opt_metrics, **metrics}

    return train_step


@dataclasses.dataclass
class ShardedParams:
    """A rank's parameters under a mesh: its blocks (by parameter name)
    under ``specs``."""

    blocks: Dict[str, torch.Tensor]
    specs: Dict[str, tuple]
    mesh: object


@torch.no_grad()
def shard_params(model: nn.Module, mesh) -> ShardedParams:
    """Split a full-size model (the same on every rank) into this rank's
    blocks under ``param_specs(model, mesh, mode="train")``.  A block that
    is the whole parameter is that parameter; a parameter a spec splits
    gives its storage back (the model keeps no copy of it)."""
    specs = SH.param_specs(model, mesh, mode="train")
    blocks = {}
    for k, p in O.named(model).items():
        b = SH.shard_of(p.detach(), specs[k], mesh)
        blocks[k] = b if b.shape == p.shape else b.clone()
        if b.shape != p.shape:
            p.untyped_storage().resize_(0)
    return ShardedParams(blocks, specs, mesh)


def reduce_grads(grads: Dict[str, torch.Tensor], mesh
                 ) -> Dict[str, torch.Tensor]:
    """The mean over the dp ranks of each rank's gradients (in place)."""
    axes = SH.dp_axes(mesh)
    n = SH.axes_size(mesh, axes)
    if n == 1:
        return grads
    return {k: SH.all_reduce_sum_(g.contiguous(), mesh, axes, "grad")
            .div_(n) for k, g in grads.items()}


def block_norm(grads: Dict[str, torch.Tensor], specs: dict, mesh
               ) -> torch.Tensor:
    """The global norm of the whole gradient from this rank's blocks of
    it: each block's sum of squares over the ranks that hold the same
    block, summed over the dp axes and over ``model``."""
    total = None
    for k, g in grads.items():
        sq = torch.sum(torch.square(g.float())) / SH.copies(specs[k], mesh)
        total = sq if total is None else total + sq
    total = SH.all_reduce_sum(total, mesh, SH.dp_axes(mesh))
    return torch.sqrt(SH.all_reduce_sum(total, mesh, SH.MODEL_AXIS))


def _sharded_step(split_fn: Callable, opt_cfg: OptimizerConfig, mesh,
                  microbatches: int, grad_transform: Optional[Callable]):
    axes = SH.dp_axes(mesh)
    ndp = SH.axes_size(mesh, axes)

    def train_step(params: ShardedParams, opt_state, batch):
        # does each microbatch split over dp?  (else every rank runs it)
        mb0 = {k: x[: x.shape[0] // microbatches] for k, x in batch.items()}
        split = ndp > 1 and any(sp and sp[0] is not None for sp in
                                SH.train_batch_specs(mb0, mesh).values())

        def local(b):
            sp = SH.train_batch_specs(b, mesh)
            return {k: SH.shard_of(x, sp[k], mesh) for k, x in b.items()}

        def dp_loss(f):
            def run(p, b):
                total, metrics = f(p, b)
                if split and "loss_mask" in b:
                    # this rank's share of the masked positions, times ndp
                    m = b["loss_mask"].float().sum()
                    w = ndp * m / SH.all_reduce_sum(m, mesh, axes) \
                        .clamp_min(1)
                    total = total + (w - 1) * metrics["nll"]
                    metrics = {**metrics, "nll": w * metrics["nll"]}
                return total, metrics
            return run

        leaves = {k: b.detach().requires_grad_(True)
                  for k, b in params.blocks.items()}
        with SH.data_parallel(mesh if split else None):
            (loss, metrics), grads = batch_grads(
                dp_loss(split_fn(params.specs)), leaves, batch,
                microbatches, local)
        del leaves
        # gather_dp's backward averaged the dp-split blocks already
        rest = {k: g for k, g in grads.items()
                if SH.dp_dim(params.specs[k], mesh) is None}
        grads.update(reduce_grads(rest, mesh))
        loss = _dp_mean(loss, mesh)
        metrics = {k: _dp_mean(v, mesh) for k, v in metrics.items()}
        if grad_transform is not None:
            grads = grad_transform({
                k: SH.unshard(g.contiguous(), params.specs[k], mesh, "grad")
                for k, g in grads.items()})
            gnorm = O.global_norm(grads)
            grads = {k: SH.shard_of(g, params.specs[k], mesh)
                     for k, g in grads.items()}
        else:
            gnorm = block_norm(grads, params.specs, mesh)
        _, opt_state, opt_metrics = O.adamw_update(
            opt_cfg, grads, opt_state, params.blocks, gnorm=gnorm)
        return params, opt_state, {"loss": loss, **opt_metrics, **metrics}

    return train_step


def _dp_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    axes = SH.dp_axes(mesh)
    return SH.all_reduce_sum(x, mesh, axes) / SH.axes_size(mesh, axes)
