"""The training loop with checkpoint/restart, failure injection and the
straggler monitor (ports ``repro/training/trainer.py``: ``TrainResult``,
``Trainer``).

``Trainer.run()`` is restartable: it resumes from the newest valid
checkpoint, so an :class:`InjectedFailure` (or a real preemption)
followed by a fresh ``Trainer(...).run()`` continues the run.  One device:
the parameters live on ``device`` (the card by default), the state is
the model's parameters and AdamW's moments, checkpointed as the tree
``{"params", "opt_m", "opt_v"}`` keyed by parameter name.

With ``mesh`` (a ``launch.mesh.TrainMesh``; every rank of it constructs
and runs its own ``Trainer``) the state is this rank's blocks under
``param_specs(mode="train")`` on the mesh's device, the step is the
sharded one (``training/train_step.py``), checkpoints are gathered and
written by rank 0, and the restore cuts each stored leaf to this rank's
block: a run saved at N ranks resumes at M (the elastic restore).  The
mesh must have ``cfg.mesh``'s shape and axes.  As in
the reference, the trainer installs no constraint mesh (attention takes
no ring branch).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer as CKPT
from repro_torch.config import TrainConfig
from repro_torch.device import resolve_device, set_f32_numerics
from repro_torch.distributed import sharding as SH
from repro_torch.ft.failures import FailureInjector, StragglerMonitor
from repro_torch.models.factory import build_model
from repro_torch.training.optimizer import AdamWState, adamw_init, named
from repro_torch.training.train_step import make_train_step, shard_params


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: List[float]
    straggler_summary: Dict
    resumed_from: int


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A data batch (numpy leaves) as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class Trainer:
    def __init__(self, cfg: TrainConfig, data_fn: Callable[[int], Iterator],
                 mesh=None, failure_injector: Optional[FailureInjector]
                 = None, grad_transform=None, device=None):
        if mesh is not None and (tuple(mesh.shape), tuple(mesh.axis_names)
                                 ) != (cfg.mesh.shape, cfg.mesh.axis_names):
            raise ValueError(
                f"the mesh {dict(zip(mesh.axis_names, mesh.shape))} is not "
                f"cfg.mesh {dict(zip(cfg.mesh.axis_names, cfg.mesh.shape))}")
        self.cfg = cfg
        self.data_fn = data_fn
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.model = build_model(cfg.model)
        self.injector = failure_injector
        self.monitor = StragglerMonitor()
        self.ckpt = CKPT.CheckpointManager(cfg.checkpoint_dir,
                                           keep=cfg.keep_checkpoints,
                                           save_every=cfg.checkpoint_every)
        self._step_fn = make_train_step(
            self.model.loss, cfg.model, cfg.optimizer,
            remat=cfg.remat, microbatches=cfg.microbatches,
            grad_transform=grad_transform, mesh=mesh,
            split=self.model.split)

    def _init_state(self):
        """(the model with gradients on, AdamW's zero state)."""
        params = self.model.init_params(self.cfg.seed, self.device)
        params.requires_grad_(True)
        return params, adamw_init(params)

    def run(self) -> TrainResult:
        cfg = self.cfg
        set_f32_numerics()
        params, opt = self._init_state()
        state, shardings = named(params), None
        if self.mesh is not None:
            params = shard_params(params, self.mesh)
            opt = adamw_init(params.blocks)
            state = params.blocks
            sh = {k: SH.Sharding(spec, self.mesh)
                  for k, spec in params.specs.items()}
            shardings = {"params": sh, "opt_m": sh, "opt_v": sh}
        start = resumed_from = 0
        ck_step = CKPT.latest_step(cfg.checkpoint_dir)
        if ck_step is not None:
            restored = CKPT.restore(cfg.checkpoint_dir, ck_step,
                                    {"params": state, "opt_m": opt.m,
                                     "opt_v": opt.v}, shardings=shardings)
            with torch.no_grad():
                for k, x in state.items():
                    x.copy_(restored["params"][k])
            opt = AdamWState(step=torch.tensor(ck_step, dtype=torch.int32,
                                               device=opt.step.device),
                             m=restored["opt_m"], v=restored["opt_v"])
            start = resumed_from = ck_step

        data = self.data_fn(start)
        losses: List[float] = []
        step = start
        for step in range(start + 1, cfg.steps + 1):
            batch = batch_to(next(data), self.device)
            self.monitor.start_step()
            params, opt, metrics = self._step_fn(params, opt, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            self.monitor.end_step(step)
            self.ckpt.maybe_save(
                step, {"params": state, "opt_m": opt.m, "opt_v": opt.v},
                extra={"loss": loss}, asynchronous=False,
                shardings=shardings)
            if self.injector is not None:
                self.injector.check(step)
        self.ckpt.wait()
        return TrainResult(final_step=step, losses=losses,
                           straggler_summary=self.monitor.summary(),
                           resumed_from=resumed_from)
