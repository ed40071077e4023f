"""Model factory (ports ``repro/models/factory.py``: ``Model`` and
``build_model``) for every family: DENSE, MOE and VLM (``models/lm.py``,
as the reference maps all three), ENCDEC (``models/encdec.py``), SSM
(``models/ssm_lm.py``) and HYBRID (``models/hybrid.py``).

``input_specs`` is not ported: it builds ``jax.ShapeDtypeStruct`` stand-ins
for the XLA dry-run's lowering, which has no PyTorch meaning.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.config import ArchFamily, ModelConfig
from repro_torch.models import encdec, hybrid, lm, ssm_lm


def loss_fn(params, batch, cfg: ModelConfig):
    raise NotImplementedError("training losses are not ported yet (ROADMAP "
                              "queue 1 item 16)")


_FAMILY_MODULES = {ArchFamily.DENSE: lm, ArchFamily.MOE: lm,
                   ArchFamily.VLM: lm, ArchFamily.ENCDEC: encdec,
                   ArchFamily.SSM: ssm_lm, ArchFamily.HYBRID: hybrid}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    logits: Callable
    loss: Callable
    module: object

    def init_params(self, seed: int = 0,
                    device: Optional[Union[str, torch.device]] = None,
                    dtype: torch.dtype = torch.float32):
        """Random weights from ``seed`` on ``device`` (the card by
        default)."""
        return self.init(self.cfg, seed, device, dtype)


def build_model(cfg: ModelConfig) -> Model:
    mod = _FAMILY_MODULES[cfg.family]
    return Model(cfg=cfg, init=mod.init_params, logits=mod.logits_fn,
                 loss=loss_fn, module=mod)
