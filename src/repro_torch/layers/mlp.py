"""Feed-forward block (ports ``repro/layers/mlp.py``: ``mlp``), and its
form under the sharded train step's compute split (``mlp_split``)."""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.layers.common import act_fn


def mlp(p: dict, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    f = act_fn(act)
    up = x @ p["w_up"]
    h = f(x @ p["w_gate"]) * up if gated else f(up)
    return h @ p["w_down"]


def mlp_split(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``mlp`` of the replicated x from this rank's blocks: where d_ff is
    split over ``model``, ``w_up`` / ``w_gate`` are column products and
    ``w_down`` a row product whose partial results are summed over
    ``model``; whole weights run ``mlp``."""
    if p["w_up"].shape[-1] == cfg.d_ff:
        return mlp(p, x, cfg.act, cfg.mlp_gated)
    return SH.from_model(mlp(p, SH.to_model(x, mesh), cfg.act,
                             cfg.mlp_gated), mesh)
