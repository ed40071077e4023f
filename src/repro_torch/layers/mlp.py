"""Feed-forward block (ports ``repro/layers/mlp.py``: ``mlp``)."""
from __future__ import annotations

import torch

from repro_torch.layers.common import act_fn


def mlp(p: dict, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    f = act_fn(act)
    up = x @ p["w_up"]
    h = f(x @ p["w_gate"]) * up if gated else f(up)
    return h @ p["w_down"]
