"""Mixture-of-experts FFN (ports ``repro/layers/moe.py``: ``moe_params``'
shapes and scales and ``moe_apply``).

Tokens are routed in groups of at most ``dispatch_group`` (the largest
divisor of the token count not above it, as the reference searches it):
an f32 router softmax, top-k on the probabilities (the lower expert index
first on ties, as ``jax.lax.top_k`` orders them), gates renormalized over
the k choices, and a capacity of ``max(ceil(k·gsz/E·cf), 4)`` rows per
expert and group.  A choice's position in its expert's queue counts the
earlier choices of that expert in (token, choice) order; a choice at or
past the capacity is dropped.

Where the reference builds one-hot dispatch and combine tensors
``[g, t, E, C]`` and contracts them, this module scatters each kept choice's
row into its expert's capacity buffer ``[g, E, C, D]`` and gathers the
expert outputs back: the same rows meet the same expert weights, and a
token's output is the gate-weighted sum of its kept choices.  The expert
products are plain batched matmuls over E (the reference's are einsums
outside any Pallas kernel).  Nothing here reads a routing decision back to
the host.

The auxiliary load-balancing loss is returned as the reference returns it;
serving never uses it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers.common import act_fn


def moe_param_shapes(cfg: ModelConfig) -> dict:
    """One layer's parameter shapes and init scales (the reference's
    ``moe_params``: a f32 router at scale 0.02, experts at fan-in)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {"router": ((d, e), 0.02), "w_up": ((e, d, ff), d ** -0.5),
            "w_gate": ((e, d, ff), d ** -0.5),
            "w_down": ((e, ff, d), ff ** -0.5)}


def group_size(n: int, dispatch_group: int) -> int:
    """The reference's group size for ``n`` tokens: the largest divisor of
    n not above ``dispatch_group``."""
    gsz = min(dispatch_group, n)
    while n % gsz:
        gsz -= 1
    return gsz


def capacity(cfg: ModelConfig, gsz: int) -> int:
    m = cfg.moe
    return max(int(math.ceil(m.num_experts_per_token * gsz / m.num_experts
                             * m.capacity_factor)), 4)


class Routing(NamedTuple):
    """One call's routing, per group g and token t of the group:
    ``expert`` [g, t, k] (long) and ``gate`` [g, t, k] (f32, renormalized),
    ``pos`` [g, t, k] (long: the choice's place in its expert's queue),
    ``keep`` [g, t, k] (bool: pos < cap), ``probs`` [g, t, E] (f32) and the
    capacity ``cap``."""

    expert: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    probs: torch.Tensor
    cap: int


def moe_route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig
              ) -> Routing:
    """Route the grouped tokens xt [g, t, D] (``router`` [D, E] f32)."""
    e, k = cfg.moe.num_experts, cfg.moe.num_experts_per_token
    ng, gsz, _ = xt.shape
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    # a stable descending sort keeps the lower index first on ties
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[..., :k], idx[..., :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = capacity(cfg, gsz)
    flat = expert.reshape(ng, gsz * k)
    seen = torch.nn.functional.one_hot(flat, e).cumsum(1)     # [g, t·k, E]
    pos = seen.gather(2, flat[..., None])[..., 0].reshape(ng, gsz, k) - 1
    return Routing(expert, gate, pos, pos < cap, probs, cap)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              group: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], the auxiliary loss): the B·S tokens
    flattened and routed in groups (see the module docstring); expert
    products in x's dtype, the router in f32.  ``group`` sets the group
    size where the reference routes smaller calls than this one (1: each
    token alone, as a ``vmap`` over single tokens does)."""
    e = cfg.moe.num_experts
    b, s, d = x.shape
    n = b * s
    gsz = group_size(n, group or cfg.moe.dispatch_group)
    ng = n // gsz
    xt = x.reshape(ng, gsz, d)
    rt = moe_route(p["router"], xt, cfg)
    cap, cdt = rt.cap, x.dtype
    # each kept choice's row in its expert's capacity buffer; dropped
    # choices land in a spare row past the capacity, cut off below
    slot = torch.where(rt.keep, rt.pos, cap)
    g_idx = torch.arange(ng, device=x.device)[:, None, None] \
        .expand_as(slot)
    xe = x.new_zeros((ng, e, cap + 1, d))
    xe[g_idx, rt.expert, slot] = xt[:, :, None].expand(*slot.shape, d)
    xe = xe[:, :, :cap]
    f = act_fn(cfg.act)
    w_gate, w_up, w_down = (p[w].to(cdt) for w in ("w_gate", "w_up",
                                                   "w_down"))
    h = f(torch.einsum("gecd,edf->gecf", xe, w_gate)) * \
        torch.einsum("gecd,edf->gecf", xe, w_up)
    ye = torch.einsum("gecf,efd->gecd", h, w_down)
    ye = torch.cat([ye, ye.new_zeros((ng, e, 1, d))], 2)
    picked = ye[g_idx, rt.expert, slot]                      # [g, t, k, D]
    w = torch.where(rt.keep, rt.gate, 0.0).to(cdt)
    y = (picked * w[..., None]).sum(2)
    frac = torch.nn.functional.one_hot(rt.expert[..., 0], e).sum(1) \
        .float().div(gsz).mean(0)
    aux = e * (frac * rt.probs.mean((0, 1))).sum()
    return y.reshape(b, s, d).to(x.dtype), aux
