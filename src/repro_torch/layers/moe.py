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

Under a sharded train step (``distributed.sharding.data_parallel``) each
rank holds a block of the batch, and the reference computes as one device
does: the group size comes from the global token count, and the Switch
loss ``E·Σ frac·pmean`` is a product of global means.  So a rank routes
its block with the global group size and capacity; where a group spans
ranks it adds to each choice's queue place the choices of that expert on
the lower ranks of the group (integer counts, all-gathered); and the
per-rank sums behind ``frac`` and ``pmean`` are summed over the dp ranks
before the product.

Under the sharded train step's compute split (``split=`` a train mesh
with a ``model`` axis) the routing stays global and replicated over
``model``; the expert products run on this rank's blocks of the experts'
weights.  Where the experts divide over ``model`` (expert parallelism,
``w_up`` [E/|model|, D, F]) a rank runs only its experts on the choices
routed to them; otherwise (tensor parallelism on F, ``w_up`` [E, D,
F/|model|]) it runs every expert over its columns of F.  Either way the
ranks' partial outputs are summed over ``model``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.layers.common import act_fn
from repro_torch.spans import span


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


def moe_route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig,
              cap: Optional[int] = None) -> Routing:
    """Route the grouped tokens xt [g, t, D] (``router`` [D, E] f32) with
    ``cap`` rows per expert (by default the capacity of groups of t)."""
    e, k = cfg.moe.num_experts, cfg.moe.num_experts_per_token
    ng, gsz, _ = xt.shape
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    # a stable descending sort keeps the lower index first on ties
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[..., :k], idx[..., :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = capacity(cfg, gsz) if cap is None else cap
    flat = expert.reshape(ng, gsz * k)
    seen = torch.nn.functional.one_hot(flat, e).cumsum(1)     # [g, t·k, E]
    pos = seen.gather(2, flat[..., None])[..., 0].reshape(ng, gsz, k) - 1
    return Routing(expert, gate, pos, pos < cap, probs, cap)


def _experts(p: dict, xt: torch.Tensor, rt: Routing, cfg: ModelConfig,
             split=None) -> torch.Tensor:
    """The kept choices of the grouped tokens xt [g, t, D] through their
    experts, gate-weighted and summed per token: [g, t, D] in xt's
    dtype.  Under ``split`` (a train mesh) the experts' weights are this
    rank's blocks, and the partial outputs are summed over ``model`` (see
    the module docstring)."""
    ng, _, d = xt.shape
    cap, cdt = rt.cap, xt.dtype
    e_loc = p["w_up"].shape[0]
    expert, keep, gate = rt.expert, rt.keep, rt.gate
    if split is not None and (e_loc < cfg.moe.num_experts
                              or p["w_up"].shape[-1] < cfg.d_ff):
        xt = SH.to_model(xt, split)
        gate = SH.to_model(gate, split)
        if e_loc < cfg.moe.num_experts:      # this rank's experts only
            lo = SH.model_index(split) * e_loc
            local = (expert >= lo) & (expert < lo + e_loc)
            keep = keep & local
            expert = torch.where(local, expert - lo, 0)
    else:
        split = None
    # each kept choice's row in its expert's capacity buffer; dropped
    # choices land in a spare row past the capacity, cut off below
    slot = torch.where(keep, rt.pos, cap)
    g_idx = torch.arange(ng, device=xt.device)[:, None, None] \
        .expand_as(slot)
    xe = xt.new_zeros((ng, e_loc, cap + 1, d))
    xe[g_idx, expert, slot] = xt[:, :, None].expand(*slot.shape, d)
    xe = xe[:, :, :cap]
    f = act_fn(cfg.act)
    w_gate, w_up, w_down = (p[w].to(cdt) for w in ("w_gate", "w_up",
                                                   "w_down"))
    h = f(torch.einsum("gecd,edf->gecf", xe, w_gate)) * \
        torch.einsum("gecd,edf->gecf", xe, w_up)
    ye = torch.einsum("gecf,efd->gecd", h, w_down)
    ye = torch.cat([ye, ye.new_zeros((ng, e_loc, 1, d))], 2)
    picked = ye[g_idx, expert, slot]                         # [g, t, k, D]
    w = torch.where(keep, gate, 0.0).to(cdt)
    y = (picked * w[..., None]).sum(2)
    return y if split is None else SH.from_model(y, split)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              group: Optional[int] = None, split=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], the auxiliary loss): the B·S tokens
    flattened and routed in groups (see the module docstring); expert
    products in x's dtype, the router in f32.  ``group`` sets the group
    size where the reference routes smaller calls than this one (1: each
    token alone, as a ``vmap`` over single tokens does).  Under an active
    ``sharding.data_parallel`` x is this rank's block of the batch
    (:func:`_moe_apply_dp`); ``split`` (a train mesh) runs the experts on
    this rank's blocks of their weights (:func:`_experts`)."""
    if group is None and SH.active_data_parallel() is not None:
        return _moe_apply_dp(p, x, cfg, SH.active_data_parallel(), split)
    e = cfg.moe.num_experts
    b, s, d = x.shape
    n = b * s
    gsz = group_size(n, group or cfg.moe.dispatch_group)
    xt = x.reshape(n // gsz, gsz, d)
    with span("route"):
        rt = moe_route(p["router"], xt, cfg)
    with span("experts"):
        y = _experts(p, xt, rt, cfg, split)
    frac = torch.nn.functional.one_hot(rt.expert[..., 0], e).sum(1) \
        .float().div(gsz).mean(0)
    aux = e * (frac * rt.probs.mean((0, 1))).sum()
    return y.reshape(b, s, d).to(x.dtype), aux


def _moe_apply_dp(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh,
                  split=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` of this rank's block x [B/dp, S, D] of a batch split
    over ``dp_axes(mesh)``, as one device applies it to the whole batch
    (see the module docstring).  Groups must lie within a rank's block or
    span whole blocks."""
    e, k = cfg.moe.num_experts, cfg.moe.num_experts_per_token
    axes = SH.dp_axes(mesh)
    ndp, i = SH.axes_size(mesh, axes), SH.block_index(mesh, axes)
    b, s, d = x.shape
    n_loc = b * s
    n = n_loc * ndp
    gsz = group_size(n, cfg.moe.dispatch_group)
    cap = capacity(cfg, gsz)
    if n_loc % gsz == 0:
        xt = x.reshape(n_loc // gsz, gsz, d)
        rt = moe_route(p["router"], xt, cfg, cap)
    elif gsz % n_loc == 0:
        xt = x.reshape(1, n_loc, d)
        rt = moe_route(p["router"], xt, cfg, cap)
        # queue places continue those of the group's lower ranks
        counts = torch.nn.functional.one_hot(rt.expert.reshape(-1), e) \
            .sum(0).to(torch.int32)
        every = SH.all_gather(counts[None], mesh, axes, 0)   # [dp, E]
        first = i - i % (gsz // n_loc)
        offset = every[first:i].sum(0).long()
        pos = rt.pos + offset[rt.expert]
        rt = rt._replace(pos=pos, keep=pos < cap)
    else:
        raise ValueError(
            f"{cfg.name}: MoE groups of {gsz} tokens neither fit in nor span "
            f"whole blocks of {n_loc} tokens on {ndp} data-parallel ranks")
    y = _experts(p, xt, rt, cfg, split)
    top = torch.nn.functional.one_hot(rt.expert[..., 0], e).sum((0, 1)) \
        .float()
    frac = SH.all_reduce_sum(top, mesh, axes) / n
    pmean = SH.sum_over_ranks(rt.probs.sum((0, 1)), mesh, axes) / n
    aux = e * (frac * pmean).sum()
    return y.reshape(b, s, d).to(x.dtype), aux
