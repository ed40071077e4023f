"""State-space mixers (ports ``repro/layers/ssm.py``): Mamba-1
(falcon-mamba: ``causal_conv1d``, ``conv_step``, ``mamba1_dims``,
``mamba1_params``, ``_mamba1_inner``, ``mamba1_forward``, ``Mamba1State``,
``mamba1_init_state``, ``mamba1_decode_step``) and Mamba-2 (zamba2:
``mamba2_dims``, ``mamba2_params``, ``_split_mamba2``, ``mamba2_forward``,
``Mamba2State``, ``mamba2_init_state``, ``mamba2_decode_step``).

The prefill/teacher-forced forward runs its selective scan through K5
(``kernels.ops.mamba_scan``, one launch per layer for the whole batch)
where the reference runs a ``lax.scan``; the ``D`` skip and the
``silu(z)`` gate stay plain torch.  Decode is one step of the recurrence in
plain torch, as in the reference.  Two parts of the reference's
``_mamba1_inner`` are not ported: its ``h0`` argument and ``h_last``
result (nothing in the reference uses them: the forward always starts
from ``h_0 = 0``), and its chunked ``jax.checkpoint`` (a training memory
device; the port serves).

Mamba-2 has no Pallas kernel in the reference, so it is plain torch here:
the chunked SSD form of ``mamba2_forward`` (a quadratic form inside each
chunk, the state carried between chunks; the chunk shrinks from
``ssm.chunk_size`` until it divides S; f32 as the reference casts) and one
step of the recurrence for decode.  The reference's ``jax.checkpoint`` of
a chunk (a training memory device) is dropped, as Mamba-1's was.

Parameters are plain dicts of tensors, in the reference's layout
(``x @ W`` with W ``[in, out]``); the depthwise conv is ``F.conv1d`` with
``groups=C``, as the reference computes it with ``lax.conv`` outside any
kernel (TF32 is off for it on the card: ``device.set_f32_numerics``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as KR
from repro_torch.layers.common import dense_init_

# the per-layer mixer parameters, in the reference's order
MAMBA1_PARAMS = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                 "dt_bias", "A_log", "D", "out_proj")


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x [B, S, C], w [C, W], b [C] -> silu(causal depthwise conv) [B, S, C]."""
    c, wdt = w.shape
    xp = F.pad(x.transpose(1, 2), (wdt - 1, 0))
    out = F.conv1d(xp, w.to(x.dtype)[:, None, :], groups=c)
    return F.silu(out.transpose(1, 2) + b.to(x.dtype))


def conv_step(window: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-time conv: window [..., W, C], x_t [..., C] -> (new window,
    silu(y) [..., C])."""
    window = torch.cat([window[..., 1:, :], x_t[..., None, :]], dim=-2)
    y = (window * w.T.to(window.dtype)).sum(-2) + b
    return window, F.silu(y)


def mamba1_dims(cfg: ModelConfig):
    """(d_inner, dt_rank, state size N, conv width)."""
    di = cfg.ssm.expand * cfg.d_model
    dt_rank = cfg.ssm.dt_rank or math.ceil(cfg.d_model / 16)
    return di, dt_rank, cfg.ssm.state_size, cfg.ssm.conv_width


def mamba1_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Shape of each of one layer's mixer parameters."""
    d = cfg.d_model
    di, dtr, n, cw = mamba1_dims(cfg)
    return {"in_proj": (d, 2 * di), "conv_w": (di, cw), "conv_b": (di,),
            "x_proj": (di, dtr + 2 * n), "dt_proj": (dtr, di),
            "dt_bias": (di,), "A_log": (di, n), "D": (di,),
            "out_proj": (di, d)}


@torch.no_grad()
def mamba1_params_(p: Dict[str, torch.Tensor], gen: torch.Generator,
                   cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Fill mixer parameters in place with the reference's init
    (``mamba1_params``): truncated-normal fan-in projections (the conv at
    std ``W ** -0.5``, dt_proj at ``dt_rank ** -0.5``), zero conv bias,
    ``dt_bias = -4.6`` (softplus^-1(0.01)), ``A_log = log(1..N)`` per
    channel, ``D = 1``.  Tensors may carry leading (layer) axes."""
    _, dtr, n, cw = mamba1_dims(cfg)
    dense_init_(p["in_proj"], gen)
    dense_init_(p["conv_w"], gen, scale=cw ** -0.5)
    p["conv_b"].zero_()
    dense_init_(p["x_proj"], gen)
    dense_init_(p["dt_proj"], gen, scale=dtr ** -0.5)
    p["dt_bias"].fill_(-4.6)
    p["A_log"].copy_(torch.log(torch.arange(
        1, n + 1, dtype=torch.float32, device=p["A_log"].device)))
    p["D"].fill_(1.0)
    dense_init_(p["out_proj"], gen)
    return p


def _scan(backend: str):
    if backend == "kernel":
        return ops.mamba_scan
    if backend == "reference":
        return KR.mamba_scan_ref
    raise ValueError(f"unknown backend {backend!r}")


def _mamba1_inner(p: dict, xc: torch.Tensor, z: torch.Tensor,
                  cfg: ModelConfig, backend: str) -> torch.Tensor:
    """xc [B, S, di] post-conv, z the gate -> y [B, S, di], from h_0 = 0."""
    _, dtr, n, _ = mamba1_dims(cfg)
    dt_raw, b_ssm, c_ssm = (xc @ p["x_proj"]).split([dtr, n, n], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    y = _scan(backend)(xc.float().contiguous(), dt.float().contiguous(),
                       b_ssm.float().contiguous(), c_ssm.float().contiguous(),
                       a.contiguous())
    y = y + p["D"] * xc.float()
    y = y * F.silu(z.float())
    return y.to(xc.dtype)


@torch.no_grad()
def mamba1_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                   backend: str = "kernel") -> torch.Tensor:
    """Prefill / teacher-forced forward: x [B, S, D] -> [B, S, D].
    ``backend="kernel"`` scans through K5 (its plain version for CPU
    tensors), ``"reference"`` through ``mamba_scan_ref`` on any device."""
    di, *_ = mamba1_dims(cfg)
    x_in, z = (x @ p["in_proj"]).split(di, dim=-1)
    xc = causal_conv1d(x_in, p["conv_w"], p["conv_b"])
    return _mamba1_inner(p, xc, z, cfg, backend) @ p["out_proj"]


class Mamba1State(NamedTuple):
    conv: torch.Tensor    # [..., W, di]
    h: torch.Tensor       # [..., di, N]


def mamba1_init_state(cfg: ModelConfig, lead: Tuple[int, ...] = (),
                      device: Optional[torch.device] = None) -> Mamba1State:
    """Zero decode state, with leading axes ``lead``."""
    di, _, n, cw = mamba1_dims(cfg)
    return Mamba1State(
        conv=torch.zeros(lead + (cw, di), dtype=torch.float32, device=device),
        h=torch.zeros(lead + (di, n), dtype=torch.float32, device=device))


@torch.no_grad()
def mamba1_decode_step(p: dict, x_t: torch.Tensor, state: Mamba1State,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, Mamba1State]:
    """One token: x_t [..., D] -> (y [..., D], new state); O(1) per token."""
    di, dtr, n, _ = mamba1_dims(cfg)
    x_in, z = (x_t @ p["in_proj"]).split(di, dim=-1)
    conv, xc = conv_step(state.conv, x_in, p["conv_w"], p["conv_b"])
    dt_raw, b_ssm, c_ssm = (xc @ p["x_proj"]).split([dtr, n, n], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt.float()[..., :, None] * a)
    h = da * state.h + (dt * xc).float()[..., :, None] * \
        b_ssm.float()[..., None, :]
    y = torch.einsum("...dn,...n->...d", h, c_ssm.float())
    y = (y + p["D"] * xc) * F.silu(z)
    return y.to(x_t.dtype) @ p["out_proj"], Mamba1State(conv=conv, h=h)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD chunked form)
# ---------------------------------------------------------------------------

# the per-layer mixer parameters, in the reference's order (``norm`` is the
# gated RMSNorm's scale, the reference's ``norm.scale``)
MAMBA2_PARAMS = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                 "norm", "out_proj")


def mamba2_dims(cfg: ModelConfig):
    """(d_inner, heads, head dim, groups, state size N, conv width)."""
    di = cfg.ssm.expand * cfg.d_model
    hp = cfg.ssm.head_dim
    return di, di // hp, hp, cfg.ssm.ngroups, cfg.ssm.state_size, \
        cfg.ssm.conv_width


def mamba2_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Shape of each of one layer's Mamba-2 mixer parameters."""
    d = cfg.d_model
    di, nh, _, g, n, cw = mamba2_dims(cfg)
    conv_dim = di + 2 * g * n
    return {"in_proj": (d, 2 * di + 2 * g * n + nh), "conv_w": (conv_dim, cw),
            "conv_b": (conv_dim,), "A_log": (nh,), "D": (nh,),
            "dt_bias": (nh,), "norm": (di,), "out_proj": (di, d)}


@torch.no_grad()
def mamba2_params_(p: Dict[str, torch.Tensor], gen: torch.Generator,
                   cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Fill Mamba-2 mixer parameters in place with the reference's init
    (``mamba2_params``): truncated-normal fan-in projections (the conv at
    std ``W ** -0.5``), zero conv bias, ``A_log = 0`` (a = -1 per head),
    ``D = 1``, ``dt_bias = -4.6``, a unit norm.  Tensors may carry leading
    (layer) axes."""
    cw = cfg.ssm.conv_width
    dense_init_(p["in_proj"], gen)
    dense_init_(p["conv_w"], gen, scale=cw ** -0.5)
    p["conv_b"].zero_()
    p["A_log"].zero_()
    p["D"].fill_(1.0)
    p["dt_bias"].fill_(-4.6)
    p["norm"].fill_(1.0)
    dense_init_(p["out_proj"], gen)
    return p


def _split_mamba2(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """The input projection's output -> (z, xBC, dt)."""
    di, nh, _, g, n, _ = mamba2_dims(cfg)
    return zxbcdt.split([di, di + 2 * g * n, nh], dim=-1)


def _gated_out(p: dict, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """rmsnorm(y * silu(z)) @ out_proj, in f32 (the reference's default
    eps)."""
    y = y * F.silu(z.float())
    var = (y * y).mean(dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + 1e-5) * p["norm"]) @ p["out_proj"]


@torch.no_grad()
def mamba2_forward(p: dict, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    """Chunked SSD forward: x [B, S, D] -> [B, S, D], from h_0 = 0."""
    di, nh, hp, g, n, _ = mamba2_dims(cfg)
    bsz, s, _ = x.shape
    cs = min(cfg.ssm.chunk_size, s)
    while s % cs:
        cs -= 1
    z, xbc, dt_raw = _split_mamba2(x @ p["in_proj"], cfg)
    xbc = causal_conv1d(xbc, p["conv_w"], p["conv_b"])
    xh, b_ssm, c_ssm = xbc.split([di, g * n, g * n], dim=-1)
    xh = xh.reshape(bsz, s, nh, hp).float()
    rep = nh // g
    bh = b_ssm.reshape(bsz, s, g, n).float().repeat_interleave(rep, dim=2)
    ch = c_ssm.reshape(bsz, s, g, n).float().repeat_interleave(rep, dim=2)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])             # [B, S, nh]
    da = dt * -torch.exp(p["A_log"])
    tri = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    h = x.new_zeros((bsz, nh, hp, n), dtype=torch.float32)
    ys = []
    for c0 in range(0, s, cs):
        xz, bz, cz, dtz = (t[:, c0:c0 + cs] for t in (xh, bh, ch, dt))
        cum = torch.cumsum(da[:, c0:c0 + cs], dim=1)           # [B, cs, nh]
        decay = torch.where(tri, torch.exp(cum[:, :, None] - cum[:, None]),
                            0.0)                               # [B, t, s, nh]
        w = torch.einsum("bthn,bshn->btsh", cz, bz) * decay * dtz[:, None]
        y = torch.einsum("btsh,bshp->bthp", w, xz)
        y = y + torch.einsum("bthn,bhpn->bthp", cz * torch.exp(cum)[..., None],
                             h)
        last = cum[:, -1:]
        sw = torch.exp(last - cum) * dtz                       # [B, cs, nh]
        h = torch.exp(last[:, 0])[:, :, None, None] * h + torch.einsum(
            "bshn,bshp->bhpn", sw[..., None] * bz, xz)
        ys.append(y)
    y = torch.cat(ys, 1) + p["D"][:, None] * xh
    return _gated_out(p, y.reshape(bsz, s, di), z).to(x.dtype)


class Mamba2State(NamedTuple):
    conv: torch.Tensor    # [..., W, di + 2 g N]
    h: torch.Tensor       # [..., nh, hp, N]


def mamba2_init_state(cfg: ModelConfig, lead: Tuple[int, ...] = (),
                      device: Optional[torch.device] = None) -> Mamba2State:
    """Zero decode state, with leading axes ``lead``."""
    di, nh, hp, g, n, cw = mamba2_dims(cfg)
    return Mamba2State(
        conv=torch.zeros(lead + (cw, di + 2 * g * n), dtype=torch.float32,
                         device=device),
        h=torch.zeros(lead + (nh, hp, n), dtype=torch.float32,
                      device=device))


@torch.no_grad()
def mamba2_decode_step(p: dict, x_t: torch.Tensor, state: Mamba2State,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, Mamba2State]:
    """One token: x_t [..., D] -> (y [..., D], new state); O(1) per token."""
    di, nh, hp, g, n, _ = mamba2_dims(cfg)
    z, xbc, dt_raw = _split_mamba2(x_t @ p["in_proj"], cfg)
    conv, xbc = conv_step(state.conv, xbc, p["conv_w"], p["conv_b"])
    xh, b_ssm, c_ssm = xbc.split([di, g * n, g * n], dim=-1)
    lead = x_t.shape[:-1]
    xh = xh.reshape(*lead, nh, hp).float()
    rep = nh // g
    bh = b_ssm.reshape(*lead, g, n).float().repeat_interleave(rep, dim=-2)
    ch = c_ssm.reshape(*lead, g, n).float().repeat_interleave(rep, dim=-2)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])            # [..., nh]
    dec = torch.exp(dt * -torch.exp(p["A_log"]))
    h = dec[..., None, None] * state.h + \
        (dt[..., None] * xh)[..., None] * bh[..., None, :]
    y = torch.einsum("...hn,...hpn->...hp", ch, h) + p["D"][:, None] * xh
    y = _gated_out(p, y.reshape(*lead, di), z)
    return y.to(x_t.dtype), Mamba2State(conv=conv, h=h)
