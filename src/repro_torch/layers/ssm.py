"""State-space mixers (ports ``repro/layers/ssm.py``): Mamba-1
(falcon-mamba: ``causal_conv1d``, ``conv_step``, ``mamba1_dims``,
``mamba1_params``, ``_mamba1_inner``, ``mamba1_forward``, ``Mamba1State``,
``mamba1_init_state``, ``mamba1_decode_step``) and Mamba-2 (zamba2:
``mamba2_dims``, ``mamba2_params``, ``_split_mamba2``, ``mamba2_forward``,
``Mamba2State``, ``mamba2_init_state``, ``mamba2_decode_step``).

The prefill forward runs its selective scan through K5
(``kernels.ops.mamba_scan``, one launch per layer for the whole batch)
where the reference runs a ``lax.scan``; the ``D`` skip and the
``silu(z)`` gate stay plain torch.  K5 has no backward, so a forward that
takes gradients (the training loss on every device) runs
``backend="reference"``: ``kernels.ref.mamba_scan_ref`` is the
reference's own recurrence, the ``lax.scan`` over chunks of 64 steps,
each chunk checkpointed as the reference's ``jax.checkpoint`` of it.
Decode is one step of the recurrence in plain torch, as in the
reference.  Not ported:
``_mamba1_inner``'s ``h0`` argument and ``h_last`` result (nothing in the
reference uses them: the forward always starts from ``h_0 = 0``).

Mamba-2 has no Pallas kernel in the reference, so it is plain torch here:
the chunked SSD form of ``mamba2_forward`` (a quadratic form inside each
chunk, the state carried between chunks; the chunk shrinks from
``ssm.chunk_size`` until it divides S; f32 as the reference casts; each
chunk checkpointed when autograd records, as the reference's
``jax.checkpoint`` of it) and one step of the recurrence for decode.

Parameters are plain dicts of tensors, in the reference's layout
(``x @ W`` with W ``[in, out]``); the depthwise conv is ``F.conv1d`` with
``groups=C``, as the reference computes it with ``lax.conv`` outside any
kernel (TF32 is off for it on the card: ``device.set_f32_numerics``).

Under the sharded train step's compute split (``distributed/
sharding.py``) :func:`mamba1_forward_split` and
:func:`mamba2_forward_split` run a layer from this rank's blocks of its
weights, split over ``model`` along d_inner: the unit is the block of
d_inner channels that ``out_proj``'s rows name.  ``in_proj`` is a column
product whose blocks do not line up with those channels (its columns are
x | z for Mamba-1, z | x | B | C | dt for Mamba-2), so its output is
regrouped over ``model`` (``sharding.regroup_model``) to the columns each
rank reads.  The Mamba-1 scan (on the plain ``mamba_scan_ref``) and the
Mamba-2 SSD (over the heads this rank's channels touch; a head that a
block cuts is computed whole, then cut) are independent per channel.
Mamba-1's ``x_proj`` row product is summed over ``model`` into the
replicated dt, B and C; Mamba-2's depthwise conv runs where ``conv_w``'s
rows live and its output is regrouped to this rank's x channels and its
heads' B and C groups, and the gated RMSNorm's mean of squares is a sum
over ``model``.  ``out_proj`` is a row product summed over ``model``.
The 1-D weights stay replicated: a rank takes its block
(``split_model``) or its heads (after ``to_model``).  Whole weights run
the plain forward; where d_inner does not divide |model| the split
products' outputs are gathered over ``model`` and every rank runs every
channel.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.kernels import ref as KR
from repro_torch.layers.common import dense_init_, remat

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
                  cfg: ModelConfig, backend: str, mesh=None) -> torch.Tensor:
    """xc [B, S, di] post-conv, z the gate -> y [B, S, di], from h_0 = 0.
    With ``mesh``, xc and z are this rank's channels and ``p`` their
    blocks: the row product by ``x_proj`` is summed over ``model`` into
    the replicated dt, B and C, which feed only this rank's channels."""
    _, dtr, n, _ = mamba1_dims(cfg)
    dbc = xc @ p["x_proj"]
    if mesh is not None:
        dbc = SH.to_model(SH.from_model(dbc, mesh), mesh)
    dt_raw, b_ssm, c_ssm = dbc.split([dtr, n, n], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    y = _scan(backend)(xc.float().contiguous(), dt.float().contiguous(),
                       b_ssm.float().contiguous(), c_ssm.float().contiguous(),
                       a.contiguous())
    y = y + p["D"] * xc.float()
    y = y * F.silu(z.float())
    return y.to(xc.dtype)


def mamba1_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                   backend: str = "kernel") -> torch.Tensor:
    """Prefill / teacher-forced forward: x [B, S, D] -> [B, S, D].
    ``backend="kernel"`` scans through K5 (its plain version for CPU
    tensors), ``"reference"`` through ``mamba_scan_ref`` on any device
    (differentiable: the training scan)."""
    di, *_ = mamba1_dims(cfg)
    x_in, z = (x @ p["in_proj"]).split(di, dim=-1)
    xc = causal_conv1d(x_in, p["conv_w"], p["conv_b"])
    return _mamba1_inner(p, xc, z, cfg, backend) @ p["out_proj"]


def _col_product(x: torch.Tensor, w: torch.Tensor, width: int, mesh
                 ) -> torch.Tensor:
    """x @ w of the replicated x and w [..., cols], this rank's block of
    columns (``to_model`` of x) or all ``width`` of them."""
    return (SH.to_model(x, mesh) if w.shape[-1] < width else x) @ w


def mamba1_forward_split(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh
                         ) -> torch.Tensor:
    """The training forward (``backend="reference"``) of the replicated x
    [B, S, D] from this rank's blocks (see the module docstring); whole
    blocks run :func:`mamba1_forward`."""
    di, *_ = mamba1_dims(cfg)
    bw = p["out_proj"].shape[0]
    if p["in_proj"].shape[-1] == 2 * di and bw == di:
        return mamba1_forward(p, x, cfg, backend="reference")
    u = _col_product(x, p["in_proj"], 2 * di, mesh)
    if bw == di:                        # d_inner whole over model
        x_in, z = SH.gather_model(u, mesh, -1).split(di, dim=-1)
        xc = causal_conv1d(x_in, p["conv_w"], p["conv_b"])
        return _mamba1_inner(p, xc, z, cfg, "reference") @ p["out_proj"]
    c0 = SH.model_index(mesh) * bw
    x_in, z = SH.regroup_model(u, mesh, [(c0, c0 + bw),
                                         (di + c0, di + c0 + bw)],
                               2 * di).split(bw, dim=-1)
    q = {**p, **{k: SH.split_model(p[k], mesh, -1)
                 for k in ("conv_b", "dt_bias", "D")}}
    xc = causal_conv1d(x_in, q["conv_w"], q["conv_b"])
    y = _mamba1_inner(q, xc, z, cfg, "reference", mesh)
    return SH.from_model(y @ p["out_proj"], mesh)


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


def _gated_out(p: dict, y: torch.Tensor, z: torch.Tensor, mesh=None,
               di: int = 0) -> torch.Tensor:
    """rmsnorm(y * silu(z)) @ out_proj, in f32 (the reference's default
    eps).  With ``mesh``, y and z are this rank's ``di``-wide block of
    channels: the mean of squares is a sum over ``model``."""
    y = y * F.silu(z.float())
    if mesh is None:
        var = (y * y).mean(dim=-1, keepdim=True)
    else:
        var = SH.to_model(SH.from_model((y * y).sum(dim=-1, keepdim=True),
                                        mesh), mesh) / di
    return (y * torch.rsqrt(var + 1e-5) * p["norm"]) @ p["out_proj"]


def _ssd_chunk(h, xz, bz, cz, dtz, daz, tri):
    """One SSD chunk from the state h [B, nh, hp, N]: (its y [B, cs, nh,
    hp], the state after it)."""
    cum = torch.cumsum(daz, dim=1)                           # [B, cs, nh]
    decay = torch.where(tri, torch.exp(cum[:, :, None] - cum[:, None]),
                        0.0)                                 # [B, t, s, nh]
    w = torch.einsum("bthn,bshn->btsh", cz, bz) * decay * dtz[:, None]
    y = torch.einsum("btsh,bshp->bthp", w, xz)
    y = y + torch.einsum("bthn,bhpn->bthp", cz * torch.exp(cum)[..., None],
                         h)
    last = cum[:, -1:]
    sw = torch.exp(last - cum) * dtz                         # [B, cs, nh]
    h = torch.exp(last[:, 0])[:, :, None, None] * h + torch.einsum(
        "bshn,bshp->bhpn", sw[..., None] * bz, xz)
    return y, h


def _group_heads(t: torch.Tensor, h0: int, nl: int, rep: int
                 ) -> torch.Tensor:
    """t [B, S, groups, N], the groups from head h0's -> [B, S, nl, N],
    each of heads [h0, h0 + nl) reading its group."""
    if h0 % rep == 0 and t.shape[2] * rep == nl:
        return t.repeat_interleave(rep, dim=2)
    idx = torch.arange(h0, h0 + nl, device=t.device) // rep - h0 // rep
    return t.index_select(2, idx)


def _ssd(p: dict, xh: torch.Tensor, b_ssm: torch.Tensor,
         c_ssm: torch.Tensor, dt_raw: torch.Tensor, cfg: ModelConfig,
         h0: int = 0) -> torch.Tensor:
    """The chunked SSD of heads [h0, h0 + nl) from h_0 = 0, with the D
    skip: xh [B, S, nl·hp], b_ssm / c_ssm [B, S, groups·N] (their groups,
    from head h0's), dt_raw [B, S, nl]; ``p``'s ``A_log``, ``D`` and
    ``dt_bias`` are those heads' -> y [B, S, nl·hp] in f32.  The chunk
    shrinks from ``ssm.chunk_size`` until it divides S."""
    _, nh, hp, g, n, _ = mamba2_dims(cfg)
    bsz, s, nl = dt_raw.shape
    cs = min(cfg.ssm.chunk_size, s)
    while s % cs:
        cs -= 1
    xh = xh.reshape(bsz, s, nl, hp).float()
    bh, ch = (_group_heads(t.reshape(bsz, s, -1, n).float(), h0, nl, nh // g)
              for t in (b_ssm, c_ssm))
    dt = F.softplus(dt_raw.float() + p["dt_bias"])             # [B, S, nl]
    da = dt * -torch.exp(p["A_log"])
    tri = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                device=xh.device))[None, :, :, None]
    h = xh.new_zeros((bsz, nl, hp, n))
    ys = []
    for c0 in range(0, s, cs):
        y, h = remat(_ssd_chunk, h,
                     *(t[:, c0:c0 + cs] for t in (xh, bh, ch, dt, da)), tri)
        ys.append(y)
    y = torch.cat(ys, 1) + p["D"][:, None] * xh
    return y.reshape(bsz, s, nl * hp)


def mamba2_forward(p: dict, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    """Chunked SSD forward: x [B, S, D] -> [B, S, D], from h_0 = 0."""
    di, _, _, g, n, _ = mamba2_dims(cfg)
    z, xbc, dt_raw = _split_mamba2(x @ p["in_proj"], cfg)
    xbc = causal_conv1d(xbc, p["conv_w"], p["conv_b"])
    xh, b_ssm, c_ssm = xbc.split([di, g * n, g * n], dim=-1)
    y = _ssd(p, xh, b_ssm, c_ssm, dt_raw, cfg)
    return _gated_out(p, y, z).to(x.dtype)


def mamba2_forward_split(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh
                         ) -> torch.Tensor:
    """:func:`mamba2_forward` of the replicated x [B, S, D] from this
    rank's blocks (see the module docstring); whole blocks run it as it
    is."""
    di, nh, hp, g, n, _ = mamba2_dims(cfg)
    gn = g * n
    cdim, width = di + 2 * gn, 2 * di + 2 * gn + nh
    bw, cb = p["out_proj"].shape[0], p["conv_w"].shape[0]
    if bw == di and cb == cdim and p["in_proj"].shape[-1] == width:
        return mamba2_forward(p, x, cfg)
    r = SH.model_index(mesh)
    u = _col_product(x, p["in_proj"], width, mesh)
    if bw == di:                        # d_inner whole over model
        if u.shape[-1] < width:
            u = SH.gather_model(u, mesh, -1)
        z, xbc, dt_raw = _split_mamba2(u, cfg)
        if cb < cdim:                   # the conv where its rows live
            xbc = SH.to_model(xbc, mesh).narrow(-1, r * cb, cb)
            xbc = SH.gather_model(causal_conv1d(
                xbc, p["conv_w"], SH.split_model(p["conv_b"], mesh, -1)),
                mesh, -1)
        else:
            xbc = causal_conv1d(xbc, p["conv_w"], p["conv_b"])
        xh, b_ssm, c_ssm = xbc.split([di, gn, gn], dim=-1)
        return _gated_out(p, _ssd(p, xh, b_ssm, c_ssm, dt_raw, cfg),
                          z).to(x.dtype)
    # this rank's channels [c0, c0 + bw), the heads [h0, h1) they touch
    # and those heads' groups [g0, g1), as spans of the conv's output
    c0 = r * bw
    h0, h1 = c0 // hp, -(-(c0 + bw) // hp)
    rep = nh // g
    g0, g1 = h0 // rep, -(-h1 // rep)
    reads = [(h0 * hp, h1 * hp), (di + g0 * n, di + g1 * n),
             (di + gn + g0 * n, di + gn + g1 * n)]
    conv_in = [(r * cb, (r + 1) * cb)] if cb < cdim else reads
    dts = 2 * di + 2 * gn
    parts = SH.regroup_model(
        u, mesh, [(c0, c0 + bw)] + [(di + a, di + b) for a, b in conv_in]
        + [(dts + h0, dts + h1)], width)
    z, xbc, dt_raw = parts.split(
        [bw, sum(b - a for a, b in conv_in), h1 - h0], dim=-1)
    if cb < cdim:                       # the conv where its rows live
        xbc = SH.regroup_model(causal_conv1d(
            xbc, p["conv_w"], SH.split_model(p["conv_b"], mesh, -1)),
            mesh, reads, cdim)
    else:
        rows = torch.cat([torch.arange(a, b, device=x.device)
                          for a, b in reads])
        xbc = causal_conv1d(xbc, SH.to_model(p["conv_w"], mesh)[rows],
                            SH.to_model(p["conv_b"], mesh)[rows])
    xh, b_ssm, c_ssm = xbc.split([b - a for a, b in reads], dim=-1)
    heads = {k: SH.to_model(p[k], mesh)[h0:h1]
             for k in ("A_log", "D", "dt_bias")}
    y = _ssd(heads, xh, b_ssm, c_ssm, dt_raw, cfg, h0)
    y = y.narrow(-1, c0 - h0 * hp, bw)
    out = _gated_out({"norm": SH.split_model(p["norm"], mesh, -1),
                      "out_proj": p["out_proj"]}, y, z, mesh, di)
    return SH.from_model(out, mesh).to(x.dtype)


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
