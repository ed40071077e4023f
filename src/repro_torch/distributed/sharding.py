"""Sharding rules and the port's collectives (ports
``repro/distributed/sharding.py``).

**The train half** (its lines 25-180 and 285-311): parameters are FSDP
over ``data`` (and ``pod`` when present) on the d_model / reduction dim x
tensor-parallel over ``model`` on the heads / d_ff / experts / vocab dim;
train batches are data-parallel over (``pod``, ``data``); decode caches
shard their sequence axis over ``model``.  Every rule is
divisibility-checked and falls back to replication.  A spec is a plain
tuple with one entry per dim (the reference's ``PartitionSpec``): ``None``,
an axis name, or a tuple of two or more axis names (a tuple of one is its
name, as ``PartitionSpec`` normalises it); the parameter specs are keyed by
the port's parameter names, each rule matching on the reference's path
for that name (``convert.param_paths``).  A mesh is anything with
``axis_names`` and ``shape`` (``launch.mesh.MeshConfig`` or
``TrainMesh``).  A rule that names an axis the mesh lacks raises
``KeyError``, as the reference's ``_fits`` does, so a ``--mesh-shape 2``
run (axes ``data`` only) is refused as the reference's is; a spec that
names such an axis (written by hand) splits nothing along it in
:func:`shard_of`, :func:`unshard` and :func:`block_shape`.

:func:`shard_of` gives a rank its block of a whole tensor and
:func:`unshard` all-gathers the blocks back.  A dim sharded over a tuple
such as ``("pod", "data")`` is cut into |pod|·|data| blocks, block index
``pod_idx·|data| + data_idx`` (major axis first, as ``NamedSharding`` lays
it out); axes a spec does not name replicate.

``constrain`` is a GSPMD layout hint (``with_sharding_constraint``) and
has no PyTorch meaning: it returns its input.  ``set_constraint_mesh``
keeps the reference's role of switching on ``layers/attention.py``'s ring
branch (:func:`constraint_mesh`).

**The serve half** (its lines 215-290): the serving engine shards the
KV-HEAD axis of its paged planes ``[L, NP, BS, H, ...]`` (axis 3) and of
its TBQ buffers ``[R, L, G, H, D]`` (axis 3; one request's ``[L, G, H,
D]``: axis 2) over the mesh's ``model`` axis.  Everything head-agnostic
stays whole and identical on every rank, so every admission, preemption
and COW decision is the same on every rank.  No float reduction crosses
ranks there: a float sum depends on its order, which would break the
bit-identity across rank counts that the engine is held to.

**The collectives.**  The helpers below are the only places the port
calls a ``torch.distributed`` collective (``tests/test_torch_imports.py``
holds this; ``launch/mesh.py`` only sets groups up).  Each counts its
calls into :data:`COLLECTIVES` and the bytes this rank sends into
:data:`COLLECTIVE_BYTES`, both by ``(kind, dtype)``, the way
``kernels/ops.py`` counts ``LAUNCHES``, and the same bytes into
:data:`TRAFFIC` by ``(kind, axis, what)``: the axis label
(:func:`axis_label`: ``"dp"`` for the data-parallel axes, else the axis
names) and what moves (``"param"``, ``"grad"``, ``"act"`` or
``"other"``), which ``launch/dryrun.py`` counts analytically.  Serving
uses :func:`gather_heads` and :func:`any_shard`; training adds movement
(:func:`all_gather`, :func:`broadcast`, :func:`permute`,
:func:`all_to_all`), the sum over ranks (:func:`all_reduce_sum`,
:func:`reduce_scatter_sum`; float sums allowed over the dp axes and over
``model``: :func:`train_collective_whitelist`), the max over ranks
(:func:`all_reduce_max`) and :func:`barrier`.
Gloo takes a CUDA tensor in every one of these but the kinds in
:data:`HOST_STAGED` (send and receive, :func:`permute`'s); that helper
copies the tensor to the host and back, and counts the copy under
``(kind + "_host_staged", dtype)``.

**The model axis's compute split** (Megatron style; ``layers/``,
``models/lm.py``, ``models/losses.py`` under the sharded train step).
Between layers a tensor is replicated over ``model`` and so is its
gradient: every rank holds all of it.  :func:`to_model` marks a
replicated input of a product split over ``model`` (forward: itself;
backward: the sum over ``model`` of the ranks' partial gradients);
:func:`from_model` sums the ranks' partial results into a replicated one
(forward: the sum; backward: itself); :func:`gather_model` concatenates
the ranks' blocks of an activation whose gradient is replicated
(backward: this rank's block of the gradient); :func:`regroup_model`
moves columns of an activation split over ``model`` to the ranks that
read them, each rank reading its own (backward: the ranks' gradients of
the columns summed back to the rank that computed them); and
:func:`split_model` cuts a replicated tensor into this rank's block
(backward: the blocks' gradients gathered).
:func:`gather_dp` gathers a parameter block over the dp axes just before
its layer runs (backward: the mean over dp of the gradient, reduced and
scattered back to this rank's block).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]

# pytree path substrings marking stacked-per-layer parameter groups
_STACKED_MARKERS = ("layers", "encoder", "decoder")

SERVE_HEAD_AXIS = "model"          # mesh axis the kv-head dim shards over
PLANE_HEAD_DIM = 3                 # [L, NP, BS, H, ...]
BUF_HEAD_DIM = 2                   # one request's TBQ buffer [L, G, H, D]

# The engine's collective contract (the reference's names: its integer
# ``psum`` is an ``all_reduce`` here).  ``analysis.contracts`` turns it into
# the CollectiveRule every engine entry point is audited against.
SERVE_MOVEMENT_COLLECTIVES = ("all_gather",)
SERVE_INTEGER_REDUCTIONS = ("all_reduce",)
SERVE_FLOAT_REDUCTIONS: tuple = ()

# The train step's: the same movement plus broadcast, point-to-point and
# all-to-all, and float sums over the data-parallel axes (the gradient
# mean, the MoE auxiliary loss's global means, the loss-mask count) and
# over ``model`` (the split products' partial sums, the vocab-parallel
# embedding and cross entropy, the gradient norm; the cross entropy's row
# max is a max over ``model``).
TRAIN_MOVEMENT_COLLECTIVES = ("all_gather", "broadcast", "send", "recv",
                              "all_to_all")
TRAIN_INTEGER_REDUCTIONS = ("all_reduce",)
TRAIN_FLOAT_REDUCTIONS = ("all_reduce", "reduce_scatter")
DP_AXIS = "dp"                     # the label of the dp axes (dp_axes)
MODEL_AXIS = "model"
TRAIN_FLOAT_REDUCTION_AXES = (DP_AXIS, MODEL_AXIS)

# Kinds gloo cannot take on a CUDA tensor; their helpers stage through the
# host.  Gloo's send and receive pass the tensor's address to its TCP
# transport as host memory ("writev ... Bad address" on an H100), so the
# point-to-point permute stages.  Its all-gather, all-reduce, broadcast
# and single-tensor all-to-all take card tensors (its list all-to-all
# exists on neither device).  tests/test_torch_cuda.py::test_gloo_* hold
# every helper on card tensors and probe the raw collectives there.
HOST_STAGED = frozenset({"send"})

COLLECTIVES: Dict[Tuple[str, str], int] = {}
COLLECTIVE_BYTES: Dict[Tuple[str, str], int] = {}
TRAFFIC: Dict[Tuple[str, str, str], int] = {}
# the axis label of the collective now running (analysis.census reads it)
_AXIS_NOW: list = [""]


def reset_collectives() -> None:
    COLLECTIVES.clear()
    COLLECTIVE_BYTES.clear()
    TRAFFIC.clear()


def collective_axis() -> str:
    """The axis label of the collective a helper is running."""
    return _AXIS_NOW[0]


def _count(kind: str, x: Optional[torch.Tensor] = None, axis: str = "",
           what: str = "other") -> None:
    """One call of ``kind`` moving ``x`` (nothing for a barrier) over the
    axes labelled ``axis``."""
    key = (kind, "" if x is None else str(x.dtype).replace("torch.", ""))
    n = 0 if x is None else x.numel() * x.element_size()
    COLLECTIVES[key] = COLLECTIVES.get(key, 0) + 1
    COLLECTIVE_BYTES[key] = COLLECTIVE_BYTES.get(key, 0) + n
    tkey = (kind, axis, what)
    TRAFFIC[tkey] = TRAFFIC.get(tkey, 0) + n
    _AXIS_NOW[0] = ""                   # a collective no helper runs: none


def _staged(kind: str, x: torch.Tensor, axis: str) -> bool:
    """Does ``kind`` go through the host for ``x``?  Counts it if so."""
    if x.device.type != "cuda" or kind not in HOST_STAGED:
        return False
    _count(kind + "_host_staged", x, axis)
    return True


# ---------------------------------------------------------------------------
# axes and the train-side specs
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_axes(mesh) -> Tuple[str, ...]:
    return fsdp_axes(mesh)


def _as_tuple(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return axes if isinstance(axes, tuple) else (axes,)


def axes_size(mesh, axes: Axes) -> int:
    """The number of blocks ``axes`` cut a dim into; an axis the mesh
    lacks raises ``KeyError`` (the reference's ``_fits``)."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _as_tuple(axes))


def _entry(axes: Axes) -> Axes:
    """A spec entry as ``PartitionSpec`` keeps it: a tuple of one axis is
    that axis."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def _fits(dim: int, mesh, axes: Axes) -> bool:
    if axes is None:
        return True
    size = axes_size(mesh, axes)
    return dim % size == 0 and dim >= size


def _spec_for(path: str, shape: Sequence[int], mesh, stacked: bool) -> Spec:
    fsdp = fsdp_axes(mesh)
    dims = list(shape[1:]) if stacked else list(shape)

    def build(*axes) -> Spec:
        """divisibility-checked spec over ``dims``; None-pad to rank."""
        out = [_entry(ax) if _fits(dim, mesh, ax) else None
               for dim, ax in zip(dims, list(axes)
                                  + [None] * (len(dims) - len(axes)))]
        return tuple(([None] if stacked else []) + out)

    name = path.lower()
    if len(dims) == 0:
        return ()
    if len(dims) == 1:
        return build(None)

    # --- embeddings: [V, D] vocab on model, d on fsdp
    if "embedding" in name:
        return build("model", fsdp)
    if "lm_head" in name:
        return build(fsdp, "model")
    if "enc_pos" in name or "dec_pos" in name:
        return build(None, fsdp)

    # --- MoE experts [E, D, F]: EP over model when divisible, else TP on F
    if any(k in name for k in ("w_up", "w_gate")) and len(dims) == 3:
        if _fits(dims[0], mesh, "model"):
            return build("model", fsdp, None)
        return build(None, fsdp, "model")
    if "w_down" in name and len(dims) == 3:
        if _fits(dims[0], mesh, "model"):
            return build("model", None, fsdp)
        return build(None, "model", fsdp)
    if "router" in name:
        return build(fsdp, None)

    # --- attention
    if "wq" in name or "wk" in name or "wv" in name:
        return build(fsdp, "model")
    if "wo" in name:
        return build("model", fsdp)

    # --- dense mlp [D, F] / [F, D]
    if "w_up" in name or "w_gate" in name:
        return build(fsdp, "model")
    if "w_down" in name:
        return build("model", fsdp)

    # --- mamba: TP over d_inner
    if "in_proj" in name:
        return build(fsdp, "model")
    if "out_proj" in name:
        return build("model", fsdp)
    if "conv_w" in name:
        return build("model", None)
    if "x_proj" in name:
        return build("model", None)
    if "dt_proj" in name:
        return build(None, "model")
    if "a_log" in name:
        return build("model", None)

    # default: FSDP the first dim
    return build(fsdp)


def param_specs(params, mesh, *, mode: str = "train") -> Dict[str, Spec]:
    """The spec of each parameter by the port's name.  ``params`` is a
    model of ``models/`` (it has ``cfg``) or a ``ModelConfig``.

    mode="train": FSDP(data) x TP(model).  mode="serve": TP(model) only,
    replicated over the FSDP axes (a decode step would re-gather every
    weight for every token)."""
    from repro_torch.convert import param_paths, param_shapes
    cfg = getattr(params, "cfg", params)
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve' (got {mode!r})")
    shapes = param_shapes(cfg)
    drop = set(fsdp_axes(mesh))
    out = {}
    for name, path in param_paths(cfg).items():
        pstr = "/".join(path)
        shape = shapes[name]
        stacked = any(m in pstr for m in _STACKED_MARKERS) and len(shape) >= 1
        spec = _spec_for(pstr, shape, mesh, stacked)
        if mode == "serve":
            spec = tuple(None if (ax in drop or (isinstance(ax, tuple)
                                                 and set(ax) & drop)) else ax
                         for ax in spec)
        out[name] = spec
    return out


def train_batch_specs(batch: Mapping, mesh) -> Dict[str, Spec]:
    """tokens / targets [B, S] -> (dp, None); frontend features likewise;
    a batch axis that dp does not divide replicates."""
    dp = dp_axes(mesh)

    def one(leaf) -> Spec:
        if leaf.ndim == 0:
            return ()
        if _fits(leaf.shape[0], mesh, dp):
            return (_entry(dp),) + (None,) * (leaf.ndim - 1)
        return (None,) * leaf.ndim

    return {k: one(v) for k, v in batch.items()}


def decode_batch_specs(batch: Mapping, mesh) -> Dict[str, Spec]:
    """Decode-state sharding: batch over dp when divisible; cache and pool
    sequence axes over ``model`` (and over dp too when the batch cannot
    shard)."""
    dp = dp_axes(mesh)
    # names whose axis 2 is the sequence/slot axis ([B, L, T/NS, ...])
    seq_axis2 = ("k_cache", "v_cache", "k_codes", "v_codes", "k_scales",
                 "v_scales", "slot_state", "slot_bits", "cross_k", "cross_v")

    def one(name: str, leaf) -> Spec:
        name = name.lower()
        spec: list = [None] * leaf.ndim
        batch_sharded = leaf.ndim >= 1 and _fits(leaf.shape[0], mesh, dp)
        if batch_sharded:
            spec[0] = _entry(dp)
        if any(s in name for s in seq_axis2) and leaf.ndim >= 3:
            seq_ax = ("model",) if batch_sharded else (dp + ("model",)) \
                if _fits(leaf.shape[2], mesh, dp + ("model",)) else ("model",)
            if _fits(leaf.shape[2], mesh, seq_ax):
                spec[2] = seq_ax if len(seq_ax) > 1 else seq_ax[0]
        return tuple(spec)

    return {k: one(k, v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """A leaf's layout: its spec on a mesh (the reference's
    ``NamedSharding``)."""

    spec: Spec
    mesh: object


def live_axes(mesh, axes: Axes) -> Tuple[str, ...]:
    """The axes of ``axes`` that split: present in the mesh, size > 1."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in _as_tuple(axes) if sizes.get(a, 1) > 1)


def block_index(mesh, axes: Axes) -> int:
    """This rank's block along ``axes``: its coordinates read as a mixed
    radix number, major axis first."""
    sizes, idx = axis_sizes(mesh), 0
    for a in live_axes(mesh, axes):
        idx = idx * sizes[a] + mesh.coords[a]
    return idx


def shard_of(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (a view;
    dims past the spec replicate)."""
    for dim, axes in enumerate(spec):
        n = axes_size(mesh, live_axes(mesh, axes))
        if n > 1:
            step = x.shape[dim] // n
            x = x.narrow(dim, block_index(mesh, axes) * step, step)
    return x


def unshard(block: torch.Tensor, spec: Spec, mesh,
            what: str = "other") -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec``: one
    all-gather per sharded dim, over that dim's axes."""
    for dim, axes in enumerate(spec):
        if live_axes(mesh, axes):
            block = all_gather(block, mesh, axes, dim, what)
    return block


def copies(spec: Spec, mesh) -> int:
    """How many ranks hold each block under ``spec`` (the mesh's size over
    the blocks it cuts)."""
    return math.prod(mesh.shape) // axes_size(
        mesh, tuple(a for e in spec for a in live_axes(mesh, e)))


def block_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    out = list(shape)
    for dim, axes in enumerate(spec):
        out[dim] //= axes_size(mesh, live_axes(mesh, axes))
    return tuple(out)


# ---------------------------------------------------------------------------
# in-graph sharding constraints: no PyTorch meaning; the mesh gates ring
# attention
# ---------------------------------------------------------------------------

_CONSTRAINT_MESH: list = [None]


def set_constraint_mesh(mesh) -> None:
    """Install the mesh ``layers/attention.py``'s ring branch reads (the
    launchers' role in the reference); None removes it."""
    _CONSTRAINT_MESH[0] = mesh


def constraint_mesh():
    return _CONSTRAINT_MESH[0]


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` hint: GSPMD's layout
    guidance, which has no PyTorch meaning.  Returns ``x``."""
    return x


# ---------------------------------------------------------------------------
# the data-parallel context of a sharded train step
# ---------------------------------------------------------------------------

_DATA_PARALLEL: list = [None]


@contextlib.contextmanager
def data_parallel(mesh):
    """While active, ``layers/moe.py`` routes this rank's block of a batch
    split over ``dp_axes(mesh)`` as one device routes the whole batch (the
    sharded train step installs it around the loss)."""
    prev = _DATA_PARALLEL[0]
    _DATA_PARALLEL[0] = mesh
    try:
        yield
    finally:
        _DATA_PARALLEL[0] = prev


def active_data_parallel():
    """The mesh of an active :func:`data_parallel` whose dp axes split,
    else None."""
    mesh = _DATA_PARALLEL[0]
    if mesh is None or not live_axes(mesh, dp_axes(mesh)):
        return None
    return mesh


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def head_shardable(num_kv_heads: int, n: int) -> bool:
    """Can the serving engine shard ``num_kv_heads`` over ``n`` ranks?"""
    return num_kv_heads % n == 0 and num_kv_heads >= n


def serve_collective_whitelist() -> dict:
    """{"movement", "integer_reductions", "float_reductions"}: the
    collectives the serving engine's entry points may run."""
    return {"movement": SERVE_MOVEMENT_COLLECTIVES,
            "integer_reductions": SERVE_INTEGER_REDUCTIONS,
            "float_reductions": SERVE_FLOAT_REDUCTIONS}


def train_collective_whitelist() -> dict:
    """The same for the train step: float sums (and the cross entropy's
    max) over the dp axes and over ``model``."""
    return {"movement": TRAIN_MOVEMENT_COLLECTIVES,
            "integer_reductions": TRAIN_INTEGER_REDUCTIONS,
            "float_reductions": TRAIN_FLOAT_REDUCTIONS,
            "float_reduction_axes": TRAIN_FLOAT_REDUCTION_AXES}


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def gather_heads(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's slice of a head axis, concatenated in rank order along
    ``dim`` (a no-op without a mesh or on one rank, so the one-rank path
    runs no collective)."""
    if not _sharded(mesh):
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    _AXIS_NOW[0] = SERVE_HEAD_AXIS
    dist.all_gather(parts, x, group=mesh.group)
    _count("all_gather", x, SERVE_HEAD_AXIS, "act")
    return torch.cat(parts, dim)


def any_shard(mask: torch.Tensor, mesh) -> torch.Tensor:
    """The OR over ranks of a boolean mask: an int32 sum, then ``> 0``."""
    if not _sharded(mesh):
        return mask
    n = mask.to(torch.int32)
    _AXIS_NOW[0] = SERVE_HEAD_AXIS
    dist.all_reduce(n, op=dist.ReduceOp.SUM, group=mesh.group)
    _count("all_reduce", n, SERVE_HEAD_AXIS)
    return n > 0


# ---------------------------------------------------------------------------
# training: collectives over the axes of a TrainMesh
# ---------------------------------------------------------------------------

def axis_label(mesh, axes: Axes) -> str:
    """``"dp"`` for the live dp axes, else the live axes joined by ``+``
    (``"model"``): the axis key of :data:`TRAFFIC` and of the census."""
    live = live_axes(mesh, axes)
    if live and set(live) == set(live_axes(mesh, dp_axes(mesh))):
        return DP_AXIS
    return "+".join(live)


def axis_group(mesh, axes: Axes):
    """(process group, its global ranks in group order, this rank's index)
    of ``axes`` on ``mesh``, or None where they do not split.  Marks
    ``axes`` as the axis of the collective about to run."""
    live = live_axes(mesh, axes)
    if not live:
        return None
    if live not in mesh.groups:
        raise KeyError(f"the mesh {dict(axis_sizes(mesh))} has no group over "
                       f"{live} (launch.mesh.make_mesh makes one per axis and "
                       f"one for the FSDP axes)")
    _AXIS_NOW[0] = axis_label(mesh, live)
    group, ranks = mesh.groups[live]
    return group, ranks, block_index(mesh, live)


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int = 0,
               what: str = "other") -> torch.Tensor:
    """Every rank's ``x`` along ``axes``, concatenated along ``dim`` in
    block order (pure movement)."""
    g = axis_group(mesh, axes)
    if g is None:
        return x
    group, ranks, _ = g
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in ranks]
    dist.all_gather(parts, x, group=group)
    _count("all_gather", x, axis_label(mesh, axes), what)
    return torch.cat(parts, dim)


def all_reduce_sum_(x: torch.Tensor, mesh, axes: Axes,
                    what: str = "other") -> torch.Tensor:
    """Sum the contiguous ``x`` over the ranks along ``axes``, in place;
    returns ``x``."""
    g = axis_group(mesh, axes)
    if g is None:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g[0])
    _count("all_reduce", x, axis_label(mesh, axes), what)
    return x


def all_reduce_sum(x: torch.Tensor, mesh, axes: Axes,
                   what: str = "other") -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axes`` (a new tensor)."""
    if axis_group(mesh, axes) is None:
        return x
    return all_reduce_sum_(x.detach().clone().contiguous(), mesh, axes, what)


def all_reduce_max(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The elementwise max of the activation ``x`` over the ranks along
    ``axes`` (a new tensor, outside autograd)."""
    g = axis_group(mesh, axes)
    if g is None:
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g[0])
    _count("all_reduce", out, axis_label(mesh, axes), "act")
    return out


def reduce_scatter_sum(x: torch.Tensor, mesh, axes: Axes, dim: int = 0,
                       what: str = "other") -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the ranks
    along ``axes`` (a new tensor; gloo's reduce-scatter, which takes CPU
    and card tensors)."""
    g = axis_group(mesh, axes)
    if g is None:
        return x
    group, ranks, _ = g
    xt = x.detach().movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // len(ranks), *xt.shape[1:]))
    with warnings.catch_warnings():     # renamed in later torch releases
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM,
                                   group=group)
    _count("reduce_scatter", xt, axis_label(mesh, axes), what)
    return out.movedim(0, dim)


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum over ranks.  Backward: the same sum of the
    upstream gradients, so that after the train step's mean over dp each
    rank's share of a global quantity gets the global gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce_sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh, ctx.axes), None, None


def sum_over_ranks(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """:func:`all_reduce_sum` that autograd differentiates (see
    :class:`_SumOverRanks`)."""
    if axis_group(mesh, axes) is None:
        return x
    return _SumOverRanks.apply(x, mesh, axes)


def broadcast(x: torch.Tensor, mesh, axes: Axes, src: int) -> torch.Tensor:
    """Block ``src``'s ``x`` on every rank along ``axes`` (a new tensor)."""
    g = axis_group(mesh, axes)
    if g is None:
        return x
    group, ranks, _ = g
    out = x.detach().clone().contiguous()
    dist.broadcast(out, src=ranks[src], group=group)
    _count("broadcast", out, axis_label(mesh, axes))
    return out


def permute(x: torch.Tensor, mesh, axes: Axes, shift: int) -> torch.Tensor:
    """The reference's ``ppermute`` over a ring: block i sends ``x`` to
    block ``(i + shift) % n`` and returns what block ``(i - shift) % n``
    sent (a send and a receive per rank)."""
    g = axis_group(mesh, axes)
    if g is None:
        return x
    group, ranks, i = g
    n = len(ranks)
    if shift % n == 0:
        return x
    label = axis_label(mesh, axes)
    x = x.contiguous()
    staged = _staged("send", x, label)
    src = x.cpu() if staged else x
    out = torch.empty_like(src)
    req = dist.isend(src, ranks[(i + shift) % n], group=group)
    dist.recv(out, ranks[(i - shift) % n], group=group)
    req.wait()
    _count("send", x, label)
    _count("recv", out, label)
    return out.to(x.device)


class _Permute(torch.autograd.Function):
    """:func:`permute` whose backward is the inverse permute."""

    @staticmethod
    def forward(ctx, x, mesh, axes, shift):
        ctx.mesh, ctx.axes, ctx.shift = mesh, axes, shift
        return permute(x, mesh, axes, shift)

    @staticmethod
    def backward(ctx, g):
        return permute(g, ctx.mesh, ctx.axes, -ctx.shift), None, None, None


def permute_grad(x: torch.Tensor, mesh, axes: Axes, shift: int
                 ) -> torch.Tensor:
    """:func:`permute` that autograd differentiates."""
    return _Permute.apply(x, mesh, axes, shift)


def all_to_all(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """x [n, ...] over the n ranks along ``axes``: out[j] is rank j's
    x[i] on rank i (the reference's untiled ``all_to_all`` on axis 0)."""
    g = axis_group(mesh, axes)
    if g is None:
        return x
    group, ranks, _ = g
    if x.shape[0] != len(ranks):
        raise ValueError(f"all_to_all over {len(ranks)} ranks needs a "
                         f"leading axis of {len(ranks)} (got {x.shape[0]})")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    _count("all_to_all", x, axis_label(mesh, axes))
    return out


def barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for the others."""
    if _sharded(mesh):
        _AXIS_NOW[0] = ""
        dist.barrier()
        _count("barrier")


# ---------------------------------------------------------------------------
# training: the model axis's compute split (see the module docstring)
# ---------------------------------------------------------------------------

def model_size(mesh) -> int:
    """The number of ranks along ``model`` (1 if the mesh lacks it)."""
    return axes_size(mesh, live_axes(mesh, MODEL_AXIS))


def model_index(mesh) -> int:
    return block_index(mesh, MODEL_AXIS)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.contiguous().clone(), ctx.mesh, MODEL_AXIS,
                               "act"), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x, mesh, MODEL_AXIS, "act")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return all_gather(x, mesh, MODEL_AXIS, dim, "act")

    @staticmethod
    def backward(ctx, g):
        i = model_index(ctx.mesh)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


class _SplitModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n = x.shape[dim] // model_size(mesh)
        return x.narrow(dim, model_index(mesh) * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, MODEL_AXIS, ctx.dim, "act"), \
            None, None


class _Regroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, spans):
        ctx.mesh, ctx.dim, ctx.spans, ctx.n = mesh, dim, spans, x.shape[dim]
        whole = all_gather(x, mesh, MODEL_AXIS, dim, "act")
        return torch.cat([whole.narrow(dim, a, b - a) for a, b in spans], dim)

    @staticmethod
    def backward(ctx, g):
        shape = list(g.shape)
        shape[ctx.dim] = ctx.n * model_size(ctx.mesh)
        whole, at = g.new_zeros(shape), 0
        for a, b in ctx.spans:
            whole.narrow(ctx.dim, a, b - a).add_(g.narrow(ctx.dim, at, b - a))
            at += b - a
        return reduce_scatter_sum(whole, ctx.mesh, MODEL_AXIS, ctx.dim,
                                  "act"), None, None, None


def regroup_model(x: torch.Tensor, mesh, spans: Sequence[Tuple[int, int]],
                  width: int, dim: int = -1) -> torch.Tensor:
    """The columns ``spans`` (``[start, stop)`` ranges of an activation
    ``width`` wide along ``dim``, in order) concatenated, on this rank,
    from ``x``: this rank's block of the activation over ``model``
    (columns ``[r·w, (r+1)·w)``), or all of it, replicated.  A block: its
    blocks gathered over ``model``, and backward the transpose, every
    rank's gradient of the columns it read summed over ``model`` and
    reduce-scattered to the rank that computed them (ranks that read the
    same columns add up).  Whole: ``to_model`` of ``x`` (each rank reads
    its part), then the spans."""
    dim %= x.dim()
    if x.shape[dim] == width:
        x = to_model(x, mesh)
        return torch.cat([x.narrow(dim, a, b - a) for a, b in spans], dim)
    return _Regroup.apply(x, mesh, dim, tuple(spans))


def to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """A replicated input of products split over ``model``: forward
    itself, backward the sum over ``model`` of the partial gradients."""
    if model_size(mesh) == 1:
        return x
    return _ToModel.apply(x, mesh)


def from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ``model`` of the ranks' partial results (backward:
    the replicated gradient itself)."""
    if model_size(mesh) == 1:
        return x
    return _FromModel.apply(x, mesh)


def gather_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim``, concatenated (backward:
    this rank's block of the replicated gradient)."""
    if model_size(mesh) == 1:
        return x
    return _GatherModel.apply(x, mesh, dim % x.dim())


def split_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's block of the replicated ``x`` along ``dim`` (backward:
    every rank's block of the gradient, gathered)."""
    if model_size(mesh) == 1:
        return x
    return _SplitModel.apply(x, mesh, dim % x.dim())


def dp_dim(spec: Spec, mesh, stacked: bool = False) -> Optional[int]:
    """The dim of a parameter (of one layer's slice when ``stacked``) that
    ``spec`` splits over the dp axes, or None."""
    dp = set(live_axes(mesh, dp_axes(mesh)))
    for dim, axes in enumerate(spec):
        live = live_axes(mesh, axes)
        if live and set(live) <= dp:
            return dim - 1 if stacked else dim
    return None


class _GatherDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh, dp_axes(mesh), dim, "param")

    @staticmethod
    def backward(ctx, g):
        axes = dp_axes(ctx.mesh)
        out = reduce_scatter_sum(g, ctx.mesh, axes, ctx.dim, "grad")
        return out.div_(axes_size(ctx.mesh, live_axes(ctx.mesh, axes))), \
            None, None


def gather_dp(x: torch.Tensor, mesh, dim: Optional[int]) -> torch.Tensor:
    """A parameter block gathered over the dp axes along ``dim`` (None:
    not split over dp, returned as it is).  Backward: the mean over the
    dp ranks of the gathered gradient, reduce-scattered to this rank's
    block."""
    if dim is None or not live_axes(mesh, dp_axes(mesh)):
        return x
    return _GatherDP.apply(x, mesh, dim)
