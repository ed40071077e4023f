"""Meshes and the ranks behind them (ports ``repro/launch/mesh.py``:
``make_production_mesh``, ``mesh_config``, ``make_mesh``,
``parse_mesh_spec`` and ``make_serve_mesh``).

The reference's mesh is a grid of devices in one program; the port's is
one process per rank in a ``torch.distributed`` group.  Serving
(``--mesh model=N``) shards the engine's kv-head axis over N ranks and
sees a :class:`ServeMesh`; training sees a :class:`TrainMesh`: the axis
names and sizes, this rank's coordinates (rank r sits at
``np.unravel_index(r, shape)``, the row-major order of
``jax.make_mesh``'s device grid) and one process group per axis, plus one
over the FSDP axes ``("pod", "data")`` when ``pod`` is present; the
collectives over them are ``distributed/sharding.py``'s.

:func:`run_ranks` spawns the ranks with ``torch.multiprocessing`` and
joins them in a **gloo** group, its rendezvous a file in a fresh
temporary directory (so concurrent runs on one host never collide on a
port).  Rank r runs on ``cuda:(r % device_count)``, or on the CPU when
asked: one card takes every rank, and gloo moves the tensors.  A rank that
fails ends the whole run with its traceback; there is no run with fewer
ranks.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.config import MeshConfig
from repro_torch.device import resolve_device

SERVE_AXIS = "model"


def parse_mesh_spec(spec: str) -> MeshConfig:
    """``--mesh`` string -> MeshConfig: comma-separated ``axis=N`` pairs,
    e.g. ``model=8`` or ``data=2,model=4`` (axis order is spec order)."""
    shape, names = [], []
    for part in spec.split(","):
        name, _, n = part.partition("=")
        name, n = name.strip(), n.strip()
        if not name or not n.isdigit() or int(n) < 1:
            raise ValueError(
                f"bad --mesh entry {part!r}: expected axis=N with N >= 1 "
                f"(e.g. --mesh model=8)")
        names.append(name)
        shape.append(int(n))
    return MeshConfig(shape=tuple(shape), axis_names=tuple(names))


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """One rank's view of a serving mesh: its rank, the number of ranks,
    the process group (None on one rank) and its device."""

    rank: int
    size: int
    group: Any
    device: torch.device
    spec: str = "model=1"


def rank_device(device: Optional[Union[str, torch.device]], rank: int
                ) -> torch.device:
    """Rank ``rank``'s device: the CPU if asked, else
    ``cuda:(rank % device_count)``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def serve_ranks(spec: str) -> int:
    """The ranks a serving ``--mesh`` spec asks for: the size of its
    ``model`` axis.  Refuses a spec without one, as the reference does, and
    one with another axis above 1: such an axis would replicate the
    engine, and the port serves over the model axis only."""
    cfg = parse_mesh_spec(spec)
    if SERVE_AXIS not in cfg.axis_names:
        raise ValueError(
            f"--mesh {spec} has no '{SERVE_AXIS}' axis — serving shards the "
            f"KV-head dim over mesh['{SERVE_AXIS}'] (e.g. --mesh model=8)")
    sizes = dict(zip(cfg.axis_names, cfg.shape))
    other = {a: n for a, n in sizes.items() if a != SERVE_AXIS and n > 1}
    if other:
        raise ValueError(f"--mesh {spec}: the port serves over the "
                         f"'{SERVE_AXIS}' axis only (got {other})")
    return sizes[SERVE_AXIS]


def make_serve_mesh(spec: str, rank: int = 0, device=None) -> ServeMesh:
    """Serving mesh from a ``--mesh`` spec (``model=N`` shards the engine's
    kv-head axis N ways, :func:`serve_ranks`).  N above 1 needs this
    process to be rank ``rank`` of an initialised group of N ranks
    (:func:`run_ranks` makes one)."""
    n = serve_ranks(spec)
    if n == 1:
        return ServeMesh(0, 1, None, rank_device(device, 0), spec)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        raise ValueError(
            f"--mesh {spec} needs {n} ranks but this process group has "
            f"{have} (launch.mesh.run_ranks starts them)")
    if not 0 <= rank < n or rank != dist.get_rank():
        raise ValueError(f"rank {rank} is not this process's rank "
                         f"{dist.get_rank()} of {n}")
    return ServeMesh(rank, n, dist.group.WORLD, rank_device(device, rank),
                     spec)


# ---------------------------------------------------------------------------
# training meshes
# ---------------------------------------------------------------------------

def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    """Single pod: (16, 16), axes (data, model).  Multi-pod: (2, 16, 16),
    axes (pod, data, model)."""
    if multi_pod:
        return MeshConfig(shape=(2, 16, 16),
                          axis_names=("pod", "data", "model"))
    return MeshConfig(shape=(16, 16), axis_names=("data", "model"))


@dataclasses.dataclass(frozen=True, eq=False)
class TrainMesh:
    """One rank's view of a training mesh: the axis names and sizes, this
    rank, its device and the process groups (by axis tuple: ``(group,
    global ranks in block order)``; none on one rank)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    groups: Dict[Tuple[str, ...], Tuple[Any, Tuple[int, ...]]] = \
        dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def coords(self) -> Dict[str, int]:
        return dict(zip(self.axis_names,
                        (int(i) for i in np.unravel_index(self.rank,
                                                          self.shape))))



def _group_keys(cfg: MeshConfig) -> List[Tuple[str, ...]]:
    """The axis tuples a TrainMesh has a group over: each axis, and the
    FSDP axes when ``pod`` is present."""
    keys = [(a,) for a in cfg.axis_names]
    if cfg.multi_pod and "data" in cfg.axis_names:
        keys.append(("pod", "data"))
    return keys


def make_mesh(cfg: MeshConfig, rank: int = 0, device=None) -> TrainMesh:
    """Rank ``rank``'s :class:`TrainMesh` of ``cfg``.  Above one rank this
    process must be rank ``rank`` of an initialised group of
    ``cfg.num_devices`` ranks (:func:`run_ranks` makes one); every rank
    calls this in the same order (it makes the axis groups)."""
    n = cfg.num_devices
    dev = rank_device(device, rank)
    if n == 1:
        return TrainMesh(tuple(cfg.axis_names), tuple(cfg.shape), 0, dev)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        raise ValueError(
            f"the mesh {dict(zip(cfg.axis_names, cfg.shape))} needs {n} "
            f"ranks but this process group has {have} "
            f"(launch.mesh.run_ranks starts them)")
    if not 0 <= rank < n or rank != dist.get_rank():
        raise ValueError(f"rank {rank} is not this process's rank "
                         f"{dist.get_rank()} of {n}")
    grid = np.arange(n).reshape(cfg.shape)
    groups = {}
    for key in _group_keys(cfg):
        axes = [cfg.axis_names.index(a) for a in key]
        if int(np.prod([cfg.shape[i] for i in axes])) == 1:
            continue
        rest = [i for i in range(len(cfg.shape)) if i not in axes]
        # one group per coordinate of the other axes, ranks in block order
        blocks = np.transpose(grid, rest + axes).reshape(
            -1, int(np.prod([cfg.shape[i] for i in axes])))
        for ranks in blocks:
            ranks = tuple(int(r) for r in ranks)
            g = dist.new_group(list(ranks))
            if rank in ranks:
                groups[key] = (g, ranks)
    return TrainMesh(tuple(cfg.axis_names), tuple(cfg.shape), rank, dev,
                     groups)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0,
                         device=None) -> TrainMesh:
    """The (16, 16) mesh, axes (data, model), or with ``multi_pod`` the
    (2, 16, 16) one, axes (pod, data, model): 256 or 512 ranks, which
    must already be joined in a group of that size."""
    cfg = mesh_config(multi_pod=multi_pod)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != cfg.num_devices:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a group of "
            f"{cfg.num_devices} ranks (got {have})")
    return make_mesh(cfg, rank, device)


def _rank_main(fn, rank: int, n: int, init: str, device, threads, args,
               out: str, layout: Optional[MeshConfig]) -> None:
    """One spawned rank: join the gloo group, run ``fn(mesh, *args)`` and
    pickle its result (or its traceback) to ``out``."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group("gloo", init_method=init, world_size=n,
                                rank=rank)
        mesh = make_serve_mesh(f"{SERVE_AXIS}={n}", rank, device) \
            if layout is None else make_mesh(layout, rank, device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        result = fn(mesh, *args)
        with open(out, "wb") as f:
            pickle.dump({"ok": True, "result": result}, f)
    except BaseException:
        with open(out, "wb") as f:
            pickle.dump({"ok": False, "error": traceback.format_exc()}, f)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, n: Union[int, str, MeshConfig], device=None,
              *args, timeout: float = 900.0, threads: Optional[int] = None
              ) -> List[Any]:
    """Run ``fn(mesh, *args)`` on spawned ranks joined in a gloo group;
    returns every rank's result, in rank order.  ``n`` ranks get a
    :class:`ServeMesh` each (``model=n``); a layout (a spec such as
    ``data=2,model=4``, or a MeshConfig) gets as many ranks as it holds,
    each with its :class:`TrainMesh`.  ``fn`` must be importable by name
    (a module-level function).  ``threads`` sets each rank's torch
    intra-op threads (on the CPU by default this process's share out
    among the ranks).  A rank that raises or dies ends every rank and
    raises here with its error; so does ``timeout`` seconds."""
    layout = None
    if not isinstance(n, int):
        layout = n if isinstance(n, MeshConfig) else parse_mesh_spec(n)
        n = layout.num_devices
    if n < 1:
        raise ValueError(f"run_ranks needs n >= 1 (got {n})")
    if rank_device(device, 0).type == "cpu" and threads is None:
        threads = max(1, torch.get_num_threads() // n)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(n)]
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, init, device, threads, args,
                                   outs[r], layout))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.exitcode for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    r = bad[0]
                    err = _load(outs[r]).get("error", "") \
                        if os.path.exists(outs[r]) else ""
                    raise RuntimeError(f"rank {r} of {n} failed (exit code "
                                       f"{codes[r]}):\n{err}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks still running after "
                                       f"{timeout:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        return [_load(o)["result"] for o in outs]


def _load(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)
