"""Serving meshes and the ranks behind them (ports ``repro/launch/mesh.py``:
``parse_mesh_spec`` and ``make_serve_mesh``, lines 35-71).

The reference's mesh is a grid of devices in one program; the port's is
one process per rank in a ``torch.distributed`` group.  ``--mesh
model=N`` shards the serving engine's kv-head axis over N ranks
(``distributed/sharding.py``).  :func:`run_ranks` spawns the N ranks with
``torch.multiprocessing`` and joins them in a **gloo** group, its
rendezvous a file in a fresh temporary directory (so concurrent runs on
one host never collide on a port).  Rank r runs on ``cuda:(r %
device_count)``, or on the CPU when asked: one card takes every rank, and
gloo moves the tensors.  A rank that fails ends the whole run with its
traceback; there is no run with fewer ranks.

``make_production_mesh`` and ``mesh_config`` (the train-side meshes)
belong to ROADMAP queue 1 item 16.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

SERVE_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """A mesh's shape and axis names, as the reference's ``MeshConfig``."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


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


def _rank_main(fn, rank: int, n: int, init: str, device, threads, args,
               out: str) -> None:
    """One spawned rank: join the gloo group, run ``fn(mesh, *args)`` and
    pickle its result (or its traceback) to ``out``."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group("gloo", init_method=init, world_size=n,
                                rank=rank)
        mesh = make_serve_mesh(f"{SERVE_AXIS}={n}", rank, device)
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


def run_ranks(fn: Callable, n: int, device=None, *args,
              timeout: float = 900.0, threads: Optional[int] = None
              ) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``n`` spawned ranks joined in a gloo
    group; returns every rank's result, in rank order.  ``fn`` must be
    importable by name (a module-level function).  ``threads`` sets each
    rank's torch intra-op threads (on the CPU by default this process's
    share out among the ranks).  A rank that raises or dies ends every
    rank and raises here with its error; so does ``timeout`` seconds."""
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
                                   outs[r]))
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
