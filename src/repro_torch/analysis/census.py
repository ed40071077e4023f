"""What one call of an entry point launches, communicates and syncs: the
port's stand-in for ``repro/analysis/jaxpr_audit.py::Census``.

The reference reads a jaxpr; the port runs the call once, under a
``TorchDispatchMode`` and its own counters:

* kernel launches by kernel: the deltas of ``kernels.ops.DISPATCHES``
  (on the card each is a launch, and ``ops.LAUNCHES`` moves with it; on
  the CPU each is a call of the kernel's plain version), and with
  ``trips=True`` the launches inside each trip of a pack (the engine's
  ``_trip``) apart from those outside;
* group commits made (the engine's ``commits`` counter), for the kernels
  a contract pins per commit;
* collectives: every ``c10d`` op the call dispatches, by kind, dtype and
  whether it reduces (whoever calls it), and the
  ``distributed.sharding.COLLECTIVES`` deltas of the serving helpers;
* float64 tensors created (ops whose output is float64), each as
  ``"<op> in <file>:<function>"`` with the code that made it;
* host syncs: ``aten::_local_scalar_dense`` (``.item()``, ``int(t)``,
  ``bool(t)``) and copies from a CUDA tensor to the CPU.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from collections import Counter
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NOT_ORIGINS = (os.path.dirname(os.path.abspath(__file__)) + os.sep,
                os.path.dirname(os.path.abspath(torch.__file__)) + os.sep)

# c10d ops -> (collective kind, reduces)
_C10D = {"allgather_": ("all_gather", False),
         "_allgather_base_": ("all_gather", False),
         "allgather_into_tensor_coalesced_": ("all_gather", False),
         "allreduce_": ("all_reduce", True),
         "allreduce_coalesced_": ("all_reduce", True),
         "reduce_": ("reduce", True),
         "reduce_scatter_": ("reduce_scatter", True),
         "_reduce_scatter_base_": ("reduce_scatter", True),
         "broadcast_": ("broadcast", False),
         "alltoall_": ("all_to_all", False),
         "alltoall_base_": ("all_to_all", False),
         "gather_": ("gather", False),
         "scatter_": ("scatter", False),
         "send": ("send", False),
         "recv_": ("recv", False)}


@dataclasses.dataclass(frozen=True)
class CollectiveUse:
    name: str            # all_gather | all_reduce | ...
    dtype: str
    reduces: bool
    op: str = ""         # the c10d op

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Census:
    """What one call did (see the module docstring)."""

    launches: Dict[str, int]
    device_launches: Dict[str, int]
    trips: int
    per_trip: List[Dict[str, int]]
    commits: int
    collectives: List[CollectiveUse]
    collective_counts: Dict[str, int]
    fp64: List[str]
    host_syncs: Dict[str, int]

    @property
    def launches_per_trip(self) -> Optional[Dict[str, int]]:
        """The launches every trip made, None when trips differ (or there
        were none)."""
        if not self.per_trip or any(t != self.per_trip[0]
                                    for t in self.per_trip):
            return None
        return dict(self.per_trip[0])

    @property
    def launches_outside_trips(self) -> Dict[str, int]:
        inside = Counter()
        for t in self.per_trip:
            inside.update(t)
        return {k: n - inside.get(k, 0) for k, n in self.launches.items()
                if n - inside.get(k, 0)}

    @property
    def host_sync_count(self) -> int:
        return sum(self.host_syncs.values())

    def to_dict(self) -> dict:
        return {"launches": dict(self.launches),
                "device_launches": dict(self.device_launches),
                "trips": self.trips,
                "launches_per_trip": self.launches_per_trip,
                "commits": self.commits,
                "collectives": [c.to_dict() for c in self.collectives],
                "collective_counts": dict(self.collective_counts),
                "fp64": list(self.fp64),
                "host_syncs": dict(self.host_syncs)}


def _first_tensor(x):
    if torch.is_tensor(x):
        return x
    if isinstance(x, (list, tuple)):
        for y in x:
            t = _first_tensor(y)
            if t is not None:
                return t
    return None


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


class _Watch(TorchDispatchMode):
    """Records collectives, float64 outputs and host syncs."""

    def __init__(self):
        super().__init__()
        self.collectives: List[CollectiveUse] = []
        self.fp64: List[str] = []
        self.syncs: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns == "c10d" and name in _C10D:
            kind, reduces = _C10D[name]
            t = _first_tensor(args[1] if name in ("allgather_",) else args)
            self.collectives.append(CollectiveUse(
                kind, str(t.dtype).replace("torch.", "") if t is not None
                else "", reduces, f"c10d.{name}"))
        if name == "_local_scalar_dense":
            self.syncs["_local_scalar_dense"] += 1
        elif name in ("_to_copy", "copy_"):
            src = args[1] if name == "copy_" else args[0]
            dst = args[0] if name == "copy_" else None
            to_cpu = (dst is not None and dst.device.type == "cpu") or (
                dst is None and kwargs.get("device") is not None
                and torch.device(kwargs["device"]).type == "cpu")
            if torch.is_tensor(src) and src.device.type == "cuda" and to_cpu:
                self.syncs["cuda_to_cpu_copy"] += 1
        out = func(*args, **kwargs)
        if any(t.dtype == torch.float64 for t in _tensors(out)):
            self.fp64.append(f"{ns}.{name} in {_origin()}")
        return out


def _origin() -> str:
    """``file:function`` of the innermost caller outside ``analysis/`` and
    outside torch, where a float64 value was made: a port file relative to
    ``src/repro_torch``, any other by its name."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename.startswith(_NOT_ORIGINS):
        f = f.f_back
    if f is None:
        return "?"
    path = f.f_code.co_filename
    rel = os.path.relpath(path, _PKG) if path.startswith(_PKG + os.sep) \
        else os.path.basename(path)
    return f"{rel}:{f.f_code.co_name}"


def fp64_origin(entry: str) -> str:
    """The ``file:function`` of a :attr:`Census.fp64` entry."""
    return entry.partition(" in ")[2]


def _delta(after: dict, before: dict) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] - before.get(k, 0)}


def census_of(fn, *args, engine=None, trips: bool = False) -> Census:
    """Run ``fn(*args)`` once and return its :class:`Census`.  With
    ``engine`` its commits are counted, and with ``trips`` also each of its
    ``_trip`` calls' launches."""
    per_trip: List[Dict[str, int]] = []
    wrapped = trips and engine is not None
    if wrapped:
        prior = engine.__dict__.get("_trip")      # e.g. a RetraceGuard's
        inner = engine._trip

        def trip(*a, **k):
            before = dict(ops.DISPATCHES)
            out = inner(*a, **k)
            per_trip.append(_delta(ops.DISPATCHES, before))
            return out
        engine._trip = trip
    disp0, launch0 = dict(ops.DISPATCHES), dict(ops.LAUNCHES)
    coll0 = dict(SH.COLLECTIVES)
    commits0 = engine.metrics["commits"] if engine is not None else 0
    watch = _Watch()
    try:
        with watch:
            fn(*args)
    finally:
        if wrapped:
            if prior is None:
                del engine._trip
            else:
                engine._trip = prior
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return Census(
        launches=_delta(ops.DISPATCHES, disp0),
        device_launches=_delta(ops.LAUNCHES, launch0),
        trips=len(per_trip), per_trip=per_trip,
        commits=(engine.metrics["commits"] - commits0)
        if engine is not None else 0,
        collectives=watch.collectives,
        collective_counts={f"{k}({d})": n for (k, d), n in
                           _delta(SH.COLLECTIVES, coll0).items()},
        fp64=watch.fp64, host_syncs=dict(watch.syncs))
