"""Runtime half of the entry-point checks (ports
``repro/analysis/retrace.py``).

The reference's :class:`RetraceGuard` proves steady-state serving never
recompiles.  The port has no run-time recompile: shapes never reach a
compiler.  What it builds at run time is its CUDA kernel libraries, which
``kernels/build.py`` builds or loads once per process, at the first kernel
use, and counts in ``build.BUILDS``.  The guard wraps the engine's entry
points, samples that counter around every call, and attributes a build to
the entry point and the call index that caused it.  So it catches one
thing: a process whose first kernel launch comes after ``mark_steady()``,
that is a kernel reached for the first time on the hot path.  On the CPU
no library is built (``BUILDS`` stays 0) and the guard checks nothing but
its own bookkeeping; on the card a fresh process shows the counter at 1
after warmup and unchanged after the steady phase
(``tests/test_torch_cuda.py``).

Host syncs per dispatch are reported by ``analysis.census`` (the audit),
not raised here.  :func:`no_implicit_transfers` wraps
``torch.cuda.set_sync_debug_mode("error")`` on the card, so a synchronizing
CUDA call inside the block raises; on the CPU it has no effect (device
memory is host memory), as the reference's guard has none there.

Installed on an engine, the guard's events reach the orchestrator's log as
``kind="retrace"`` (``Orchestrator._drain_retrace_events``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Dict, List

import torch

from repro_torch.kernels import build

#: The engine's entry points the guard wraps (the reference's
#: ``_tick`` / ``_megatick`` / ``_prefill_chunk`` / ``_prefill_big`` /
#: ``_reset_slot``).
ENTRY_POINTS = ("_trip", "_pack", "_prefill_chunk", "_prefill_big",
                "_release_slot")


class RetraceViolation(AssertionError):
    """A steady-state build, raised by ``assert_steady_state``."""


@dataclasses.dataclass(frozen=True)
class RetraceEvent:
    entry: str
    call_index: int     # 1-based call count of that entry point
    steady: bool        # fired after mark_steady()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class RetraceGuard:
    """Wraps an engine's entry points with the build counter.  Use as a
    context manager or ``install()`` / ``uninstall()``; a steady-state
    build fails :meth:`assert_steady_state`."""

    def __init__(self, engine):
        self.engine = engine
        self.calls: Counter = Counter()
        self.retraces: Counter = Counter()
        self.events: List[RetraceEvent] = []
        self.steady = False
        self._originals: Dict[str, object] = {}
        self._drained = 0

    # -- lifecycle ----------------------------------------------------

    def install(self) -> "RetraceGuard":
        if self._originals:
            raise RuntimeError("guard already installed")
        for name in ENTRY_POINTS:
            self._originals[name] = self.engine.__dict__.get(name)
            setattr(self.engine, name,
                    self._wrap(name, getattr(self.engine, name)))
        self.engine._retrace_guard = self
        return self

    def uninstall(self) -> None:
        for name, fn in self._originals.items():
            if fn is None:
                delattr(self.engine, name)
            else:
                setattr(self.engine, name, fn)
        self._originals.clear()
        if getattr(self.engine, "_retrace_guard", None) is self:
            self.engine._retrace_guard = None

    def __enter__(self) -> "RetraceGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- wrapping -----------------------------------------------------

    def _wrap(self, name: str, fn):
        guard = self

        def wrapped(*args, **kwargs):
            before = build.BUILDS
            out = fn(*args, **kwargs)
            guard.calls[name] += 1
            if build.BUILDS > before:
                guard.retraces[name] += 1
                guard.events.append(
                    RetraceEvent(name, guard.calls[name], guard.steady))
            return out

        wrapped.__name__ = f"guarded{name}"
        wrapped.__wrapped__ = fn
        return wrapped

    # -- state / reporting --------------------------------------------

    def mark_steady(self) -> None:
        """Declare warmup over: every build from here on is a violation."""
        self.steady = True

    def steady_retraces(self) -> int:
        return sum(1 for e in self.events if e.steady)

    def drain_new_events(self) -> List[RetraceEvent]:
        """Events appended since the last drain (orchestrator logging)."""
        new = self.events[self._drained:]
        self._drained = len(self.events)
        return new

    def assert_steady_state(self) -> None:
        """Zero builds after ``mark_steady()`` or raise, naming every
        offending entry point and call index."""
        bad = [e for e in self.events if e.steady]
        if bad:
            lines = "\n".join(
                f"  {e.entry} built a kernel library at its call "
                f"#{e.call_index}" for e in bad)
            raise RetraceViolation(
                f"{len(bad)} steady-state build(s):\n{lines}")

    def report(self) -> dict:
        return {"steady": self.steady, "calls": dict(self.calls),
                "retraces": dict(self.retraces),
                "steady_retraces": self.steady_retraces(),
                "builds": build.BUILDS,
                "events": [e.to_dict() for e in self.events]}


@contextlib.contextmanager
def no_implicit_transfers(device=None):
    """On the card, raise on any synchronizing CUDA call inside the block
    (``torch.cuda.set_sync_debug_mode("error")``); on the CPU, no effect."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)

