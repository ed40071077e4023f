"""Fault-tolerance primitives: failure injection, straggler monitoring
(a copy of ``repro/ft/failures.py``, which is pure Python: the port keeps
its own).

At thousand-node scale the relevant failure modes are (a) hard node loss →
restart from checkpoint on a possibly different topology, (b) preemption →
same, (c) stragglers → detect and mitigate.  (a)/(b) are exercised by
killing/resuming the trainer (tests/test_fault_tolerance.py) through the
elastic checkpoint protocol; this module provides the injection hooks and
the straggler detector.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


class InjectedFailure(RuntimeError):
    """Raised by FailureInjector to simulate a node loss / preemption."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministically fail at the given steps (once each)."""

    fail_at_steps: tuple = ()
    kind: str = "preemption"
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise InjectedFailure(f"{self.kind} injected at step {step}")


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    median: float
    ratio: float


class StragglerMonitor:
    """Flags steps slower than ``threshold`` x rolling median.

    On a real fleet the per-host step times come from a lightweight
    all-gather of host timestamps; the mitigation hook can trigger
    microbatch rebalancing or hot-spare swap-in.  Here the monitor tracks
    the local step time and fires a callback — the trainer's rebalance
    hook is unit-tested against synthetic slowdowns.
    """

    def __init__(self, window: int = 32, threshold: float = 2.0,
                 on_straggler: Optional[Callable[[StragglerEvent], None]]
                 = None):
        self.window = window
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.times: List[float] = []
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self, step: int, elapsed: Optional[float] = None) -> None:
        dt = elapsed if elapsed is not None else \
            (time.perf_counter() - self._t0 if self._t0 else 0.0)
        hist = self.times[-self.window:]
        if len(hist) >= 5:
            med = sorted(hist)[len(hist) // 2]
            if med > 0 and dt > self.threshold * med:
                ev = StragglerEvent(step=step, step_time=dt, median=med,
                                    ratio=dt / med)
                self.events.append(ev)
                if self.on_straggler:
                    self.on_straggler(ev)
        self.times.append(dt)

    def summary(self) -> Dict:
        n = len(self.times)
        return {
            "steps": n,
            "stragglers": len(self.events),
            "median_s": sorted(self.times)[n // 2] if n else 0.0,
        }
