"""The profiled slice of a ``--trace 1`` run.

A frozen copy of ``chip_smoke.py::profile_window``'s method
(``torch.profiler`` over CPU and CUDA activity; device time by kernel name;
the program's ``thinkv.*`` host spans), with two changes: the device's
busy time is the union of the intervals in which some operation ran (not
the sum of their times, which counts overlapping kernels twice), and the
slice's events are kept as intervals so that the metric readers and the
``breakdown`` can place them.  Nothing is written to disk.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "thinkv."


class Slice:
    """Start and stop ``torch.profiler`` at two host moments, each after a
    device synchronise; :meth:`stop` returns the slice's wall time, and
    :meth:`events` its record, parsed once the window has closed (the parse
    of a slice of some thousand launches a tick takes the host for tens of
    seconds, which would otherwise stall the window)."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        return {"wall_s": wall}

    def events(self) -> dict:
        device_ops, spans, cpu_ops = [], [], []
        for e in self.prof.events():
            iv = (e.time_range.start, e.time_range.end)
            if str(e.device_type).endswith("CUDA"):
                # the device-side copies of the host spans are no operations
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith(SPAN_PREFIX)):
                    device_ops.append((e.name, *iv))
            elif e.name.startswith(SPAN_PREFIX):
                spans.append((e.name, *iv))
            else:
                cpu_ops.append((e.name, *iv))
        self.prof = None
        return {"device_ops": device_ops, "spans": spans, "cpu_ops": cpu_ops}


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(rec: dict) -> float:
    """Seconds in which some operation ran on the device (µs intervals)."""
    return sum(b - a for a, b in union(
        [(s, e) for _, s, e in rec["device_ops"]])) * 1e-6


def kernel_time_s(rec: dict, names: Tuple[str, ...]) -> Tuple[float, int]:
    """(seconds, launches) of the kernels whose name holds one of
    ``names``."""
    hits = [(e - s) for n, s, e in rec["device_ops"]
            if any(x in n for x in names)]
    return sum(hits) * 1e-6, len(hits)


def span_time_s(rec: dict, name: str, inside: Optional[str] = None) -> float:
    """Host seconds in spans ``name`` (only those within a span ``inside``,
    when given)."""
    spans = [(s, e) for n, s, e in rec["spans"] if n == name]
    if inside is not None:
        outer = [(s, e) for n, s, e in rec["spans"] if n == inside]
        spans = [(s, e) for s, e in spans
                 if any(a <= s and e <= b for a, b in outer)]
    return sum(e - s for s, e in spans) * 1e-6


def breakdown(rec: dict, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps of the device, each named by the host spans and the innermost
    host operation open when it began."""
    by_name: Dict[str, float] = {}
    for n, s, e in rec["device_ops"]:
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union([(s, e) for _, s, e in rec["device_ops"]])
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:top]
    out_gaps = []
    for length, at in gaps:
        open_spans = sorted((s, n) for n, s, e in rec["spans"]
                            if s <= at < e)
        inner = [(s, n) for n, s, e in rec["cpu_ops"] if s <= at < e]
        label = "/".join(n for _, n in open_spans) or "host"
        if inner:
            label += ": " + max(inner)[1]
        out_gaps.append([label[:160], length * 1e-6])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": out_gaps}
