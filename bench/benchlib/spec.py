"""``BENCHMARK.json`` and the files it names.

A cell is found by its name in ``workloads``; its configuration's file is
the ``file`` of the entry in ``configs``; its traffic mix is
``bench/traffic/<traffic>.json``, and the mix's ``kind`` is the module
``bench/traffic/<kind>.py`` that sends it; a metric's reader is
``bench/metrics/<metric>.py``, and where there is no such file, that of
the name before its last dot (``tick_ms_p50.reason`` is ``tick_ms_p50``
read in cells that report another end-to-end metric for it to move); a
cell's correctness limits are
``bench/limits/<cell>.json``.  Adding a cell, a mix, a configuration or a
metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Callable, Dict, List, Optional

from benchlib import traffic

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it reads."""

    def __init__(self, bench: dict, name: str,
                 root: pathlib.Path = ROOT):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"cells: {sorted(by_name)}")
        self.root = root
        self.name = name
        self.workload = by_name[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = json.loads(
            (root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(self.traffic_path().read_text())
        self.kind = traffic.kind(self.traffic["kind"],
                                 self.traffic_path().parent)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.limits = json.loads(self.limits_path().read_text())

    def traffic_path(self) -> pathlib.Path:
        return self.root / "bench" / "traffic" / \
            f"{self.workload['traffic']}.json"

    def limits_path(self) -> pathlib.Path:
        return self.root / "bench" / "limits" / f"{self.name}.json"

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def metric_path(name: str, root: pathlib.Path = ROOT) -> pathlib.Path:
    """``bench/metrics/<name>.py``; without it, the path of the name before
    its last dot, down to a name with no dot."""
    here = root / "bench" / "metrics"
    while not (here / f"{name}.py").is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
    return here / f"{name}.py"


def metric_reader(name: str, root: pathlib.Path = ROOT
                  ) -> Callable[[dict], Optional[float]]:
    """The ``read(ctx)`` of ``bench/metrics/<name>.py``."""
    path = metric_path(name, root)
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], ctx: dict,
                 root: pathlib.Path = ROOT) -> Dict[str, dict]:
    """Each metric's reader over ``ctx``; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
