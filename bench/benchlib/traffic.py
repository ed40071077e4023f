"""What every traffic kind shares: the request it makes, lengths spread
evenly over a range, and the lookup of a mix's kind.

A mix is a data file ``bench/traffic/<mix>.json``; its ``kind`` names the
module ``bench/traffic/<kind>.py`` that reads it.  A kind module has

* ``make(mix, seed, vocab)``: the run's requests, drawn from the seed
  (every seed the same sizes and arrivals, in another order), in whatever
  plan its ``drive`` reads;
* ``async drive(run, plan)``: sends them, each through ``run.send(req)``
  (which submits the request, stamps every token as the client reads it
  and returns when its stream ends), and returns once ``run.stop`` is set
  and every request it sent has ended.

Keys every kind's mix holds besides its own: ``warmup_ticks``,
``trace_ticks``, ``trace_min_prefills``, ``sample_requests``,
``sample_tokens``, optionally ``snapshot_prefill`` (``benchlib/serve.py``,
``benchlib/check.py``), and optionally ``temperature`` and ``top_p``
(every request's sampling; greedy when left out).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
from types import ModuleType

import numpy as np

TRAFFIC = pathlib.Path(__file__).resolve().parents[1] / "traffic"


@dataclasses.dataclass
class Request:
    client: int
    round: int
    prompt: np.ndarray          # int64 ids
    max_new: int


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths spread evenly over [lo, hi]."""
    return lo + ((hi - lo + 1) * (np.arange(n) + 0.5) / n).astype(np.int64)


def kind(name: str, traffic_dir: pathlib.Path = TRAFFIC) -> ModuleType:
    """The module ``<traffic_dir>/<name>.py`` of a mix's ``kind``."""
    path = pathlib.Path(traffic_dir) / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown traffic kind {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        "bench_traffic_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sampling(mix: dict) -> tuple:
    """(temperature, top_p) of the mix's requests."""
    return float(mix.get("temperature", 0.0)), float(mix.get("top_p", 1.0))
