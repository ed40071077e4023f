"""Replay a recorded serving trace through the port's engine and hold it to
the record.

A record is a numpy archive written from the JAX package's engine
(``tests/golden/torch_{flash,pressure,sampled,rkv,uniform}_trace.npz``, by
``tests/test_torch_trace_fixture.py``): the model's parameters, the trace's
settings and prompts, and what the reference engine gave (tokens and
logits per request, engine counters, the pool audit).  Reading it takes
numpy only, so a machine without JAX (the card's) holds the port to the
live JAX record.  Archive keys:

* ``settings``: JSON — ``model`` (a smoke config name), ``num_heads``,
  ``num_kv_heads``, ``thinkv`` (ThinKVConfig fields), ``slots``,
  ``max_new``, ``priorities``; optionally ``pool_blocks`` (default
  ``slots * NB``), ``prefix_cache`` (default false), ``temperature``
  (default 0, greedy), ``top_p`` (default 1), ``ticks_per_dispatch``
  (default 1), ``policy`` (default ``"thinkv"``), ``drift_probe``
  (default false) and ``prompt_recipe`` (how the prompts were drawn:
  seed, vocab, lengths, which requests share a prefix of which length;
  the prompts themselves are stored);
* ``record``: JSON — ``counters`` (engine metrics by name), ``audit``
  (``audit_pool()``); a sampled record also ``min_margin``, the smallest
  gap between the best and the second-best perturbed score over every
  draw of the run (how far the logits may move before a draw flips); a
  record with the drift probe on also ``drift``, each request's
  ``measure_drift`` result by arrival stamp;
* ``prompt_<i>`` (int64), ``tokens_<arrival>`` (int64), ``logits_<arrival>``
  ([max_new, vocab] f32);
* ``param/<path>``: the parameter tree's leaves, ``/``-joined paths.

It lives in the package, not under ``tests/``, because ``chip_smoke.py``
replays the record on the card from a checkout whose ``src`` is all it puts
on the path; the engine's own serving path never calls it.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.config import ServeConfig, ThinKVConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.serving.engine import ThinKVEngine

PARAM = "param/"


def unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *heads, leaf = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def load(path) -> dict:
    """The record at ``path``: settings, params (a nested dict of numpy
    arrays), prompts, tokens and logits by arrival, counters, audit."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    settings = json.loads(str(arrays["settings"]))
    record = json.loads(str(arrays["record"]))
    arrivals = sorted(int(k.split("_")[1]) for k in arrays
                      if k.startswith("tokens_"))
    n_prompts = sum(k.startswith("prompt_") for k in arrays)
    return {"settings": settings,
            "params": unflatten({k[len(PARAM):]: v for k, v in arrays.items()
                                 if k.startswith(PARAM)}),
            "prompts": [arrays[f"prompt_{i}"] for i in range(n_prompts)],
            "tokens": {a: arrays[f"tokens_{a}"].tolist() for a in arrivals},
            "logits": {a: arrays[f"logits_{a}"] for a in arrivals},
            "counters": record["counters"], "audit": record["audit"],
            "min_margin": record.get("min_margin"),
            "drift": {int(a): d for a, d in record.get("drift", {}).items()}}


def serve_config(rec: dict) -> ServeConfig:
    s = rec["settings"]
    mcfg = dataclasses.replace(get_smoke_config(s["model"]),
                               num_heads=s["num_heads"],
                               num_kv_heads=s["num_kv_heads"])
    tk = ThinKVConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in s["thinkv"].items()})
    return ServeConfig(model=mcfg, thinkv=tk, max_seqs=s["slots"],
                       temperature=s.get("temperature", 0.0),
                       top_p=s.get("top_p", 1.0))


def expected_commits(rec: dict) -> int:
    """Group commits of a trace served without the prefix cache: every G
    tokens a request writes (its prompt and every generated token but the
    last; preemption recomputes nothing).  A prefix hit skips the covered
    commits: count those from the engine's ``metrics["commits"]``."""
    g, new = serve_config(rec).thinkv.group_size, rec["settings"]["max_new"]
    return sum((len(p) + new - 1) // g for p in rec["prompts"])


def replay(rec: dict, backend: str, device, params=None
           ) -> Tuple[ThinKVEngine, list, Dict[str, int]]:
    """Serve the record's prompts on ``device`` with ``backend``, at the
    record's sampling settings and dispatch width; returns (engine,
    finished requests, kernel launches of the run)."""
    cfg = serve_config(rec)
    if params is None:
        params = params_from_numpy(rec["params"], cfg.model, device)
    s = rec["settings"]
    eng = ThinKVEngine(cfg, params=params, backend=backend, device=device,
                       record_logits=True, pool_blocks=s.get("pool_blocks"),
                       prefix_cache=bool(s.get("prefix_cache", False)),
                       ticks_per_dispatch=s.get("ticks_per_dispatch", 1),
                       policy=s.get("policy", "thinkv"),
                       drift_probe=bool(s.get("drift_probe", False)))
    before = dict(ops.LAUNCHES)
    eng.submit(rec["prompts"], max_new_tokens=rec["settings"]["max_new"],
               priorities=rec["settings"]["priorities"])
    done = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return eng, done, {k: ops.LAUNCHES[k] - before[k] for k in before}


# the bar for drift magnitudes: the probe's replay and the serving path's
# logits each carry the port's distance from the JAX engine's (<= 1e-3)
DRIFT_ATOL = 2e-3


def drift_mismatches(want: Dict[int, dict], done) -> List[str]:
    """Each request's drift against the record's: ``steps`` and
    ``top1_agree`` equal, ``max_abs`` and ``mean_abs`` finite and within
    :data:`DRIFT_ATOL`."""
    bad = []
    got = {r.arrival: r.stats.get("drift") for r in done}
    if sorted(got) != sorted(want):
        return [f"drift for requests {sorted(got)} != {sorted(want)}"]
    for a, w in want.items():
        g = got[a]
        if g is None:
            bad.append(f"drift of request {a} missing")
            continue
        if (g["steps"], g["top1_agree"]) != (w["steps"], w["top1_agree"]):
            bad.append(f"drift of request {a}: steps / top-1 agreement "
                       f"{g['steps']} / {g['top1_agree']} != {w['steps']} "
                       f"/ {w['top1_agree']}")
        for k in ("max_abs", "mean_abs"):
            if not (math.isfinite(g[k]) and abs(g[k] - w[k]) <= DRIFT_ATOL):
                bad.append(f"drift of request {a}: {k} {g[k]} vs {w[k]}")
    return bad


def mismatches(rec: dict, eng: ThinKVEngine, done, atol: float = 1e-3
               ) -> Tuple[List[str], float]:
    """What of the replay differs from the record: (descriptions, the
    largest per-request logit difference).  Tokens, counters and the pool
    audit must be equal, logits within ``atol``, and a record's drift
    within :func:`drift_mismatches`' bars."""
    bad = []
    got = {r.arrival: list(r.output) for r in done}
    if got != rec["tokens"]:
        bad.append(f"tokens {got} != {rec['tokens']}")
    worst = 0.0
    for a, want in rec["logits"].items():
        have = eng.request_logits.get(a)
        if have is None or np.stack(have).shape != want.shape:
            bad.append(f"request {a}: no logits of shape {want.shape}")
            continue
        worst = max(worst, float(np.abs(np.stack(have) - want).max()))
    if not worst <= atol:
        bad.append(f"logits differ by {worst} > {atol}")
    counters = {k: int(eng.metrics[k]) for k in rec["counters"]}
    if counters != rec["counters"]:
        bad.append(f"counters {counters} != {rec['counters']}")
    audit = eng.audit_pool()
    if audit != rec["audit"]:
        bad.append(f"pool audit {audit} != {rec['audit']}")
    if rec["drift"]:
        bad += drift_mismatches(rec["drift"], done)
    return bad, worst
