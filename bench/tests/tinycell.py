"""A cell at a size the CPU runs in seconds, for the harness's own tests:
a checkout-like directory holding ``BENCHMARK.json`` with one cell
(``tiny.cell``), a configuration cut from a benchmark configuration, a
traffic mix and the limits, beside copies of the metric readers and the
traffic kinds."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

CELL = "tiny.cell"


def config(moe: bool = False, **arch) -> dict:
    name = "mixtral-8x7b-l8.json" if moe else "qwen2-7b.json"
    cfg = json.loads((BENCH / "configs" / name).read_text())
    cfg.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, intermediate_size=128, vocab_size=256)
    cfg.update(arch)
    if moe:
        cfg["num_local_experts"] = 4
        cfg["moe_routing"].update(capacity_factor=2.0, dispatch_group=64)
    cfg["thinkv"].update(token_budget=64, refresh_interval=32,
                         retention_schedule=[8, 4], min_retention=2,
                         kmeans_iters=2, max_segments=64)
    cfg["serving"]["max_seqs"] = 4
    return cfg


# the window opens after 100 ticks, by when about ten requests have
# finished whatever the host's speed: the check has them to compare
MIX = {"kind": "closed_loop", "clients": 4, "rounds": 8,
       "prompt_len": [20, 150], "output_len": [8, 60], "stagger_first": True,
       "warmup_ticks": 100, "trace_ticks": 4, "trace_min_prefills": 0,
       "sample_requests": 8, "sample_tokens": 200}

# the same sizes arriving open-loop, about as fast as the loop above sends
OPEN_MIX = {"kind": "open_loop", "requests": 48, "rate": 40.0,
            "prompt_len": [20, 150], "output_len": [8, 60],
            "warmup_ticks": 100, "trace_ticks": 4, "trace_min_prefills": 0,
            "sample_requests": 8, "sample_tokens": 200}


def make_root(tmp, cfg: dict, mix: dict = MIX,
              limits: dict = None) -> pathlib.Path:
    tmp = pathlib.Path(tmp)
    for d in ("metrics", "traffic"):
        shutil.copytree(BENCH / d, tmp / "bench" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("configs", "traffic", "limits"):
        (tmp / "bench" / d).mkdir(parents=True, exist_ok=True)
    (tmp / "bench/configs/tiny.json").write_text(json.dumps(cfg))
    (tmp / "bench/traffic/tiny.json").write_text(json.dumps(mix))
    (tmp / "bench/limits" / f"{CELL}.json").write_text(json.dumps(
        limits or {"logit_gap": 1e-3, "schedule_bad": 0}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "bench/configs/tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny",
                           "traffic": "tiny", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = [CELL]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_cell(root, capsys, seed: int = 2147483901, seconds: float = 0.5,
             trace: int = 0, control: int = 0, faults=None) -> dict:
    """One run of the tiny cell on the CPU through ``bench/run.py``'s
    ``main`` (past its look for a card, and past its look for JAX, which
    other test files load into the same test process); its result line."""
    import run
    forbidden, run.FORBIDDEN = run.FORBIDDEN, ()
    try:
        rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace), "--control",
                       str(control)], device="cpu", faults=faults, root=root)
    finally:
        run.FORBIDDEN = forbidden
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
