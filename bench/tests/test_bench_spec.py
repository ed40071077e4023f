"""``BENCHMARK.json`` resolves by name: every cell to its configuration,
traffic mix, the mix's kind and limits, every metric to its reader; a mix
and a kind added as new files are found without touching a file that is
there; the entries keep to the benchmark's format."""
import json
import re
import shutil

import pytest

import tinycell  # noqa: F401  (puts bench/ on the path)
from benchlib import model, spec

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = spec.Cell(BENCH, cell)
    assert c.config_entry["file"].startswith("bench/")
    assert callable(c.kind.make) and callable(c.kind.drive)
    assert c.traffic["source"]
    assert set(c.limits) >= {"logit_gap"}
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_resolves(metric):
    read = spec.metric_reader(metric)
    assert callable(read)
    assert read({"counters": {"ticks": 0, "tokens": 0, "prefill_tokens": 0,
                              "prefill_s": 0.0, "commits": 0},
                 "tick_intervals_s": [], "slice": None}) is None


def test_suffixed_name_reads_its_base_or_its_own_file():
    assert spec.metric_path("tick_ms_p50.reason") == \
        spec.metric_path("tick_ms_p50")
    assert spec.metric_path("output_tok_s.host").name == \
        "output_tok_s.host.py"
    ctx = {"unprofiled": {"output_tok_s": 301.5, "itl_p95_ms": 160.2}}
    assert spec.metric_reader("output_tok_s.host")(ctx) == 301.5
    assert spec.metric_reader("itl_p95_ms.host")(ctx) == 160.2
    assert spec.metric_reader("itl_p95_ms.host")({}) is None


def test_entries_keep_to_the_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"] == ["python3", "bench/run.py"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_states_its_changes(entry):
    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    assert sorted(cfg["changed"]) == sorted(entry["reduced"])
    assert entry["source"] in cfg["source"]
    a = model.arch(cfg)
    assert a["head_dim"] * a["heads"] == a["d_model"]


def test_new_mix_file_is_found(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((spec.BENCH / "traffic" / "short.json").read_text())
    mix["prompt_len"] = [16, 32]
    (tmp_path / "bench/traffic/tiny_chat.json").write_text(json.dumps(mix))
    (tmp_path / "bench/limits/qwen2-7b.tiny_chat.json").write_text(
        json.dumps({"logit_gap": 0.01, "schedule_bad": 0}))
    bench = spec.load(tmp_path)
    bench["workloads"].append({"name": "qwen2-7b.tiny_chat",
                               "config": "qwen2-7b", "traffic": "tiny_chat",
                               "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.Cell(spec.load(tmp_path), "qwen2-7b.tiny_chat", tmp_path)
    reqs = c.kind.make(c.traffic, 5, 100)
    assert all(16 <= len(r.prompt) <= 32 for cl in reqs for r in cl)


def test_new_kind_file_is_found(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "bench/traffic/replay.py").write_text(
        "def make(mix, seed, vocab):\n    return mix['ids']\n\n"
        "async def drive(run, plan):\n    pass\n")
    mix = json.loads((spec.BENCH / "traffic" / "short.json").read_text())
    mix.update(kind="replay", ids=[[1, 2, 3]])
    (tmp_path / "bench/traffic/short.json").write_text(json.dumps(mix))
    c = spec.Cell(spec.load(tmp_path), "mixtral-8x7b-l8.short", tmp_path)
    assert c.kind.make(c.traffic, 0, 10) == [[1, 2, 3]]


def test_unknown_kind_is_refused(tmp_path):
    from benchlib import traffic
    with pytest.raises(ValueError, match="unknown traffic kind"):
        traffic.kind("no_such_kind", tmp_path)
