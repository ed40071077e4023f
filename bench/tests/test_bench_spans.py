"""The readers of the program's maintenance and read-back spans
(``commit_ms_per_tick``, ``evict_ms_per_tick``, ``anneals_per_tick``,
``readbacks_per_tick``, ``readback_ms_per_tick``, and their ``.reason``
entries) count and time exactly what they document on a hand-built slice
record, and a traced run of the tiny cell reports each of them."""
import pytest

pytest.importorskip("torch")

import tinycell  # noqa: E402
from benchlib import spec  # noqa: E402

NEW = ("commit_ms_per_tick", "evict_ms_per_tick", "anneals_per_tick",
       "readbacks_per_tick", "readback_ms_per_tick")

# two ticks of 100 µs, each advancing its slots; a prefill (400-520) and a
# wait (150-160) between them; an overlapping pair of read-backs (12-14 and
# 13-16)
SPANS = [("thinkv.tick", 0.0, 100.0), ("thinkv.tick", 200.0, 300.0),
         ("thinkv.advance", 5.0, 95.0), ("thinkv.advance", 205.0, 295.0),
         ("thinkv.prefill", 400.0, 520.0),
         ("thinkv.commit", 10.0, 20.0), ("thinkv.commit", 210.0, 240.0),
         ("thinkv.commit", 400.0, 450.0),
         ("thinkv.evict", 20.0, 60.0), ("thinkv.evict", 500.0, 510.0),
         ("thinkv.anneal", 25.0, 35.0), ("thinkv.anneal", 40.0, 50.0),
         ("thinkv.anneal", 220.0, 230.0), ("thinkv.anneal", 505.0, 508.0),
         ("thinkv.readback", 12.0, 14.0), ("thinkv.readback", 13.0, 16.0),
         ("thinkv.readback", 150.0, 160.0),
         ("thinkv.readback", 402.0, 404.0)]
WANT = {"commit_ms_per_tick": (10.0 + 30.0) * 1e-3 / 2,
        "evict_ms_per_tick": 40.0 * 1e-3 / 2,
        "anneals_per_tick": 3 / 2,
        "readbacks_per_tick": 4 / 2,
        "readback_ms_per_tick": (4.0 + 10.0 + 2.0) * 1e-3 / 2}


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("suffix", ["", ".reason"])
def test_reader_counts_what_it_documents(name, suffix):
    read = spec.metric_reader(name + suffix)
    ctx = {"slice": {"ticks": 2, "spans": SPANS, "device_ops": [],
                     "cpu_ops": []}}
    assert read(ctx) == pytest.approx(WANT[name], rel=1e-12)
    assert read({"slice": {"ticks": 0, "spans": SPANS}}) is None
    assert read({"slice": None}) is None
    # a program whose ticks hold no spans of their own reports nothing
    older = [x for x in SPANS if x[0] in ("thinkv.tick", "thinkv.prefill")]
    assert read({"slice": {"ticks": 2, "spans": older}}) is None


def test_entries_name_the_cells_that_report_them():
    per_layer = {m["name"]: m for m in spec.load()["per_layer"]}
    for name in NEW:
        for suffix, cell, moves in (
                ("", "mixtral-8x7b-l8.short", "output_tok_s"),
                (".reason", "qwen2-7b.reason", "kv_mib_per_req")):
            m = per_layer.get(name + suffix)
            if m is None:       # eviction and anneals are qwen2's alone
                assert suffix == "" and name in ("evict_ms_per_tick",
                                                 "anneals_per_tick")
                continue
            assert (m["workloads"], m["moves"]) == ([cell], moves)
            assert m["source"] == "program_span"


def test_traced_tiny_cell_reports_the_span_metrics(tmp_path, capsys):
    entries = [m["name"] for m in spec.load()["per_layer"]
               if m["name"].split(".")[0] in NEW]
    assert len(entries) == 8
    res = tinycell.run_cell(
        tinycell.make_root(tmp_path, tinycell.config()), capsys,
        seed=2147484321, seconds=0.5, trace=1)
    m = res["metrics"]
    for key in entries:
        assert m[key]["value"] >= 0, key
    assert m["readbacks_per_tick"]["value"] > 0
    assert m["readbacks_per_tick.reason"] == m["readbacks_per_tick"]
