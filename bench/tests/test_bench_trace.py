"""A ``--trace 1`` run reads the end-to-end statistics that a cell
reports per layer outside its profiled slice: the tokens and gaps of the
profiled interval are left out."""
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import tinycell  # noqa: E402
from benchlib import serve  # noqa: E402


def _run(stamps_by_request):
    served = [SimpleNamespace(stamps=s, t_send=0.0)
              for s in stamps_by_request]
    return SimpleNamespace(ws=10.0, we=20.0, seconds=10.0, t_start=0.0,
                           served=served, kv_mib=None)


def test_skip_leaves_the_profiled_interval_out():
    # one token every second, and a 5 s stall from 14 to 19 s
    stamps = [float(t) for t in range(10, 15)] + [19.0, 20.0]
    run = _run([stamps])
    whole = serve.Run.end_to_end(run)
    assert whole["output_tok_s"] == 7 / 10
    assert whole["itl_p95_ms"] > 1000.0
    out = serve.Run.end_to_end(run, skip=(14.5, 18.5))
    assert out["output_tok_s"] == 7 / 6
    assert out["itl_p95_ms"] == pytest.approx(1000.0)


def test_traced_run_reports_the_host_statistics(tmp_path, capsys):
    # a window long enough to hold ticks outside the 4 profiled ones on a
    # loaded host
    res = tinycell.run_cell(
        tinycell.make_root(tmp_path, tinycell.config()), capsys,
        seconds=2.0, trace=1)
    assert res["correct"] is True
    m = res["metrics"]
    assert m["output_tok_s.host"]["value"] > 0
    assert m["itl_p95_ms.host"]["value"] > 0
    assert m["tick_ms_p50.reason"] == m["tick_ms_p50"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
