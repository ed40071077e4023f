"""The prefill witness runs end to end on the CPU-sized cell: the two
backends of the program and the reference prefill the same prompts, past
the tiny budget so that eviction runs, and every share it prints lies in
[0, 1]."""
import pytest

pytest.importorskip("torch")

import tinycell  # noqa: E402


def test_witness_prints_every_pair(tmp_path, capsys):
    import importlib.util
    root = tinycell.make_root(tmp_path, tinycell.config(False), dict(
        tinycell.MIX, prompt_len=[100, 150]))
    spec = importlib.util.spec_from_file_location(
        "prefill_backends", tinycell.BENCH / "witness" / "prefill_backends.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--workload", tinycell.CELL, "--seed", "2147483907",
                    "--prompts", "2"], device="cpu", root=root)
    assert res["prompt_lens"] and min(res["prompt_lens"]) > 64
    assert set(res["state_diff"]) == {
        "kernel_vs_reference_backend", "kernel_vs_bench_reference",
        "reference_backend_vs_bench_reference"}
    for v in res["state_diff"].values():
        assert len(v) == 2 and all(0.0 <= x <= 1.0 for x in v)
    for v in res["first_token_gap"].values():
        assert len(v) == 2 and all(x >= 0.0 for x in v)
