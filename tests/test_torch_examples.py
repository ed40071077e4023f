"""The port's examples (``examples/*_torch.py``) on the CPU against the JAX
package's examples run in the same process.

* ``quickstart_torch.py``: the reference's five lines, word for word; the
  TBQ codes and scales bit-exact, the integers (retained tokens, segment
  types, shared block references, refcounts, block tables) equal and the
  floats (round trip error, bits, footprint, the decode attention output)
  within 1e-5.
* ``calibrate_thoughts_torch.py``: the reference's lines word for word;
  L*, the mode counts and every predicted label equal, the thresholds and
  the accuracy within 1e-5.
* ``serve_reasoning_torch.py`` with the JAX engine's parameters carried
  across: every request's tokens on the batch path, with packs of 4 ticks,
  ``--stream`` through the orchestrator and ``--samples 2`` forks; the
  per-request and best-of-n lines word for word (the tok/s and TTFT lines
  carry times).
"""
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
TOL = 1e-5


def load(name):
    """``examples/<name>.py`` as a module (a script's top level runs)."""
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Smoke-size tensors: keep torch to one thread under several pytest
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_gives_the_jax_quickstart(capsys):
    ref = load("quickstart")                      # the JAX script runs
    want = capsys.readouterr().out
    launches = dict(ops.LAUNCHES)
    got = load("quickstart_torch").main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert ops.LAUNCHES == launches               # plain versions only
    assert (got["codes"].numpy() == np.asarray(ref.codes)).all()
    assert (got["scales"].numpy().view(np.uint32)
            == np.asarray(ref.scales).view(np.uint32)).all()
    stats = ref.stats
    assert got["retained"] == int(ref.CC.valid_counts(ref.cache)[0])
    assert got["seg_types"] == np.asarray(
        ref.cache.seg_type[:int(ref.cache.cur_seg) + 1]).tolist()
    assert got["shared"] == ref.shared and got["cow_ok"] == bool(ref.ok)
    assert (got["refcount"].numpy() == np.asarray(ref.pool.refcount)).all()
    for t, j in zip(got["tables"], (ref.table, ref.table2)):
        assert (t.numpy() == np.asarray(j)).all()
    rel = float(np.linalg.norm(np.asarray(ref.x - ref.x_hat))
                / np.linalg.norm(np.asarray(ref.x)))
    for key, j in (("rel_rmse", rel), ("avg_bits", stats["avg_bits"]),
                   ("footprint_frac", stats["footprint_frac"])):
        assert abs(got[key] - float(j)) <= TOL, key
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(ref.out),
                               rtol=0, atol=TOL)


def test_calibration_gives_the_jax_calibration(capsys):
    ref = load("calibrate_thoughts")
    capsys.readouterr()
    ref.main()
    want = capsys.readouterr().out
    got = load("calibrate_thoughts_torch").main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    # the reference's numbers, recomputed as its main() computes them
    gen = ref.ReasoningTraceGen(dataset="aime", seed=0)
    res = ref.calibrate(gen.calibration_traces(
        num_prompts=8, length=3000, num_layers=16, lstar=[2, 5, 9, 13]),
        num_thoughts=3, num_calib_layers=4)
    trace = gen.generate(5000)
    pred = np.asarray(ref.classify(ref.jnp.asarray(trace.sparsities),
                                   tuple(res.thresholds)))
    r = got["result"]
    assert r.layer_subset == res.layer_subset
    assert r.per_layer_modes == res.per_layer_modes
    assert np.abs(np.subtract(r.thresholds, res.thresholds)).max() <= TOL
    assert (got["pred"] == pred).all()
    assert abs(got["accuracy"] - float((pred == trace.thought_types).mean())
               ) <= TOL


def jax_serve(argv, monkeypatch):
    """Run the JAX ``serve_reasoning.py`` on ``argv``; returns its engine
    and finished requests (recorded by wrapping its engine class and its
    streamed serving function)."""
    mod = load("serve_reasoning")
    engines, runs = [], []

    class Recorded(mod.ThinKVEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

        def run(self, *a, **k):
            done = super().run(*a, **k)
            runs.append(done)
            return done

    streamed = mod.run_streamed

    def run_streamed(*a, **k):
        out = streamed(*a, **k)
        runs.append(out[0])
        return out
    monkeypatch.setattr(mod, "ThinKVEngine", Recorded)
    monkeypatch.setattr(mod, "run_streamed", run_streamed)
    monkeypatch.setattr(sys, "argv", ["serve_reasoning.py"] + argv)
    mod.main()
    return engines[0], runs[-1]


def report_lines(out):
    """The lines that carry no time: per request, best-of-n, candidates."""
    return [ln for ln in out.splitlines()
            if ln.startswith(("  req ", "best-of-", "  prompt "))]


@pytest.mark.parametrize("argv", [
    ["--requests", "4", "--max-new", "32"],
    ["--requests", "4", "--max-new", "32", "--ticks-per-dispatch", "4"],
    ["--requests", "4", "--max-new", "32", "--stream"],
    ["--requests", "3", "--max-new", "32", "--samples", "2"]],
    ids=["batch", "tpd4", "stream", "samples2"])
def test_serve_reasoning_gives_the_jax_tokens(argv, monkeypatch, capsys):
    jeng, jdone = jax_serve(argv, monkeypatch)
    want = capsys.readouterr().out
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                               get_smoke_config("r1-llama-8b"), "cpu")
    done, eng = load("serve_reasoning_torch").main(
        ["--device", "cpu"] + argv, params=params)
    out = capsys.readouterr().out
    assert eng.backend == "reference"
    assert {r.uid: list(map(int, r.output)) for r in done} == \
        {r.uid: list(map(int, r.output)) for r in jdone}
    assert report_lines(out) == report_lines(want)
    assert len(report_lines(out)) >= len(done)
    if "--samples" in argv:
        assert eng.metrics["forks"] == jeng.metrics["forks"] > 0
    mode = "streamed" if "--stream" in argv or "--samples" in argv \
        else "served"
    assert f"{mode} {len(done)} requests on 4 slots in " in out
    assert "tok/s cpu, reference)" in out
