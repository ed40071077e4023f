"""The logit-drift probe: the port's ``ThinKVEngine.measure_drift`` and its
dense replay against the JAX engine's on the same inputs, and the probe
through the orchestrator.

Bars: ``steps`` and ``top1_agree`` equal to JAX's, ``max_abs`` and
``mean_abs`` within 2e-3 (``trace_record.DRIFT_ATOL``: the two dense
replays differ by f32 summation order only; the gap measured here is
printed: up to 1.1e-8 on these cases).  The replays pad ``prompt +
output[:-1]`` to a multiple of 32 tokens; a request past 2048 tokens takes
the q-chunked attention path in both packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ServeConfig as JSC  # noqa: E402
from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.serving import engine as EJ  # noqa: E402
from repro_torch.config import ServeConfig, ThinKVConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import engine as ET  # noqa: E402
from repro_torch.serving import trace_record as TR  # noqa: E402

TK = dict(refresh_interval=8, group_size=8, block_size=8, token_budget=32,
          retention_schedule=(16, 8, 4), min_retention=4, max_segments=64,
          kmeans_iters=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    several pytest workers on one host the threads' wake-ups dominate:
    run this module's torch ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    mj = dataclasses.replace(jax_smoke("r1-llama-8b"), num_heads=8,
                             num_kv_heads=8)
    mt = dataclasses.replace(get_smoke_config("r1-llama-8b"), num_heads=8,
                             num_kv_heads=8)
    je = EJ.ThinKVEngine(JSC(model=mj, thinkv=JTK(**TK), max_seqs=2),
                         backend="reference", drift_probe=True)
    te = ET.ThinKVEngine(
        ServeConfig(model=mt, thinkv=ThinKVConfig(**TK), max_seqs=2),
        params=params_from_numpy(jax.tree.map(np.asarray, je.params), mt,
                                 "cpu"), device="cpu", drift_probe=True)
    return je, te


def case(je, seed, p, n_out, n_rec=None):
    """A prompt of ``p`` tokens, ``n_out`` output tokens and ``n_rec``
    recorded logits (default one per output token): the JAX replay's
    logits at the predicting positions, every other one moved far enough
    to change its argmax, plus noise."""
    rng = np.random.default_rng(seed)
    V = je.mcfg.vocab_size
    prompt = rng.integers(0, V, p)
    output = rng.integers(0, V, n_out).tolist()
    toks = np.concatenate([prompt, output])[:max(p + n_out - 1, 1)]
    pad = -(-len(toks) // EJ.DRIFT_PAD) * EJ.DRIFT_PAD
    buf = np.zeros((1, pad), np.int32)
    buf[0, :len(toks)] = toks
    ref = np.asarray(je._drift_probe_jit(je.params, jnp.asarray(buf)))[0]
    rec = []
    for i in range(n_out if n_rec is None else n_rec):
        lg = ref[p - 1 + i] + rng.standard_normal(V).astype(np.float32) * 0.01
        if i % 2:
            lg[rng.integers(V)] += 100.0
        rec.append(lg.astype(np.float32))
    return prompt, output, rec


@pytest.mark.parametrize("p,n_out,n_rec", [
    (20, 12, None),            # prompt + output[:-1] = 31: padded to 32
    (21, 12, None),            # exactly 32: no pad
    (40, 9, 5),                # fewer recorded logits than outputs
    (17, 0, None),             # nothing generated
    (2070, 20, None)])         # 2089 -> 2112 rows: the q-chunked path
def test_measure_drift_matches_jax(engines, p, n_out, n_rec):
    je, te = engines
    prompt, output, rec = case(je, p + n_out, p, n_out, n_rec)
    want = je.measure_drift(prompt, output, rec)
    got = te.measure_drift(prompt, output, rec)
    assert got["steps"] == want["steps"] == min(n_out, len(rec))
    assert got["top1_agree"] == want["top1_agree"]
    gap = max(abs(got[k] - want[k]) for k in ("max_abs", "mean_abs"))
    print(f"p={p} n_out={n_out}: drift {got}, gap from JAX's {gap:.3g}")
    assert gap <= TR.DRIFT_ATOL
    if want["steps"]:
        assert 0 < want["top1_agree"] < 1


def test_probe_metrics_and_refusal(engines):
    _, te = engines
    assert te.record_logits            # the probe forces it on
    before = te.metrics["drift_probes"]
    prompt, output = np.arange(10), [3, 4, 5]
    rec = [np.full(te.mcfg.vocab_size, 1e3, np.float32)] * 3
    d = te.measure_drift(prompt, output, rec)
    assert te.metrics["drift_probes"] == before + 1
    assert te.metrics["drift_max_abs"] >= d["max_abs"] > 900
    off = ET.ThinKVEngine(te.cfg, params=te.model, device="cpu")
    assert not off.drift_probe and not off.record_logits
    with pytest.raises(RuntimeError, match="drift_probe"):
        off.measure_drift(prompt, output, rec)


def test_the_orchestrator_probes_each_finished_request(engines):
    """Served through the orchestrator, each finished request carries its
    ``drift`` (equal to measuring its recorded logits again) and the log
    one ``drift`` event per request."""
    _, te = engines
    eng = ET.ThinKVEngine(te.cfg, params=te.model, device="cpu",
                          drift_probe=True, policy="uniform")
    rng = np.random.default_rng(9)
    eng.submit([rng.integers(0, 256, n) for n in (30, 12)],
               max_new_tokens=10)
    done = eng.run()
    events = [e for e in eng.last_orchestrator.events if e["kind"] == "drift"]
    assert sorted(e["arrival"] for e in events) == [0, 1]
    assert eng.metrics["drift_probes"] == 2
    for r in done:
        d = r.stats["drift"]
        assert d["steps"] == 10 and np.isfinite(d["max_abs"])
        assert eng.measure_drift(r.prompt, r.output,
                                 eng.request_logits[r.arrival]) == d
