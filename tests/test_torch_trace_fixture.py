"""The JAX engine's records of the flash, the pressure and the sampled
trace, carried to the card as numpy archives
(``tests/golden/torch_{flash,pressure,sampled,rkv,uniform,moe,qwen2,vlm}
_trace.npz``), and the port's replay of them
(``repro_torch.serving.trace_record``).

A record is the live JAX ``reference`` engine's run: its parameters, tokens
and logits per request, the engine counters and the pool audit.  The flash
record has the settings of ``tests/test_torch_engine.py::jax_run``
(prompts of 140 and 24 tokens from ``np.random.default_rng(1)``, 8 new
tokens, 3 slots, an unpressured pool); the pressure record those of
``tests/test_torch_pressure.py::jax_run`` (five prompts, three sharing a
16-token prefix, 24 new tokens, a 14-block pool, the prefix cache on);
the sampled record is the pressure trace at temperature 0.7, top-p 0.9 and
8 ticks per dispatch (the JAX trace suite's ``temperature_cells``
setting), with ``min_margin``: the smallest gap between the best and the
second-best perturbed score over every draw, computed with the port's
PRNG from the JAX logits (which also reproduces every recorded token).
The rkv and uniform records are the pressure trace under those retention
policies with the drift probe on (the JAX trace suite's
``policy_pressure_cells``): each request's drift against the dense replay
is recorded too.  The moe and qwen2 records are the pressure trace on
mixtral-8x7b's and qwen2-7b's smoke configs at their own 4 q / 2 kv heads
(``test_torch_archs.jax_params``: qwen2's qkv biases non-zero, drawn from
a numpy seed); the vlm record is the pressure trace on paligemma-3b's
smoke config (4 q / 1 kv head, head_dim 16, tied embeddings scaled by
sqrt(d_model), GeGLU; text prompts, as the engine serves the VLM).
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the card's kernel
and reference backends to them, where there is no JAX.  The golden
``serving_trace.json`` is not such a record (it dates from an older tree:
its flash tokens and its pressure tokens no longer match the reference,
its pressure counters still do).

A test here re-runs the JAX engine on each trace and asserts that the
archive equals the fresh record, so a file cannot go stale silently.  To
write all eight anew (after a change to the reference engine or to these
settings):

    PYTHONPATH=src python tests/test_torch_trace_fixture.py
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import ServeConfig as JSC  # noqa: E402
from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.serving.engine import ThinKVEngine as JaxEngine  # noqa: E402
from repro_torch.serving import prng  # noqa: E402
from repro_torch.serving import sampling as SMP  # noqa: E402
from repro_torch.serving import trace_record as TR  # noqa: E402
import test_torch_pressure as PT  # noqa: E402
from test_torch_archs import BIAS_SCALE, jax_params  # noqa: E402
from test_torch_engine import (COUNTERS, LENS, MAX_NEW,  # noqa: E402
                               PRIORITIES, SLOTS, TK, prompts)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    several pytest workers on one host the threads' wake-ups dominate:
    run this module's torch ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FIXTURE = os.path.join(GOLDEN, "torch_flash_trace.npz")
PRESSURE_FIXTURE = os.path.join(GOLDEN, "torch_pressure_trace.npz")
SAMPLED_FIXTURE = os.path.join(GOLDEN, "torch_sampled_trace.npz")
SETTINGS = {"model": "r1-llama-8b", "num_heads": 8, "num_kv_heads": 8,
            "thinkv": TK, "slots": SLOTS, "max_new": MAX_NEW,
            "priorities": list(PRIORITIES)}
PRESSURE_SETTINGS = {"model": "r1-llama-8b", "num_heads": 8,
                     "num_kv_heads": 8, "thinkv": TK, "slots": PT.SLOTS,
                     "max_new": PT.MAX_NEW,
                     "priorities": list(PT.PRIORITIES),
                     "pool_blocks": PT.pool_blocks(), "prefix_cache": True,
                     "prompt_recipe": PT.RECIPE}
SAMPLED_SETTINGS = {**PRESSURE_SETTINGS, "temperature": 0.7, "top_p": 0.9,
                    "ticks_per_dispatch": 8}
SAMPLED_COUNTERS = PT.COUNTERS + ("dispatches", "early_exit_finish",
                                  "early_exit_headroom")
POLICY_RECORDS = ("rkv", "uniform")
POLICY_FIXTURES = {name: os.path.join(GOLDEN, f"torch_{name}_trace.npz")
                   for name in POLICY_RECORDS}
POLICY_COUNTERS = PT.COUNTERS + ("drift_probes",)


def policy_settings(name: str) -> dict:
    return {**PRESSURE_SETTINGS, "policy": name, "drift_probe": True}


# record -> the smoke config its pressure trace runs on
ARCH_RECORDS = {"moe": "mixtral-8x7b", "qwen2": "qwen2-7b",
                "vlm": "paligemma-3b"}
ARCH_FIXTURES = {name: os.path.join(GOLDEN, f"torch_{name}_trace.npz")
                 for name in ARCH_RECORDS}


def arch_settings(name: str) -> dict:
    """The pressure trace on the record's smoke config at its own heads;
    the parameters are ``test_torch_archs.jax_params(cfg, 0)``."""
    arch = ARCH_RECORDS[name]
    cfg = jax_smoke(arch)
    out = {**PRESSURE_SETTINGS, "model": arch, "num_heads": cfg.num_heads,
           "num_kv_heads": cfg.num_kv_heads}
    if cfg.qkv_bias:
        out["qkv_bias_recipe"] = {"seed": 100, "scale": BIAS_SCALE}
    return out
# a draw whose margin is below this could flip under the card's logit
# error (up to 2.66e-4 on the pressure trace), so the card's bar would
# stop there
MARGIN_BAR = 1e-3 / SAMPLED_SETTINGS["temperature"]


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict of arrays -> {``a/b/c``: array} (the archive's
    ``param/`` keys; ``trace_record.load`` nests them again)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_record(settings: dict = SETTINGS, ps=None,
               counters=COUNTERS, params=None) -> dict:
    """The JAX reference engine's run of a trace (by default the flash
    trace), as the archive's arrays (see
    ``repro_torch.serving.trace_record``); ``params`` are the engine's
    (its own seeded ones when None)."""
    mcfg = dataclasses.replace(jax_smoke(settings["model"]),
                               num_heads=settings["num_heads"],
                               num_kv_heads=settings["num_kv_heads"])
    eng = JaxEngine(JSC(model=mcfg, thinkv=JTK(**settings["thinkv"]),
                        max_seqs=settings["slots"],
                        temperature=settings.get("temperature", 0.0),
                        top_p=settings.get("top_p", 1.0)),
                    params=params, backend="reference", record_logits=True,
                    pool_blocks=settings.get("pool_blocks"),
                    prefix_cache=settings.get("prefix_cache", False),
                    ticks_per_dispatch=settings.get("ticks_per_dispatch", 1),
                    policy=settings.get("policy"),
                    drift_probe=settings.get("drift_probe", False))
    ps = prompts() if ps is None else ps
    eng.submit(ps, max_new_tokens=settings["max_new"],
               priorities=settings["priorities"])
    done = eng.run()
    record = {"counters": {k: int(eng.metrics[k]) for k in counters},
              "audit": eng.audit_pool()}
    if settings.get("temperature", 0.0) > 0:
        record["min_margin"] = min(draw_margins(
            settings, {r.arrival: (r.output, np.stack(
                eng.request_logits[r.arrival])) for r in done}))
    if settings.get("drift_probe"):
        record["drift"] = {str(r.arrival): r.stats["drift"] for r in done}
    out = {"settings": np.array(json.dumps(settings)),
           "record": np.array(json.dumps(record, default=int))}
    out.update({f"prompt_{i}": p for i, p in enumerate(ps)})
    for r in done:
        out[f"tokens_{r.arrival}"] = np.asarray(r.output, np.int64)
        out[f"logits_{r.arrival}"] = np.stack(
            eng.request_logits[r.arrival]).astype(np.float32)
    params = flatten(jax.tree.map(np.asarray, eng.params))
    out.update({TR.PARAM + k: v for k, v in params.items()})
    return out


def draw_margins(settings: dict, runs: dict, seed: int = 0) -> list:
    """Every draw's gap between the best and the second-best perturbed
    score, replayed with the port's PRNG and sampler from the recorded
    logits: ``runs`` maps an arrival stamp to (tokens, logits [n, V]).  A
    request's draw 0 is its prefill's (divided by T), the others its
    ticks' (scaled by the f32 reciprocal, as the compiled tick does).
    Asserts that each replayed draw gives the recorded token."""
    T, top_p = settings["temperature"], settings["top_p"]
    t = torch.full((), T, dtype=torch.float32)
    margins = []
    for arrival, (tokens, logits) in runs.items():
        key = SMP.request_stream_key(seed, arrival)
        for j, (tok, lg) in enumerate(zip(tokens, logits)):
            keys = prng.split(key, 2)
            key, sub = keys[0], keys[1]
            x = torch.as_tensor(lg)
            scaled = x / t if j == 0 else x * (1.0 / t)
            if top_p < 1.0:
                scaled = SMP._top_p_filter(scaled, top_p)
            z = prng.gumbel(sub, x.shape[-1]) + scaled
            top = z.topk(2)
            assert int(top.indices[0]) == tok, (arrival, j)
            margins.append(float(top.values[0] - top.values[1]))
    return margins


def jax_pressure_record() -> dict:
    return jax_record(PRESSURE_SETTINGS, PT.prompts(), PT.COUNTERS)


def jax_sampled_record() -> dict:
    return jax_record(SAMPLED_SETTINGS, PT.prompts(), SAMPLED_COUNTERS)


def jax_policy_record(name: str) -> dict:
    return jax_record(policy_settings(name), PT.prompts(), POLICY_COUNTERS)


def jax_arch_record(name: str) -> dict:
    settings = arch_settings(name)
    params = jax.tree.map(jax.numpy.asarray,
                          jax_params(jax_smoke(settings["model"])))
    return jax_record(settings, PT.prompts(), PT.COUNTERS, params)


def write_fixture(path: str = FIXTURE) -> None:
    np.savez(path, **jax_record())


def write_pressure_fixture(path: str = PRESSURE_FIXTURE) -> None:
    np.savez(path, **jax_pressure_record())


def write_sampled_fixture(path: str = SAMPLED_FIXTURE) -> None:
    np.savez(path, **jax_sampled_record())


def assert_archive_equals(path: str, fresh: dict) -> None:
    """Tokens, counters, audit, prompts and parameters exactly; logits to
    1e-6."""
    with np.load(path, allow_pickle=False) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in fresh:
            if k.startswith("logits_"):
                np.testing.assert_allclose(z[k], fresh[k], rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                assert z[k].dtype == fresh[k].dtype, k
                np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)


@pytest.fixture(scope="module")
def stored():
    return TR.load(FIXTURE)


@pytest.fixture(scope="module")
def stored_pressure():
    return TR.load(PRESSURE_FIXTURE)


def test_fixture_equals_the_live_jax_record(stored):
    """Tokens, counters, audit, prompts and parameters exactly; logits to
    1e-6."""
    fresh = jax_record()
    assert_archive_equals(FIXTURE, fresh)
    n_params = sum(v.size for k, v in fresh.items()
                   if k.startswith(TR.PARAM))
    assert n_params == 147_776
    assert stored["settings"]["thinkv"] == json.loads(json.dumps(TK))
    assert [len(p) for p in stored["prompts"]] == list(LENS)
    assert all(len(t) == MAX_NEW for t in stored["tokens"].values())


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_port_replays_the_record_on_the_cpu(stored, backend):
    """``trace_record.replay`` (what the card's test and ``chip_smoke.py``
    run) on the CPU: the record's tokens, logits within 1e-3, counters and
    audit; the plain versions launch nothing."""
    eng, done, launches = TR.replay(stored, backend, "cpu")
    bad, worst = TR.mismatches(stored, eng, done)
    assert not bad, bad
    assert worst <= 1e-3
    assert not any(launches.values())
    assert TR.expected_commits(stored) == (140 + 7) // 8 + (24 + 7) // 8


def test_mismatches_names_what_differs(stored):
    """The comparison the card is held to catches a changed token, logit,
    counter or audit."""
    eng, done, _ = TR.replay(stored, "reference", "cpu")
    rec = dict(stored, tokens={a: list(t) for a, t in
                               stored["tokens"].items()})
    rec["tokens"][0][3] += 1
    rec["logits"] = {a: l + (2e-3 if a == 1 else 0.0)
                     for a, l in stored["logits"].items()}
    rec["counters"] = dict(stored["counters"], ticks=0)
    rec["audit"] = dict(stored["audit"], pool_blocks=-1)
    bad, _ = TR.mismatches(rec, eng, done)
    assert [b.split()[0] for b in bad] == ["tokens", "logits", "counters",
                                           "pool"]


def test_pressure_fixture_equals_the_live_jax_record(stored_pressure):
    """The pressure record: the live engine's run, with the counters the
    port is held to (9 preemptions, 9 resumes, 2 prefix hits, 4 COW
    faults ...) and the settings the replay builds its engine from."""
    assert_archive_equals(PRESSURE_FIXTURE, jax_pressure_record())
    rec = stored_pressure
    assert {k: rec["counters"][k] for k in PT.WANT} == PT.WANT
    assert rec["audit"] == {"claimed": [3, 3], "free": [11, 11],
                            "pool_blocks": 14}
    assert rec["settings"]["pool_blocks"] == 14
    assert rec["settings"]["prefix_cache"] is True
    assert [len(p) for p in rec["prompts"]] == list(PT.LENS)
    for a, b in zip(rec["prompts"], PT.prompts()):
        np.testing.assert_array_equal(a, b)
    assert all(len(t) == PT.MAX_NEW for t in rec["tokens"].values())


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_port_replays_the_pressure_record_on_the_cpu(stored_pressure,
                                                     backend):
    """The pressure record through ``trace_record.replay`` on the CPU: the
    record's tokens, logits within 1e-3, counters and audit; commits
    counted by the engine (prefix hits skip four)."""
    eng, done, launches = TR.replay(stored_pressure, backend, "cpu")
    bad, worst = TR.mismatches(stored_pressure, eng, done)
    assert not bad, bad
    assert worst <= 1e-3
    assert not any(launches.values())
    assert eng.metrics["commits"] == TR.expected_commits(stored_pressure) - 4


@pytest.fixture(scope="module")
def stored_sampled():
    return TR.load(SAMPLED_FIXTURE)


def test_sampled_fixture_equals_the_live_jax_record(stored_sampled):
    """The sampled record: the live JAX engine's run of the pressure trace
    at temperature 0.7, top-p 0.9 and 8 ticks per dispatch (the archive,
    its ``min_margin`` included, equals a fresh run's; replaying the draws
    with the port's PRNG gives every recorded token), packs that exited
    early, and tokens other than the greedy record's."""
    fresh = jax_sampled_record()
    assert_archive_equals(SAMPLED_FIXTURE, fresh)
    rec = stored_sampled
    s = rec["settings"]
    assert (s["temperature"], s["top_p"], s["ticks_per_dispatch"]) == \
        (0.7, 0.9, 8)
    c = rec["counters"]
    assert c["dispatches"] < c["ticks"]
    assert c["early_exit_finish"] + c["early_exit_headroom"] >= 1
    assert c["preemptions"] > 0 and c["prefix_hits"] > 0
    assert rec["tokens"] != TR.load(PRESSURE_FIXTURE)["tokens"]
    print(f"min_margin {rec['min_margin']:.6g} (bar {MARGIN_BAR:.6g})")
    assert rec["min_margin"] >= MARGIN_BAR


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_port_replays_the_sampled_record_on_the_cpu(stored_sampled,
                                                    backend):
    """The sampled record through ``trace_record.replay`` on the CPU: the
    record's tokens, logits within 1e-3, counters (dispatches and early
    exits among them) and audit."""
    eng, done, launches = TR.replay(stored_sampled, backend, "cpu")
    assert eng.ticks_per_dispatch == 8 and eng.cfg.temperature == 0.7
    bad, worst = TR.mismatches(stored_sampled, eng, done)
    assert not bad, bad
    assert worst <= 1e-3
    assert not any(launches.values())


@pytest.fixture(scope="module", params=POLICY_RECORDS)
def policy_record(request):
    """(name, the stored record, the live JAX engine's fresh record)."""
    name = request.param
    return name, TR.load(POLICY_FIXTURES[name]), jax_policy_record(name)


def test_policy_fixtures_equal_the_live_jax_records(policy_record):
    """The rkv and uniform records: the live engine's runs of the pressure
    trace under each policy with the drift probe on (archive equal to a
    fresh run's, drift included), one probe per request, the policy's
    own counters (uniform's oldest-first eviction preempts more than the
    thought-ranked policies)."""
    name, rec, fresh = policy_record
    assert_archive_equals(POLICY_FIXTURES[name], fresh)
    s = rec["settings"]
    assert (s["policy"], s["drift_probe"]) == (name, True)
    assert rec["counters"]["drift_probes"] == len(PT.LENS)
    assert sorted(rec["drift"]) == list(range(len(PT.LENS)))
    for d in rec["drift"].values():
        assert d["steps"] == PT.MAX_NEW and np.isfinite(d["max_abs"])
    assert rec["counters"]["preemptions"] > 0
    assert rec["counters"]["cow_faults"] > 0


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_port_replays_the_policy_records_on_the_cpu(policy_record, backend):
    """Each policy record through ``trace_record.replay`` on the CPU: the
    record's tokens, logits within 1e-3, counters, audit and each
    request's drift (steps and top-1 agreement equal, magnitudes within
    ``trace_record.DRIFT_ATOL``)."""
    name, rec, _ = policy_record
    eng, done, launches = TR.replay(rec, backend, "cpu")
    assert eng.policy.name == name and eng.drift_probe
    bad, worst = TR.mismatches(rec, eng, done)
    assert not bad, bad
    assert worst <= 1e-3
    assert not any(launches.values())


def write_policy_fixtures() -> None:
    for name, path in POLICY_FIXTURES.items():
        np.savez(path, **jax_policy_record(name))


@pytest.fixture(scope="module", params=sorted(ARCH_RECORDS))
def arch_record(request):
    """(name, the stored record, the live JAX engine's fresh record)."""
    name = request.param
    return name, TR.load(ARCH_FIXTURES[name]), jax_arch_record(name)


def test_arch_fixtures_equal_the_live_jax_records(arch_record):
    """The moe, qwen2 and vlm records: the live engine's runs of the
    pressure trace on mixtral-8x7b's, qwen2-7b's and paligemma-3b's smoke
    configs (archive equal to a fresh run's), the config's family and
    heads, qwen2's non-zero biases in the stored parameters, paligemma's
    tied embedding (no lm_head) and frontend, and a run that preempts and
    hits the prefix cache."""
    name, rec, fresh = arch_record
    assert_archive_equals(ARCH_FIXTURES[name], fresh)
    s = rec["settings"]
    assert s["model"] == ARCH_RECORDS[name]
    assert (s["num_heads"], s["num_kv_heads"]) == \
        ((4, 1) if name == "vlm" else (4, 2))
    attn = rec["params"]["layers"]["attn"]
    if name == "qwen2":
        assert min(float(np.abs(attn[b]).max()) for b in
                   ("bq", "bk", "bv")) > BIAS_SCALE
    elif name == "vlm":
        assert "lm_head" not in rec["params"]["embed"]
        assert rec["params"]["frontend"]["proj"].shape == (32, 64)
        assert attn["wk"].shape == (2, 64, 16)
    else:
        assert "bq" not in attn
        assert rec["params"]["layers"]["moe"]["w_up"].shape == \
            (2, 4, 64, 128)
    assert rec["counters"]["preemptions"] > 0
    assert rec["counters"]["prefix_hits"] > 0
    assert [len(p) for p in rec["prompts"]] == list(PT.LENS)
    assert all(len(t) == PT.MAX_NEW for t in rec["tokens"].values())


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_port_replays_the_arch_records_on_the_cpu(arch_record, backend):
    """Each arch record through ``trace_record.replay`` on the CPU: the
    record's tokens, logits within 1e-3, counters and audit."""
    name, rec, _ = arch_record
    eng, done, launches = TR.replay(rec, backend, "cpu")
    assert eng.mcfg.name == ARCH_RECORDS[name] + "-smoke"
    bad, worst = TR.mismatches(rec, eng, done)
    assert not bad, bad
    assert worst <= 1e-3
    assert not any(launches.values())


def write_arch_fixtures() -> None:
    for name, path in ARCH_FIXTURES.items():
        np.savez(path, **jax_arch_record(name))


if __name__ == "__main__":
    write_fixture()
    write_pressure_fixture()
    write_sampled_fixture()
    write_policy_fixtures()
    write_arch_fixtures()
    for path in (FIXTURE, PRESSURE_FIXTURE, SAMPLED_FIXTURE,
                 *POLICY_FIXTURES.values(), *ARCH_FIXTURES.values()):
        print(f"wrote {path}: {os.path.getsize(path)} bytes")
