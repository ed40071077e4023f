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
and reference backends to them, where there is no JAX.

The hybrid and encdec records (``tests/golden/torch_{hybrid,encdec}
_steps.npz``, read by ``test_torch_steps_record``) are the JAX
package's serve steps on zamba2-7b's smoke form with a tail at head_dim
112 (5 layers, a shared block after every 2nd, 4 q / 4 kv heads) and on
whisper-medium's: weights from
``test_torch_steps_record.numpy_params`` (a numpy seed), the prefill step, 8 FullKV steps over the prompts from an empty
state, and 8 ThinKV steps on a numpy-seeded pool on both JAX backends
(the kernel backend through the Pallas kernel in interpret mode).  The golden
``serving_trace.json`` is not such a record (it dates from an older tree:
its flash tokens and its pressure tokens no longer match the reference,
its pressure counters still do).

A test here re-runs the JAX engine on each trace and asserts that the
archive equals the fresh record, so a file cannot go stale silently.  To
write all eight anew (after a change to the reference engine or to these
settings):

    PYTHONPATH=src python tests/test_torch_trace_fixture.py

and to write only the two steps records:

    PYTHONPATH=src:tests python -c "import test_torch_trace_fixture as T;
        T.write_steps_fixtures()"
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ServeConfig as JSC  # noqa: E402
from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import quantization as QJ  # noqa: E402
from repro.layers import ssm as SJ  # noqa: E402
from repro.models import encdec as EJ  # noqa: E402
from repro.serving import serve_step as SSJ  # noqa: E402
from repro.serving.engine import ThinKVEngine as JaxEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import prng  # noqa: E402
from repro_torch.serving import sampling as SMP  # noqa: E402
from repro_torch.serving import trace_record as TR  # noqa: E402
import test_torch_pressure as PT  # noqa: E402
import test_torch_steps_record as SR  # noqa: E402
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


# record -> (arch, the overrides of ``reduced`` for its smoke form)
STEPS_RECORDS = {
    "hybrid": ("zamba2-7b", dict(num_layers=5, hybrid_attn_every=2,
                                 num_heads=4, num_kv_heads=4, head_dim=112)),
    "encdec": ("whisper-medium", {})}
STEPS_FIXTURES = {name: os.path.join(GOLDEN, f"torch_{name}_steps.npz")
                  for name in STEPS_RECORDS}
STEPS_TK = dict(refresh_interval=16, group_size=16, block_size=8,
                token_budget=32, retention_schedule=(16, 8, 4),
                min_retention=4, max_segments=64, kmeans_iters=2)
STEPS_B, STEPS_S, STEPS_N = 2, 8, 8      # requests, prompt, ThinKV steps


def steps_settings(name: str) -> dict:
    arch, over = STEPS_RECORDS[name]
    return {"family": name, "arch": arch, "overrides": over,
            "thinkv": STEPS_TK, "params_seed": 0, "batch_seed": 1,
            "steps": STEPS_N}


def jax_steps_record(name: str) -> dict:
    """The JAX serve steps' run of a steps record, as the archive's arrays
    (see ``test_torch_steps_record``)."""
    st = steps_settings(name)
    arch, over = STEPS_RECORDS[name]
    jcfg = jax_reduced(jax_config(arch), **over)
    tcfg, tk = SR.config(st), SR.thinkv_config(st)
    jp = jax.tree.map(jnp.asarray, SR.numpy_params(tcfg, st["params_seed"]))
    hybrid = name == "hybrid"
    b, s = STEPS_B, STEPS_S
    rng = np.random.default_rng(2)
    out = {"settings": np.asarray(json.dumps(st)),
           "prompts": rng.integers(0, jcfg.vocab_size, (b, s))
           .astype(np.int32)}
    pre = {"tokens": jnp.asarray(out["prompts"])}
    if not hybrid:
        out["frames"] = rng.standard_normal(
            (b, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
        pre["frames"] = jnp.asarray(out["frames"])
    out["prefill_logits"] = np.asarray(
        SSJ.make_prefill_step(None, jcfg)(jp, pre))

    shape = (b, jcfg.num_attention_layers(), s, jcfg.num_kv_heads,
             jcfg.head_dim)
    fb = {"k_cache": jnp.zeros(shape), "v_cache": jnp.zeros(shape)}
    if hybrid:
        di, nh, hp, g, n, cw = SJ.mamba2_dims(jcfg)
        fb["conv_state"] = jnp.zeros((b, jcfg.num_layers, cw, di + 2 * g * n))
        fb["ssm_state"] = jnp.zeros((b, jcfg.num_layers, nh, hp, n))
    else:
        ck, cv = EJ.cross_caches(jp, EJ.encode(jp, pre["frames"], jcfg), jcfg)
        fb["cross_k"], fb["cross_v"] = (jnp.moveaxis(c, 0, 1)
                                        for c in (ck, cv))
    step_f = SSJ.make_decode_step_fullkv(jcfg)
    logits = []
    for i in range(s):
        pos = jnp.full((b,), i, jnp.int32)
        res = step_f(jp, {**fb, "tokens": pre["tokens"][:, i],
                          "positions": pos, "cache_len": pos})
        if hybrid:
            lg, fb["conv_state"], fb["ssm_state"], fb["k_cache"], \
                fb["v_cache"] = res
        else:
            lg, fb["k_cache"], fb["v_cache"] = res
        logits.append(np.asarray(lg))
    out["fullkv_logits"] = np.stack(logits)
    if hybrid:
        out["fullkv_conv"] = np.asarray(fb["conv_state"])
        out["fullkv_ssm"] = np.asarray(fb["ssm_state"])

    batch = SR.thinkv_batch(tcfg, tk, st["batch_seed"], b, s)
    out.update(batch)
    jb0 = {k: jnp.asarray(v.view(jnp.bfloat16) if k in SR.BF16_KEYS else v)
           for k, v in batch.items()}
    if hybrid:
        jb0["conv_state"], jb0["ssm_state"] = fb["conv_state"], \
            fb["ssm_state"]
    else:
        for n, c in (("k", fb["cross_k"]), ("v", fb["cross_v"])):
            codes, scales = QJ.quantize_group(c, 4)
            jb0[f"cross_{n}_codes"] = codes
            jb0[f"cross_{n}_scales"] = scales.astype(jnp.bfloat16)
            out[f"cross_{n}_codes"] = np.asarray(codes)
            out[f"cross_{n}_scales"] = np.asarray(
                jb0[f"cross_{n}_scales"]).view(np.uint16)
    toks = [np.argmax(out["prefill_logits"], -1).astype(np.int32)]
    for backend in ("reference", "kernel"):
        step = SSJ.make_decode_step_thinkv(
            jcfg, JTK(**STEPS_TK), backend=backend,
            force="pallas" if backend == "kernel" else None)
        jb, lgs = dict(jb0), []
        for i in range(STEPS_N):
            jb["tokens"] = jnp.asarray(toks[i])
            res = step(jp, jb)
            if hybrid:
                jb["conv_state"], jb["ssm_state"] = res[1:3]
            jb["buf_k"], jb["buf_v"], jb["buf_len"] = res[-3:]
            jb["positions"] = jb["positions"] + 1
            lgs.append(np.asarray(res[0]))
            if backend == "reference" and i + 1 < STEPS_N:
                toks.append(np.argmax(lgs[-1], -1).astype(np.int32))
        out[f"thinkv_logits_{backend}"] = np.stack(lgs)
    out["thinkv_tokens"] = np.stack(toks)
    out["final_buf_k"] = np.asarray(jb["buf_k"]).view(np.uint16)
    out["final_buf_v"] = np.asarray(jb["buf_v"]).view(np.uint16)
    out["final_buf_len"] = np.asarray(jb["buf_len"])
    if hybrid:
        out["final_conv"] = np.asarray(jb["conv_state"])
        out["final_ssm"] = np.asarray(jb["ssm_state"])
    return out


@pytest.fixture(scope="module", params=sorted(STEPS_RECORDS))
def steps_record(request):
    """(name, the stored record, the live JAX steps' fresh record)."""
    name = request.param
    return name, SR.load(STEPS_FIXTURES[name]), jax_steps_record(name)


def test_steps_fixtures_equal_the_live_jax_records(steps_record):
    """The hybrid and encdec records: the live JAX serve steps' runs
    (archive equal to a fresh run's: inputs and integers exactly, floats
    to 1e-6), the smoke form's shapes (zamba2 at head_dim 112 with a tail
    and 2 shared-block invocations; whisper's 16 frames), each record
    under 1 MB, and both JAX backends within the bar of each other."""
    name, rec, fresh = steps_record
    path = STEPS_FIXTURES[name]
    assert os.path.getsize(path) < 1 << 20
    with np.load(path, allow_pickle=False) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in fresh:
            if z[k].dtype == np.float32:
                np.testing.assert_allclose(z[k], fresh[k], rtol=0,
                                           atol=1e-6, err_msg=k)
            else:
                assert z[k].dtype == fresh[k].dtype, k
                np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
    cfg = SR.config(rec["settings"])
    if name == "hybrid":
        assert (cfg.head_dim, cfg.num_attention_layers()) == (112, 2)
        assert rec["k_codes"].shape == (STEPS_B, 2, 8, 8, 4, 112)
        assert rec["final_ssm"].shape[1] == 5
    else:
        assert rec["frames"].shape == (STEPS_B, 16, 64)
        assert rec["cross_k_codes"].shape == (STEPS_B, 2, 16, 2, 16)
    assert rec["thinkv_tokens"].shape == (STEPS_N, STEPS_B)
    np.testing.assert_allclose(rec["fullkv_logits"][-1],
                               rec["prefill_logits"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(rec["thinkv_logits_kernel"],
                               rec["thinkv_logits_reference"], rtol=0,
                               atol=0.05)
    np.testing.assert_array_equal(rec["final_buf_len"],
                                  rec["buf_len"] + STEPS_N)


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_port_replays_the_steps_records_on_the_cpu(steps_record, backend):
    """Each steps record through ``test_torch_steps_record.replay`` on the
    CPU: the prefill and FullKV logits within 1e-4; the ThinKV logits over
    the 8 chained steps within 1e-3 of the same JAX backend's on the
    kernel backend; on the reference backend the first step within 1e-3
    and the chain within 2e-3 (``THINKV_CHAIN_ATOL``: its bf16 rounding of
    queries and probabilities flips now and then); the final buffers
    (kernel backend) within one bf16 step; the hybrid's states;
    buf_len."""
    name, rec, _ = steps_record
    launches = dict(ops.LAUNCHES)
    res = SR.replay(rec, backend, "cpu")
    assert not res["failed"], res
    assert ops.LAUNCHES == launches
    print(name, backend, {k: res[k] for k in ("prefill", "fullkv",
                                              "thinkv")})


def write_steps_fixtures() -> None:
    for name, path in STEPS_FIXTURES.items():
        np.savez(path, **jax_steps_record(name))


if __name__ == "__main__":
    write_fixture()
    write_pressure_fixture()
    write_sampled_fixture()
    write_policy_fixtures()
    write_arch_fixtures()
    write_steps_fixtures()
    for path in (FIXTURE, PRESSURE_FIXTURE, SAMPLED_FIXTURE,
                 *POLICY_FIXTURES.values(), *ARCH_FIXTURES.values(),
                 *STEPS_FIXTURES.values()):
        print(f"wrote {path}: {os.path.getsize(path)} bytes")
