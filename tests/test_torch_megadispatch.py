"""Sampling at temperature > 0, the multi-tick mega-dispatch and COW-forked
generation: the port's ThinKVEngine and orchestrator against the JAX
package's, in the same process, with the JAX parameters carried across.

Against the live JAX engine (one run per setting, shared by module
fixtures), on the pressure trace of ``tests/test_torch_pressure.py`` (a
14-block pool for 3 slots, the prefix cache on): greedy at 8 ticks per
dispatch, and sampled at temperature 0.7 / top-p 0.9 at 1 and 8 ticks per
dispatch (the JAX trace suite's ``mega_pressure_cells`` and
``temperature_cells`` settings) — identical tokens, per-request logits
within 1e-3, equal counters (dispatches, early exits and the preemption
counters among them) and pool audit, every spill's sampling key equal to
the JAX spill's; the port's sampled runs at 1 and 8 ticks per dispatch
bit-identical to each other.  Also an eos token emitted mid-pack, and
forked generation at temperature 0.7 through both orchestrators (the
children's sampled tokens, the fork counters).

Then the port's version of each test in ``tests/test_megadispatch.py`` but
the launch audit (the JAX census has no PyTorch meaning; the port's K1
launches per tick are counted on the card), and a preempted request at
temperature > 0 resuming its stream bit-exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import ServeConfig as JSC  # noqa: E402
from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.serving.engine import ThinKVEngine as JaxEngine  # noqa: E402
from repro.serving.orchestrator import Orchestrator as JaxOrch  # noqa: E402
from repro_torch.config import ServeConfig, ThinKVConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import (MultiTickResult,  # noqa: E402
                                        ThinKVEngine, TickResult)
from repro_torch.serving.orchestrator import Orchestrator  # noqa: E402
import test_torch_pressure as PT  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    several pytest workers on one host the threads' wake-ups dominate:
    run this module's torch ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

COUNTERS = PT.COUNTERS + ("dispatches", "early_exit_finish",
                          "early_exit_headroom", "forks", "fork_cow_faults",
                          "peak_refcount")
SAMPLED = (0.7, 0.9)
# the smoke setting of tests/test_megadispatch.py
TK = dict(refresh_interval=16, group_size=8, block_size=8, token_budget=48,
          retention_schedule=(16, 8, 4), min_retention=4, max_segments=64,
          kmeans_iters=4)


def spill_keys(eng):
    """Wrap ``eng._preempt``: the sampling key of each spill it makes."""
    preempt, log = eng._preempt, []

    def wrapped(slot):
        arrival = slot.request.arrival
        preempt(slot)
        log.append(np.asarray(eng._spilled[arrival].rng)
                   .astype(np.int64).tolist())
    eng._preempt = wrapped
    return log


def jax_pressure(temperature, top_p, tpd, params=None):
    eng = JaxEngine(JSC(model=PT.jax_model(), thinkv=JTK(**PT.TK),
                        max_seqs=PT.SLOTS, temperature=temperature,
                        top_p=top_p),
                    params=params, backend="reference",
                    pool_blocks=PT.pool_blocks(), record_logits=True,
                    prefix_cache=True, ticks_per_dispatch=tpd)
    keys = spill_keys(eng)
    eng.submit(PT.prompts(), max_new_tokens=PT.MAX_NEW,
               priorities=PT.PRIORITIES)
    return eng, eng.run(), keys


def port_pressure(params, backend, temperature, top_p, tpd):
    eng = ThinKVEngine(
        ServeConfig(model=PT.port_model(), thinkv=ThinKVConfig(**PT.TK),
                    max_seqs=PT.SLOTS, temperature=temperature, top_p=top_p),
        params=params_from_numpy(params, PT.port_model(), "cpu"),
        backend=backend, pool_blocks=PT.pool_blocks(), record_logits=True,
        prefix_cache=True, device="cpu", ticks_per_dispatch=tpd)
    keys = spill_keys(eng)
    eng.submit(PT.prompts(), max_new_tokens=PT.MAX_NEW,
               priorities=PT.PRIORITIES)
    return eng, eng.run(), keys


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine on the pressure trace, by (temperature, top_p,
    ticks per dispatch): greedy at 8, sampled at 1 and 8."""
    runs = {(0.0, 1.0, 8): jax_pressure(0.0, 1.0, 8)}
    params = runs[(0.0, 1.0, 8)][0].params
    for tpd in (1, 8):
        runs[SAMPLED + (tpd,)] = jax_pressure(*SAMPLED, tpd, params)
    return runs, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    return {(backend,) + k: port_pressure(jax_runs[1], backend, *k)
            for k in jax_runs[0] for backend in ("reference", "kernel")}


def outputs(done):
    return {int(r.uid): list(r.output) for r in done}


def assert_same_run(jax_run, port_run):
    je, jdone, jkeys = jax_run
    pe, pdone, pkeys = port_run
    assert outputs(pdone) == outputs(jdone)
    assert all(len(t) == PT.MAX_NEW for t in outputs(pdone).values())
    assert sorted(pe.request_logits) == sorted(je.request_logits)
    for a in je.request_logits:
        np.testing.assert_allclose(np.stack(pe.request_logits[a]),
                                   np.stack(je.request_logits[a]), rtol=0,
                                   atol=1e-3, err_msg=str(a))
    assert {k: int(pe.metrics[k]) for k in COUNTERS} == \
        {k: int(je.metrics[k]) for k in COUNTERS}
    assert pe.audit_pool() == je.audit_pool()
    assert pkeys == jkeys


SETTINGS = [(0.0, 1.0, 8), SAMPLED + (1,), SAMPLED + (8,)]


@pytest.mark.parametrize("backend", ["reference", "kernel"])
@pytest.mark.parametrize("setting", SETTINGS,
                         ids=["greedy-tpd8", "sampled-tpd1", "sampled-tpd8"])
def test_pressure_trace_matches_jax(jax_runs, port_runs, setting, backend):
    """Tokens, logits within 1e-3, every counter (dispatches, early exits,
    preemptions, resumes, prefix hits, COW faults ...), the audit and the
    spills' sampling keys equal the JAX engine's."""
    assert_same_run(jax_runs[0][setting], port_runs[(backend,) + setting])
    m = port_runs[(backend,) + setting][0].metrics
    assert m["preemptions"] > 0 and m["prefix_hits"] > 0
    if setting[2] == 8:
        assert m["dispatches"] < m["ticks"]
        assert m["early_exit_finish"] + m["early_exit_headroom"] >= 1


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_sampled_runs_are_schedule_invariant(port_runs, backend):
    """The port's sampled runs at 1 and 8 ticks per dispatch give the same
    tokens and bit-identical logits per request, and other tokens than the
    greedy run."""
    one, eight = (port_runs[(backend,) + SAMPLED + (t,)] for t in (1, 8))
    assert outputs(one[1]) == outputs(eight[1])
    for a, seq in one[0].request_logits.items():
        np.testing.assert_array_equal(np.stack(seq),
                                      np.stack(eight[0].request_logits[a]))
    assert outputs(one[1]) != outputs(port_runs[(backend, 0.0, 1.0, 8)][1])


def test_eos_mid_pack_on_both_engines(jax_runs):
    """An eos token that a request samples inside a pack (its 6th token in
    the greedy tpd-8 run) ends that request there and the pack after that
    trip, in both engines: the same tokens, counters and audit."""
    je, jdone, _ = jax_runs[0][(0.0, 1.0, 8)]
    eos = outputs(jdone)[0][5]
    runs = []
    for make in (lambda: JaxEngine(
            JSC(model=PT.jax_model(), thinkv=JTK(**PT.TK),
                max_seqs=PT.SLOTS), params=je.params, backend="reference",
            pool_blocks=PT.pool_blocks(), record_logits=True,
            prefix_cache=True, ticks_per_dispatch=8),
            lambda: ThinKVEngine(
            ServeConfig(model=PT.port_model(), thinkv=ThinKVConfig(**PT.TK),
                        max_seqs=PT.SLOTS),
            params=params_from_numpy(jax_runs[1], PT.port_model(), "cpu"),
            backend="kernel", pool_blocks=PT.pool_blocks(),
            record_logits=True, prefix_cache=True, device="cpu",
            ticks_per_dispatch=8)):
        eng = make()
        eng.submit(PT.prompts(), max_new_tokens=PT.MAX_NEW, eos_token=eos,
                   priorities=PT.PRIORITIES)
        runs.append((eng, outputs(eng.run())))
    (je2, jout), (pe, pout) = runs
    assert pout == jout
    assert pout[0][-1] == eos and len(pout[0]) <= 6
    assert {k: int(pe.metrics[k]) for k in COUNTERS} == \
        {k: int(je2.metrics[k]) for k in COUNTERS}
    assert pe.metrics["early_exit_finish"] >= 1
    assert pe.audit_pool() == je2.audit_pool()


def fork_jax_and_port(temperature, tpd):
    """One prompt of 24 tokens, 64 new, ``samples_per_slot=2`` on 2 slots
    (budget 48: eviction inside the shared prompt blocks makes a commit
    COW-fault), served by both orchestrators."""
    prompt = np.random.default_rng(0).integers(0, 256, 24)
    je = JaxEngine(JSC(model=jax_smoke("r1-llama-8b"), thinkv=JTK(**TK),
                       max_seqs=2, temperature=temperature),
                   backend="reference", allow_forks=True,
                   ticks_per_dispatch=tpd, record_logits=True)
    jorch = JaxOrch(je)
    jstream = jorch.submit(prompt, max_new_tokens=64, samples_per_slot=2)
    jorch.run_sync()
    mc = get_smoke_config("r1-llama-8b")
    pe = ThinKVEngine(
        ServeConfig(model=mc, thinkv=ThinKVConfig(**TK), max_seqs=2,
                    temperature=temperature),
        params=params_from_numpy(jax.tree.map(np.asarray, je.params), mc,
                                 "cpu"),
        backend="kernel", allow_forks=True, ticks_per_dispatch=tpd,
        record_logits=True, device="cpu")
    porch = Orchestrator(pe)
    pstream = porch.submit(prompt, max_new_tokens=64, samples_per_slot=2)
    porch.run_sync()
    return (je, jstream, jorch), (pe, pstream, porch)


def test_sampled_forks_match_jax():
    """Forked generation at temperature 0.7, 4 ticks per dispatch: the
    parent's and the child's sampled tokens, the fork counters (forks,
    fork COW faults, peak refcount), the audit and the orchestrator's
    event sequence (submit, prefill, fork, dispatch ...) equal the JAX
    engine's; the child diverges from its parent."""
    (je, js, jo), (pe, ps, po) = fork_jax_and_port(0.7, 4)
    for j, p in ((js, ps), (js.forks[0], ps.forks[0])):
        assert p.request.output == j.request.output
        assert p.request.arrival == j.request.arrival
    assert ps.forks[0].request.output != ps.request.output
    assert {k: int(pe.metrics[k]) for k in COUNTERS} == \
        {k: int(je.metrics[k]) for k in COUNTERS}
    assert pe.metrics["forks"] == 1 and pe.metrics["fork_cow_faults"] >= 1
    assert pe.audit_pool() == je.audit_pool()
    # the event logs agree but for XLA's retrace events (no port meaning)
    assert [e["kind"] for e in po.events] == \
        [e["kind"] for e in jo.events if e["kind"] != "retrace"]


# ----------------------------------------------------------------------
# the port's versions of tests/test_megadispatch.py (port only)
# ----------------------------------------------------------------------


def _cfg(slots=3, temperature=0.0, top_p=1.0, **tk_over):
    tk = ThinKVConfig(**dict(TK, **tk_over))
    return ServeConfig(model=get_smoke_config("r1-llama-8b"), thinkv=tk,
                       max_seqs=slots, temperature=temperature, top_p=top_p)


def _engine(cfg, **kw):
    return ThinKVEngine(cfg, backend="reference", device="cpu", **kw)


def _prompts(rng, n, lo=6, hi=14):
    vocab = get_smoke_config("r1-llama-8b").vocab_size
    return [rng.integers(0, vocab, rng.integers(lo, hi)) for _ in range(n)]


def test_mega_dispatch_greedy_parity_and_dispatch_amortization(rng):
    cfg = _cfg()
    prompts = _prompts(rng, 4)
    eng1 = _engine(cfg)
    eng1.submit([p.copy() for p in prompts], max_new_tokens=24)
    out1 = outputs(eng1.run())
    eng8 = _engine(cfg, params=eng1.model, ticks_per_dispatch=8)
    eng8.submit([p.copy() for p in prompts], max_new_tokens=24)
    out8 = outputs(eng8.run())
    assert out1 == out8
    eng1.audit_pool(), eng8.audit_pool()
    assert eng8.metrics["ticks"] == eng1.metrics["ticks"]
    assert eng8.metrics["dispatches"] < eng8.metrics["ticks"]
    assert eng8.metrics["dispatches"] / eng8.metrics["tokens"] < 1.0


def test_mega_dispatch_temperature_parity(rng):
    cfg = _cfg(temperature=0.7, top_p=0.9)
    prompts = _prompts(rng, 3)
    eng1 = _engine(cfg)
    eng1.submit([p.copy() for p in prompts], max_new_tokens=16)
    out1 = outputs(eng1.run())
    eng4 = _engine(cfg, params=eng1.model, ticks_per_dispatch=4)
    eng4.submit([p.copy() for p in prompts], max_new_tokens=16)
    assert outputs(eng4.run()) == out1
    greedy = _engine(dataclasses.replace(cfg, temperature=0.0),
                     params=eng1.model)
    greedy.submit([p.copy() for p in prompts], max_new_tokens=16)
    assert outputs(greedy.run()) != out1


def test_early_exit_on_finish_and_packed_validity(rng):
    eng = _engine(_cfg(slots=2), ticks_per_dispatch=8)
    eng.submit([p.copy() for p in _prompts(rng, 2)], max_new_tokens=12)
    done = eng.run()
    assert len(done) == 2
    assert eng.metrics["early_exit_finish"] >= 1
    assert all(len(r.output) == 12 for r in done)


def test_packed_result_semantics_direct(rng):
    """generate / consume by hand: the packed result, its trip count, the
    per-trip validity and the zero rows past the executed trips."""
    import asyncio
    eng = _engine(_cfg(slots=1), ticks_per_dispatch=4)
    eng.submit(_prompts(rng, 1), max_new_tokens=3)   # prefill + 2 ticks
    orch = Orchestrator(eng)

    async def one_pack():
        await orch._admit_and_prefill()
        return eng.generate()

    res = asyncio.run(one_pack())
    assert isinstance(res, MultiTickResult) and res.packed
    eng.consume(res)
    assert res.requested == 4
    assert res.trips_host == 2
    assert res.valid_host[:2, 0].all()
    assert not res.valid_host[2:].any()
    assert (res.tokens_host[2:] == 0).all()
    assert res.logits_host.shape[0] == 4 and not res.logits_host[2:].any()
    assert eng.metrics["ticks"] == 2
    assert eng.metrics["early_exit_finish"] == 1


def test_single_tick_mode_returns_unpacked_result(rng):
    eng = _engine(_cfg(slots=1))
    assert eng.ticks_per_dispatch == 1
    eng.submit(_prompts(rng, 1), max_new_tokens=4)
    assert len(eng.run()) == 1
    assert not TickResult.packed
    assert eng.metrics["dispatches"] == eng.metrics["ticks"] == 3


def test_safe_trips_shrink_under_pool_pressure(rng):
    cfg = _cfg(slots=2, token_budget=32)
    prompts = _prompts(rng, 2, lo=8, hi=9)
    pool_blocks = max(2 * (32 + TK["group_size"]) // TK["block_size"], 8)
    eng = _engine(cfg, ticks_per_dispatch=8, pool_blocks=pool_blocks)
    eng.submit([p.copy() for p in prompts], max_new_tokens=40)
    done = eng.run()
    assert len(done) == 2 and all(len(r.output) == 40 for r in done)
    assert eng.metrics["early_exit_headroom"] >= 1
    eng.audit_pool()


def test_fork_slot_shares_blocks_and_emits_parent_tokens():
    """Greedy: the fork shares the parent's blocks (refcount > 1), pays
    its divergence in COW faults and emits its parent's tokens; the
    counters equal the JAX engine's."""
    (je, js, _), (pe, ps, _) = fork_jax_and_port(0.0, 1)
    assert pe.metrics["forks"] == 1
    assert pe.metrics["peak_refcount"] > 1
    assert ps.forks[0].request.output == ps.request.output == \
        js.request.output
    assert pe.metrics["fork_cow_faults"] >= 1
    assert {k: int(pe.metrics[k]) for k in COUNTERS} == \
        {k: int(je.metrics[k]) for k in COUNTERS}
    pe.audit_pool()


def test_fork_shared_blocks_are_immutable(rng):
    """Every block still shared after four more packs holds the planes it
    held at the fork: writers COW-faulted away instead."""
    import asyncio
    eng = _engine(_cfg(slots=2, token_budget=32), ticks_per_dispatch=4,
                  allow_forks=True)
    orch = Orchestrator(eng)
    prompt = _prompts(rng, 1, lo=16, hi=17)[0]

    async def fork_then_snapshot():
        orch.submit(prompt, max_new_tokens=40, samples_per_slot=2)
        orch.close()
        await orch._admit_and_prefill()          # prefill the parent
        eng.consume(eng.generate())              # the parent decodes a pack
        await orch._admit_and_prefill()          # the fork lands here
        assert eng.metrics["forks"] == 1
        shared0 = eng.pool.refcount.numpy() > 1
        assert shared0.any()
        planes0 = [p.clone() for p in eng.pool.view]
        for _ in range(4):                       # both sides diverge
            eng.consume(eng.generate())
        still = shared0 & (eng.pool.refcount.numpy() > 1)
        assert still.any()
        for p0, p1 in zip(planes0, eng.pool.view):
            for l in range(still.shape[0]):
                m = torch.as_tensor(still[l])
                assert torch.equal(p0[l][m], p1[l][m]), \
                    "shared block planes were written in place"

    asyncio.run(fork_then_snapshot())


def test_preempted_sampled_request_resumes_its_stream_bit_exact(rng):
    """At temperature 0.7 a request preempted after 5 ticks (spilled with
    its key) and resumed gives the tokens and bit-identical logits of the
    same request served without the pause."""
    import asyncio
    cfg = _cfg(slots=1, temperature=0.7, top_p=0.9)
    prompt = _prompts(rng, 1, lo=20, hi=21)[0]
    plain = _engine(cfg, record_logits=True)
    plain.submit([prompt.copy()], max_new_tokens=20)
    want = plain.run()[0]
    eng = _engine(cfg, params=plain.model, record_logits=True)
    eng.submit([prompt.copy()], max_new_tokens=20)
    orch = Orchestrator(eng)

    async def pause_and_resume():
        await orch._admit_and_prefill()
        for _ in range(5):
            res = eng.consume(eng.generate())
            slot = eng.scheduler.active_slots()[0]
            orch._record_logits(slot.request, res.logits_host[0])
            orch._finish_token(slot, int(res.tokens_host[0]), res.tick)
        slot = eng.scheduler.active_slots()[0]
        key, arrival = eng._slot_keys[0].clone(), slot.request.arrival
        eng._preempt(slot)
        st = eng._spilled[arrival]
        assert torch.equal(torch.as_tensor(st.rng), key)
        eng._slot_keys[0] = torch.tensor([1, 2])   # the slot's key moves on
        orch.close()
        return await orch.serve()

    done = asyncio.run(pause_and_resume())
    assert eng.metrics["preemptions"] == eng.metrics["resumes"] == 1
    assert done[0].output == want.output
    np.testing.assert_array_equal(np.stack(eng.request_logits[0]),
                                  np.stack(plain.request_logits[0]))
