"""The oversubscribed pool: the port's ThinKVEngine against the JAX
package's on the pressure trace of ``tests/test_serving_traces.py`` (prompts
of 24, 16, 40, 10 and 24 tokens from ``np.random.default_rng(1)``, three of
them sharing a 16-token prefix, priorities 0/1, 24 new tokens, 3 slots, a
pool of ``int(3 * NB * 0.6) = 14`` blocks, the prefix cache on), greedy,
with the JAX parameters carried across.

The port runs on the CPU with both of its backends.  Bars: identical tokens,
per-request logits within 1e-3, equal engine counters (preemptions,
resumes, prefix hits, COW faults among them) and pool audit, every slot
release (preemptions and retirements) and every spill bit-exact — table,
metadata, quantized planes, and the fp buffer to within one bf16 step.
The same trace streamed through the port's orchestrator with staggered
arrivals is held to the JAX orchestrator's streamed run, and its
per-request logits to the port's batch run, bit for bit.  Also: a prefill
detached into the portable form and inserted into another slot, and a
cancellation that drops a spill holding shared references."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import ServeConfig as JSC  # noqa: E402
from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import ct_cache as CJ  # noqa: E402
from repro.serving.engine import ThinKVEngine as JaxEngine  # noqa: E402
from repro.serving.orchestrator import Orchestrator as JaxOrch  # noqa: E402
from repro_torch.config import ServeConfig, ThinKVConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import ct_cache as CT  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.engine import ThinKVEngine  # noqa: E402
from repro_torch.serving.orchestrator import Orchestrator  # noqa: E402
from test_torch_engine import (TK, as_f32, bits, jax_snapshot,  # noqa: E402
                               record_retirements, torch_snapshot)

LENS, PRIORITIES, SHARED_IDX, SHARED_LEN = (24, 16, 40, 10, 24), \
    (0, 1, 0, 1, 0), (0, 2, 4), 16
MAX_NEW, SLOTS, POOL_FRAC, SEED, VOCAB = 24, 3, 0.6, 1, 256
STREAM_ARRIVALS = (0, 0, 2, 5, 8)
COUNTERS = ("ticks", "tokens", "preemptions", "resumes", "prefix_hits",
            "prefix_tokens_skipped", "cow_faults", "prefill_chunks",
            "prefill_big_chunks", "admissions", "queue_wait_ticks",
            "prefill_tokens")
# the live JAX engine's counters on this trace (and the golden file's)
WANT = {"ticks": 47, "tokens": 115, "preemptions": 9, "resumes": 9,
        "prefix_hits": 2, "prefix_tokens_skipped": 32, "cow_faults": 4,
        "prefill_chunks": 11, "prefill_big_chunks": 0, "admissions": 14}
RECIPE = {"seed": SEED, "vocab": VOCAB, "lens": list(LENS),
          "shared_idx": list(SHARED_IDX), "shared_len": SHARED_LEN}


def prompts():
    """The pressure trace's prompts (``generate_trace("pressure")``)."""
    rng = np.random.default_rng(SEED)
    shared = rng.integers(0, VOCAB, SHARED_LEN)
    out = []
    for i, n in enumerate(LENS):
        p = np.concatenate([shared, rng.integers(0, VOCAB, n - SHARED_LEN)]) \
            if i in SHARED_IDX else rng.integers(0, VOCAB, n)
        out.append(p.astype(np.int64))
    return out


def pool_blocks():
    tk = ThinKVConfig(**TK)
    mc = port_model()
    dims = CT.make_dims(tk, mc.num_layers, mc.num_kv_heads, mc.head_dim)
    return int(SLOTS * dims.NB * POOL_FRAC)


def jax_model():
    return dataclasses.replace(jax_smoke("r1-llama-8b"), num_heads=8,
                               num_kv_heads=8)


def port_model():
    return dataclasses.replace(get_smoke_config("r1-llama-8b"),
                               num_heads=8, num_kv_heads=8)


def jax_engine(params=None):
    return JaxEngine(JSC(model=jax_model(), thinkv=JTK(**TK),
                         max_seqs=SLOTS),
                     params=params, backend="reference",
                     pool_blocks=pool_blocks(), record_logits=True,
                     prefix_cache=True)


def port_engine(params, backend):
    return ThinKVEngine(
        ServeConfig(model=port_model(), thinkv=ThinKVConfig(**TK),
                    max_seqs=SLOTS),
        params=params_from_numpy(params, port_model(), "cpu"),
        backend=backend, pool_blocks=pool_blocks(), record_logits=True,
        prefix_cache=True, device="cpu")


def record_spills(eng, snap):
    """Wrap ``eng._preempt`` to snapshot each spill it makes."""
    preempt = eng._preempt
    log = []

    def wrapped(slot):
        arrival = slot.request.arrival
        preempt(slot)
        log.append(snap(eng._spilled[arrival]))
    eng._preempt = wrapped
    return log


def jax_spill(st):
    out = {f: bits(getattr(st.cache, f)) for f in CJ.CTCache.FIELDS}
    out.update({n: bits(p) for n, p in zip(CJ.PoolView._fields, st.view)},
               mapped=np.asarray(st.mapped), shared_table=st.shared_table,
               tokens_out=st.tokens_out, next_token=st.next_token)
    return out


def torch_spill(st):
    def np_(t):
        return t.view(torch.int16).numpy().view(np.uint16) \
            if t.dtype == torch.bfloat16 else t.numpy()
    out = {f: np_(getattr(st.cache, f)) for f in CT.CTCache.FIELDS}
    out.update({n: np_(p) for n, p in zip(CT.PoolView._fields, st.view)},
               mapped=st.mapped, shared_table=st.shared_table,
               tokens_out=st.tokens_out, next_token=st.next_token)
    return out


def assert_same_states(want, got, what):
    """Bit-exact, but the fp buffer to within one bf16 step (f32
    projections summed in another order, ROADMAP queue 3)."""
    assert len(want) == len(got), what
    for n, (w, g) in enumerate(zip(want, got)):
        assert sorted(w) == sorted(g)
        for k in w:
            if k in ("buf_k", "buf_v"):
                np.testing.assert_allclose(as_f32(g[k]), as_f32(w[k]),
                                           rtol=2 ** -7, atol=0,
                                           err_msg=f"{what} {n}: {k}")
            else:
                np.testing.assert_array_equal(g[k], w[k],
                                              err_msg=f"{what} {n}: {k}")


@pytest.fixture(scope="module")
def jax_run():
    eng = jax_engine()
    releases = record_retirements(eng, jax_snapshot)
    spills = record_spills(eng, jax_spill)
    eng.submit(prompts(), max_new_tokens=MAX_NEW, priorities=PRIORITIES)
    done = eng.run()
    return eng, done, releases, spills, jax.tree.map(np.asarray, eng.params)


@pytest.fixture(scope="module", params=["reference", "kernel"])
def port_run(request, jax_run):
    eng = port_engine(jax_run[4], request.param)
    releases = record_retirements(eng, torch_snapshot)
    spills = record_spills(eng, torch_spill)
    launches = dict(ops.LAUNCHES)
    eng.submit(prompts(), max_new_tokens=MAX_NEW, priorities=PRIORITIES)
    done = eng.run()
    assert ops.LAUNCHES == launches        # plain versions on the CPU
    return eng, done, releases, spills


def streamed(orch_cls, eng):
    orch = orch_cls(eng)
    for i, p in enumerate(prompts()):
        orch.schedule_arrival(after_tick=STREAM_ARRIVALS[i], prompt=p,
                              max_new_tokens=MAX_NEW,
                              priority=PRIORITIES[i], uid=i)
    done = orch.run_sync()
    return orch, done


@pytest.fixture(scope="module")
def jax_streamed(jax_run):
    eng = jax_engine(jax_run[0].params)
    orch, done = streamed(JaxOrch, eng)
    return eng, done, orch


def outputs(done):
    return {int(r.uid): list(r.output) for r in done}


def test_identical_greedy_tokens(jax_run, port_run):
    want, got = outputs(jax_run[1]), outputs(port_run[1])
    assert sorted(want) == sorted(got) == list(range(len(LENS)))
    assert all(len(t) == MAX_NEW for t in got.values())
    assert got == want


def test_per_request_logits_within_1e3(jax_run, port_run):
    want, got = jax_run[0].request_logits, port_run[0].request_logits
    assert sorted(want) == sorted(got)
    for a in want:
        w, g = np.stack(want[a]), np.stack(got[a])
        assert w.shape == g.shape == (MAX_NEW, VOCAB)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=str(a))


def test_equal_counters_and_pool_audit(jax_run, port_run):
    je, pe = jax_run[0], port_run[0]
    want = {k: int(je.metrics[k]) for k in COUNTERS}
    assert {k: int(pe.metrics[k]) for k in COUNTERS} == want
    assert {k: want[k] for k in WANT} == WANT
    assert pe.audit_pool() == je.audit_pool() == {
        "claimed": [3, 3], "free": [11, 11], "pool_blocks": 14}
    # the prefix cache's entries and stats agree too
    assert pe.prefix_cache.stats() == je.prefix_cache.stats()
    assert [e.key for e in pe.prefix_cache.lru_entries()] == \
        [e.key for e in je.prefix_cache.lru_entries()]
    # every commit launched K4 once on the card; here the engine counts
    # them: each request's written tokens over g, less the 4 commits the
    # two 16-token prefix hits skipped
    g = TK["group_size"]
    assert pe.metrics["commits"] == \
        sum((n + MAX_NEW - 1) // g for n in LENS) - 32 // g


def test_released_slots_bit_exact(jax_run, port_run):
    """Every ``_release_slot`` — a preemption's private release and each
    retirement — sees the same slot state in both engines."""
    assert len(jax_run[2]) == WANT["preemptions"] + len(LENS)
    assert_same_states(jax_run[2], port_run[2], "release")


def test_spills_bit_exact(jax_run, port_run):
    """Every spill (planes through the table, private mask, retained shared
    ids, cache, host bookkeeping) equals the JAX engine's."""
    assert len(jax_run[3]) == WANT["preemptions"]
    assert any((s["shared_table"] >= 0).any() for s in jax_run[3])
    assert_same_states(jax_run[3], port_run[3], "spill")


def test_streamed_replay_through_the_orchestrator(jax_run, jax_streamed,
                                                  port_run):
    """Staggered tick-space arrivals through the port's orchestrator: the
    per-request logits equal the port's batch run bit for bit (greedy
    logits are schedule-invariant), and tokens, counters and audit equal
    the JAX orchestrator's streamed run; a prefill landed inside another
    request's decode window."""
    eng = port_engine(jax_run[4], port_run[0].backend)
    orch, done = streamed(Orchestrator, eng)
    je, jdone, jorch = jax_streamed
    assert outputs(done) == outputs(jdone)
    assert {k: int(eng.metrics[k]) for k in COUNTERS} == \
        {k: int(je.metrics[k]) for k in COUNTERS}
    assert eng.audit_pool() == je.audit_pool()
    batch = port_run[0].request_logits
    assert sorted(eng.request_logits) == sorted(batch)
    for a in batch:
        np.testing.assert_array_equal(np.stack(eng.request_logits[a]),
                                      np.stack(batch[a]), err_msg=str(a))
    assert orch.prefill_overlaps_decode() == \
        jorch.prefill_overlaps_decode() is True
    assert eng.metrics["preemptions"] > 0 and eng.metrics["prefix_hits"] > 0


def test_detached_prefix_inserts_into_another_slot(jax_run):
    """A prefill detached into the portable form and inserted into another
    slot: physical ids, refcounts and audit equal the JAX engine's doing
    the same, and the slot's planes and metadata are the detached ones."""
    p = prompts()[0]
    je, pe = jax_engine(jax_run[0].params), port_engine(jax_run[4], "kernel")
    jpre, _ = je.prefill(p, 0, None, arrival=0)
    ppre = pe.prefill(p, 0)
    np.testing.assert_allclose(ppre.logits, jpre.logits, rtol=0, atol=1e-3)
    assert ppre.first_token == jpre.first_token
    je.detach_prefix(jpre)
    pe.detach_prefix(ppre)
    assert ppre.slot == -1 and ppre.state is not None
    assert_same_states([jax_spill(jpre.state)], [torch_spill(ppre.state)],
                       "detached")
    assert int(pe.tables[0].max()) == -1
    assert je.insert(jpre, 2) and pe.insert(ppre, 2)
    np.testing.assert_array_equal(pe.tables.numpy(), np.asarray(je.tables))
    np.testing.assert_array_equal(pe.pool.refcount.numpy(),
                                  np.asarray(je.pool.refcount))
    assert pe.audit_pool() == je.audit_pool()
    got = torch_snapshot(pe, 2)
    for k, v in torch_spill(ppre.state).items():
        if k in got:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert pe._slot_ntok[2] == len(p) and pe._feed[2] == ppre.first_token
    with pytest.raises(ValueError):
        pe.insert(pe.prefill(prompts()[1], 1), 0)     # resident elsewhere


def test_cancelling_a_spill_drops_its_shared_references(jax_run):
    """A preempted request whose spill keeps shared references is cancelled
    at a loop boundary: ``drop_spill`` releases those references, the
    orchestrator's audit after the teardown passes, the other requests
    finish, and the pool ends clean."""
    eng = port_engine(jax_run[4], "reference")
    orch = Orchestrator(eng)
    for i, p in enumerate(prompts()):
        orch.submit(p, max_new_tokens=MAX_NEW, priority=PRIORITIES[i], uid=i)
    process = orch._process_cancellations
    dropped = []

    def boundary():
        if not dropped:
            for req in eng.scheduler.queue:
                st = eng._spilled.get(req.arrival)
                if st is not None and (st.shared_table >= 0).any():
                    refs = int(eng.pool.refcount.sum())
                    dropped.append((req, int((st.shared_table >= 0).sum()),
                                    refs))
                    orch.cancel_request(req)
                    break
        process()
        if dropped and len(dropped[0]) == 3:
            req, n_shared, refs = dropped[0]
            dropped[0] += (refs - int(eng.pool.refcount.sum()),)
            assert n_shared > 0
    orch._process_cancellations = boundary
    done = orch.run_sync()
    req, n_shared, _, released = dropped[0]
    assert released == n_shared
    assert req.done and req.state.value == "cancelled"
    assert req.arrival not in eng._spilled
    assert eng.metrics["cancellations"] == 1
    assert sorted(r.uid for r in done) == sorted(
        set(range(len(LENS))) - {req.uid})
    assert all(len(r.output) == MAX_NEW for r in done)
    eng.audit_pool()                  # raises on a leak or double-free
    assert not eng._spilled and int(eng.tables.max()) == -1
