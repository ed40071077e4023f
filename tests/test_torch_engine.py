"""The slice as a whole: the port's ThinKVEngine against the JAX package's
on the flash-shaped trace (prompts of 140 and 24 tokens: one 128-token
big chunk, g-sized chunks with a partial one, eviction past the budget,
tau refreshes with TBE), greedy, on an unpressured pool, with the JAX
parameters carried across.

The port runs on the CPU with both of its backends: ``reference`` (dense
dequantize-and-softmax) and ``kernel`` (the kernels' plain versions behind
``kernels.ops``).  Bars: identical tokens per request, per-request logits
within 1e-3 (the bar the reference holds between its own backends), equal
engine counters and pool audit, and every slot's metadata, block table and
quantized planes bit-exact at the moment the slot retires (its fp buffer
to within one bf16 step)."""
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
from repro_torch.config import ServeConfig, ThinKVConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import ct_cache as CT  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.engine import ThinKVEngine  # noqa: E402

TK = dict(refresh_interval=8, group_size=8, block_size=8, token_budget=32,
          retention_schedule=(16, 8, 4), min_retention=4, max_segments=64,
          kmeans_iters=2)
LENS, PRIORITIES, MAX_NEW, SLOTS = (140, 24), (0, 1), 8, 3
COUNTERS = ("ticks", "tokens", "prefill_chunks", "prefill_big_chunks",
            "prefill_tokens", "admissions", "queue_wait_ticks")


def prompts():
    """The flash trace of ``tests/test_serving_traces.py`` (seed 1)."""
    rng = np.random.default_rng(1)
    rng.integers(0, 256, 16)          # the shared prefix it draws first
    return [rng.integers(0, 256, n).astype(np.int64) for n in LENS]


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def as_f32(u16):
    """bf16 bit patterns (uint16) -> their float32 values."""
    return (u16.astype(np.uint32) << 16).view(np.float32)


def record_retirements(eng, snap):
    """Wrap ``eng._release_slot`` to snapshot slot i's state first."""
    release = eng._release_slot
    log = []

    def wrapped(i, *a, **kw):
        log.append(snap(eng, i))
        return release(i, *a, **kw)
    eng._release_slot = wrapped
    return log


def jax_snapshot(eng, i):
    table = np.asarray(eng.tables[i])
    view = CJ.gather_view(eng.pool.view, eng.tables[i])
    out = {f: bits(getattr(eng.caches, f)[i]) for f in CJ.CTCache.FIELDS}
    out.update(table=table, **{n: bits(p) for n, p in
                               zip(CJ.PoolView._fields, view)})
    return out


def torch_snapshot(eng, i):
    def np_(t):                 # a copy: the release resets in place
        t = t.clone()
        return t.view(torch.int16).numpy().view(np.uint16) \
            if t.dtype == torch.bfloat16 else t.numpy()
    view = CT.gather_view(eng.pool.view, eng.tables[i])
    out = {f: np_(getattr(eng.caches, f)[i]) for f in CT.CTCache.FIELDS}
    out.update(table=np_(eng.tables[i]), **{n: np_(p) for n, p in
                                            zip(CT.PoolView._fields, view)})
    return out


@pytest.fixture(scope="module")
def jax_run():
    mcfg = dataclasses.replace(jax_smoke("r1-llama-8b"), num_heads=8,
                               num_kv_heads=8)
    eng = JaxEngine(JSC(model=mcfg, thinkv=JTK(**TK), max_seqs=SLOTS),
                    backend="reference", record_logits=True)
    log = record_retirements(eng, jax_snapshot)
    eng.submit(prompts(), max_new_tokens=MAX_NEW, priorities=PRIORITIES)
    done = eng.run()
    return eng, done, log, jax.tree.map(np.asarray, eng.params)


@pytest.fixture(scope="module", params=["reference", "kernel"])
def port_run(request, jax_run):
    params = jax_run[3]
    mcfg = dataclasses.replace(get_smoke_config("r1-llama-8b"), num_heads=8,
                               num_kv_heads=8)
    eng = ThinKVEngine(ServeConfig(model=mcfg, thinkv=ThinKVConfig(**TK),
                                   max_seqs=SLOTS),
                       params=params_from_numpy(params, mcfg, "cpu"),
                       backend=request.param, record_logits=True,
                       device="cpu")
    log = record_retirements(eng, torch_snapshot)
    launches = dict(ops.LAUNCHES)
    eng.submit(prompts(), max_new_tokens=MAX_NEW, priorities=PRIORITIES)
    done = eng.run()
    assert ops.LAUNCHES == launches        # plain versions on the CPU
    return eng, done, log


def by_arrival(done):
    return {r.arrival: r for r in done}


def test_identical_greedy_tokens(jax_run, port_run):
    want, got = by_arrival(jax_run[1]), by_arrival(port_run[1])
    assert sorted(want) == sorted(got) == [0, 1]
    for a in want:
        assert len(got[a].output) == MAX_NEW
        assert got[a].output == want[a].output, a


def test_per_request_logits_within_1e3(jax_run, port_run):
    want, got = jax_run[0].request_logits, port_run[0].request_logits
    assert sorted(want) == sorted(got)
    for a in want:
        w, g = np.stack(want[a]), np.stack(got[a])
        assert w.shape == g.shape == (MAX_NEW, 256)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)


def test_equal_counters_and_pool_audit(jax_run, port_run):
    je, pe = jax_run[0], port_run[0]
    assert {k: je.metrics[k] for k in COUNTERS} == \
        {k: pe.metrics[k] for k in COUNTERS}
    assert je.metrics["prefill_big_chunks"] == 1
    assert je.metrics["prefill_chunks"] == 5      # 12 + 24 tokens in g=8
    assert pe.audit_pool() == je.audit_pool()


def test_retiring_slots_bit_exact(jax_run, port_run):
    jlog, plog = jax_run[2], port_run[2]
    assert len(jlog) == len(plog) == len(LENS)
    for n, (w, g) in enumerate(zip(jlog, plog)):
        assert sorted(w) == sorted(g)
        for k in w:
            if k in ("buf_k", "buf_v"):
                continue
            np.testing.assert_array_equal(g[k], w[k],
                                          err_msg=f"retirement {n}: {k}")
        # the fp buffer holds bf16 roundings of f32 projections summed in
        # another order: equal to within one bf16 step
        for k in ("buf_k", "buf_v"):
            np.testing.assert_allclose(as_f32(g[k]), as_f32(w[k]),
                                       rtol=2 ** -7, atol=0,
                                       err_msg=f"retirement {n}: {k}")
    # the trace reached eviction and a refresh past the first segment
    long_req = max(jlog, key=lambda s: int(s["num_tokens"]))
    assert (long_req["slot_state"] == CJ.EVICTED).any() or \
        (long_req["seg_level"] > 0).any()
    assert int(long_req["cur_seg"]) > 1


def test_request_stats_match(jax_run, port_run):
    want, got = by_arrival(jax_run[1]), by_arrival(port_run[1])
    for a in want:
        for k in ("valid_tokens", "used_blocks", "physical_bytes",
                  "avg_bits"):
            np.testing.assert_allclose(np.asarray(got[a].stats[k]),
                                       np.asarray(want[a].stats[k]),
                                       rtol=1e-6, err_msg=f"{a} {k}")
        assert got[a].stats["footprint_frac"] == pytest.approx(
            want[a].stats["footprint_frac"], rel=1e-6)
