"""The port's retention policies (``repro_torch/core/policy.py``: thinkv, rkv,
uniform) against the JAX package's ``repro/core/policy.py``.

* the port's versions of ``tests/test_policy.py``'s contract cases;
* ``redundancy_select`` and uniform's newest-first selection: masks
  bit-exact against JAX on numpy-seeded keys over 60 seeds, every valid
  count from 0 to n and keep values from 1 to past the valid count;
* ``rho``, ``psi_bits``, ``retention_at`` and ``precision_levels`` exact;
* ``tests/test_torch_cache.py``'s op sequence under each policy, bit-exact
  after every call;
* the engine on the pressure trace under rkv and uniform against the live
  JAX engine, on both port backends: tokens, every counter and the pool
  audit equal, logits within 1e-3, and the trace reaches ``select_tokens``
  (so the cells are not vacuous).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ServeConfig as JSC  # noqa: E402
from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.config import ThoughtType  # noqa: E402
from repro.core import kmeans as KJ  # noqa: E402
from repro.core import policy as PJ  # noqa: E402
from repro.serving.engine import ThinKVEngine as JaxEngine  # noqa: E402
from repro_torch.config import ServeConfig, ThinKVConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import kmeans as KT  # noqa: E402
from repro_torch.core import policy as P  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.engine import ThinKVEngine  # noqa: E402
import test_torch_cache as TC  # noqa: E402
import test_torch_pressure as PT  # noqa: E402

NAMES = ("thinkv", "rkv", "uniform")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    several pytest workers on one host the threads' wake-ups dominate:
    run this module's torch ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(refresh_interval=8, group_size=8, block_size=8,
                token_budget=32, retention_schedule=(16, 8, 4),
                min_retention=4, max_segments=64, kmeans_iters=2)
    base.update(kw)
    return ThinKVConfig(**base)


def _jcfg(**kw):
    return JTK(**dataclasses.asdict(_cfg(**kw)))


# ---------------------------------------------------------------------------
# the contract cases of tests/test_policy.py
# ---------------------------------------------------------------------------

def test_registry_has_all_three_policies():
    assert set(P.POLICIES) == set(NAMES) == set(PJ.POLICIES)
    for name, pol in P.POLICIES.items():
        assert pol.name == name


def test_get_policy_resolution():
    assert P.get_policy(None) is P.DEFAULT_POLICY
    assert P.get_policy("rkv") is P.POLICIES["rkv"]
    inst = P.UniformPolicy()
    assert P.get_policy(inst) is inst
    with pytest.raises(ValueError, match="registered.*rkv"):
        P.get_policy("nope")


def test_default_policy_is_thinkv_and_module_delegates():
    cfg = _cfg()
    thought = torch.tensor([0, 1, 2], dtype=torch.int32)
    assert isinstance(P.DEFAULT_POLICY, P.ThinKVPolicy)
    assert torch.equal(P.rho(thought), P.DEFAULT_POLICY.rho(thought))
    assert torch.equal(P.psi_bits(thought, cfg),
                       P.DEFAULT_POLICY.psi_bits(thought, cfg))
    lvl = torch.tensor(1)
    assert torch.equal(P.retention_at(lvl, cfg),
                       P.DEFAULT_POLICY.retention_at(lvl, cfg))
    assert P.default_thresholds() == PJ.default_thresholds()
    P.validate(cfg)


@pytest.mark.parametrize("name", NAMES)
def test_psi_bits_monotone_in_rho(name):
    pol = P.POLICIES[name]
    cfg = _cfg()
    thoughts = torch.tensor([int(t) for t in ThoughtType], dtype=torch.int32)
    rho = pol.rho(thoughts).numpy()
    bits = pol.psi_bits(thoughts, cfg).numpy()
    order = np.argsort(rho, kind="stable")
    assert (np.diff(bits[order]) >= 0).all(), (rho, bits)
    assert set(bits.tolist()) <= set(pol.precision_levels(cfg))


def test_thinkv_psi_matches_paper_mapping():
    t = torch.tensor([int(ThoughtType.TRANSITION), int(ThoughtType.EXECUTION),
                      int(ThoughtType.REASONING)], dtype=torch.int32)
    assert P.POLICIES["thinkv"].psi_bits(t, _cfg()).tolist() == [2, 4, 4]


def test_uniform_policy_is_flat():
    cfg = _cfg()
    pol = P.POLICIES["uniform"]
    t = torch.tensor([0, 1, 2], dtype=torch.int32)
    assert pol.psi_bits(t, cfg).tolist() == [4, 4, 4]
    assert pol.psi_bits(t, cfg).dtype == torch.int32
    assert pol.rho(t).tolist() == [0, 0, 0]
    assert pol.precision_levels(cfg) == (4,)


@pytest.mark.parametrize("name", NAMES)
def test_retention_at_boundaries(name):
    pol = P.POLICIES[name]
    cfg = _cfg(retention_schedule=(16, 8, 4), min_retention=4)
    sched = cfg.retention_schedule
    at = lambda lvl, c=cfg: int(pol.retention_at(torch.tensor(lvl), c))
    assert at(0) == sched[0] and at(2) == sched[2]
    for lvl in (3, 7, 100):
        assert at(lvl) == sched[-1]
    assert at(-1) == sched[0]
    assert at(2, _cfg(retention_schedule=(16, 8, 2), min_retention=4)) == 4


def test_validate_rejects_empty_schedule():
    with pytest.raises(ValueError, match="non-empty"):
        P.validate(_cfg(retention_schedule=()))


def test_validate_rejects_schedule_entirely_below_floor():
    with pytest.raises(ValueError, match="entirely below min_retention"):
        P.validate(_cfg(retention_schedule=(3, 2, 1), min_retention=4))


def test_validate_allows_partial_clamp():
    P.validate(_cfg(retention_schedule=(16, 8, 2), min_retention=4))


@pytest.mark.parametrize("name", NAMES)
def test_validate_runs_for_every_policy(name):
    P.POLICIES[name].validate(_cfg())
    with pytest.raises(ValueError):
        P.POLICIES[name].validate(_cfg(retention_schedule=()))


def test_thinkv_validate_rejects_inverted_precision():
    with pytest.raises(ValueError):
        P.POLICIES["thinkv"].validate(_cfg(precision=(8, 4, 4)))
    # rkv shares thinkv's precision and its check; uniform ignores it
    with pytest.raises(ValueError):
        P.POLICIES["rkv"].validate(_cfg(precision=(8, 4, 4)))
    P.POLICIES["uniform"].validate(_cfg(precision=(8, 4, 4)))


@pytest.mark.parametrize("name", NAMES)
def test_select_tokens_contract(name):
    pol = P.POLICIES[name]
    cfg = _cfg(retention_schedule=(24, 8, 4))
    rng = np.random.default_rng(0)
    n, d = 24, 8
    x = torch.as_tensor(rng.standard_normal((1, n, d)), dtype=torch.float32)
    valid = torch.as_tensor(rng.random((1, n)) < 0.7)
    n_valid = int(valid.sum())
    for keep in (1, 4, n_valid, n):
        mask = pol.select_tokens(x, valid, torch.tensor([keep]), cfg)
        assert mask.shape == (1, n)
        assert not (mask & ~valid).any(), "kept an invalid row"
        assert int(mask.sum()) == min(max(keep, 1), n_valid)


def test_redundancy_select_prefers_diversity():
    x = torch.zeros((1, 8, 2))
    x[0, 6] = torch.tensor([10.0, 0.0])
    x[0, 7] = torch.tensor([0.1, 0.0])
    mask = KT.redundancy_select(x, torch.ones((1, 8), dtype=torch.bool),
                                torch.tensor([2]))[0]
    assert mask[7], "seed (newest valid token) must always be kept"
    assert mask[6], "the diverse outlier must beat the duplicates"
    assert int(mask.sum()) == 2


def test_redundancy_select_all_invalid_is_empty():
    mask = KT.redundancy_select(torch.zeros((1, 6, 4)),
                                torch.zeros((1, 6), dtype=torch.bool),
                                torch.tensor([3]))
    assert not mask.any()


def test_uniform_select_keeps_newest():
    valid = torch.tensor([[1, 1, 0, 1, 1, 0, 1, 1, 1, 0]], dtype=torch.bool)
    mask = P.POLICIES["uniform"].select_tokens(
        torch.zeros((1, 10, 4)), valid, torch.tensor([3]), _cfg())
    assert mask[0].int().tolist() == [0, 0, 0, 0, 0, 0, 1, 1, 1, 0]


# ---------------------------------------------------------------------------
# against the JAX functions
# ---------------------------------------------------------------------------

N, D_KEYS, K_MAX, SEEDS = 24, 16, 16, range(60)


def selection_cases():
    """(x [C, N, d], valid [C, N], keep [C]) over the seeds: seed s has
    ``s % (N + 1)`` valid rows at random places and asks every keep from 1
    to 3 past that count (keep values past K_MAX included)."""
    xs, valids, keeps = [], [], []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((N, D_KEYS)).astype(np.float32)
        n_valid = seed % (N + 1)
        valid = np.zeros(N, bool)
        valid[rng.permutation(N)[:n_valid]] = True
        for keep in range(1, n_valid + 4):
            xs.append(x)
            valids.append(valid)
            keeps.append(keep)
    return np.stack(xs), np.stack(valids), np.asarray(keeps, np.int32)


def test_redundancy_select_masks_are_jax_bit_exact():
    x, valid, keep = selection_cases()
    want = np.asarray(jax.vmap(lambda a, v, k: KJ.redundancy_select(
        a, v, k, k_max=K_MAX))(jnp.asarray(x), jnp.asarray(valid),
                               jnp.asarray(keep)))
    got = KT.redundancy_select(torch.from_numpy(x), torch.from_numpy(valid),
                               torch.from_numpy(keep), k_max=K_MAX).numpy()
    assert len(keep) > 600
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) == np.minimum(keep, np.minimum(valid.sum(1),
                                                      K_MAX))).all()


@pytest.mark.parametrize("name", ["rkv", "uniform"])
def test_policy_selection_is_jax_bit_exact(name):
    """Through the policy object, at the schedule's k_max (rkv) and
    unbounded (uniform)."""
    x, valid, keep = selection_cases()
    cfg = _cfg(retention_schedule=(K_MAX, 8, 4))
    pj = PJ.POLICIES[name]
    want = np.asarray(jax.vmap(lambda a, v, k: pj.select_tokens(
        a, v, k, _jcfg(retention_schedule=(K_MAX, 8, 4))))(
        jnp.asarray(x), jnp.asarray(valid), jnp.asarray(keep)))
    got = P.POLICIES[name].select_tokens(
        torch.from_numpy(x), torch.from_numpy(valid), torch.from_numpy(keep),
        cfg).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("precision", [(2, 4, 4), (2, 4, 8), (4, 8, 8)])
@pytest.mark.parametrize("name", NAMES)
def test_rho_psi_retention_and_levels_equal_jax(name, precision):
    sched = (16, 8, 2)
    cfg, jcfg = _cfg(precision=precision, retention_schedule=sched), \
        _jcfg(precision=precision, retention_schedule=sched)
    pt, pj = P.POLICIES[name], PJ.POLICIES[name]
    t = np.asarray([0, 1, 2, 2, 0], np.int32)
    np.testing.assert_array_equal(pt.rho(torch.from_numpy(t)).numpy(),
                                  np.asarray(pj.rho(jnp.asarray(t))))
    np.testing.assert_array_equal(
        pt.psi_bits(torch.from_numpy(t), cfg).numpy(),
        np.asarray(pj.psi_bits(jnp.asarray(t), jcfg)))
    levels = np.arange(-2, 8, dtype=np.int32)
    np.testing.assert_array_equal(
        pt.retention_at(torch.from_numpy(levels), cfg).numpy(),
        np.asarray(pj.retention_at(jnp.asarray(levels), jcfg)))
    assert pt.precision_levels(cfg) == pj.precision_levels(jcfg)


def counting(name):
    """A policy instance of ``name`` that counts its ``select_tokens``
    calls (``.calls``)."""
    base = type(P.POLICIES[name])

    class Counting(base):
        calls = 0

        def select_tokens(self, *args):
            self.calls += 1
            return super().select_tokens(*args)
    return Counting()


@pytest.mark.parametrize("name", NAMES)
def test_cache_op_sequence_under_each_policy(name):
    """``tests/test_torch_cache.py``'s op sequence (group commits past the
    budget, tau refreshes with TBE, partial chunks, a release) under each
    policy: metadata, tables, refcounts and planes bit-exact after every
    call, and the anneals reach the policy's ``select_tokens``."""
    pol = counting(name)
    TC.run_op_sequence(*TC.CASES[0], policies=(name, pol))
    assert pol.calls > 0


# ---------------------------------------------------------------------------
# the engine on the pressure trace, against the live JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["rkv", "uniform"])
def jax_run(request):
    eng = JaxEngine(JSC(model=PT.jax_model(), thinkv=JTK(**PT.TK),
                        max_seqs=PT.SLOTS),
                    backend="reference", pool_blocks=PT.pool_blocks(),
                    record_logits=True, prefix_cache=True,
                    policy=request.param)
    eng.submit(PT.prompts(), max_new_tokens=PT.MAX_NEW,
               priorities=PT.PRIORITIES)
    done = eng.run()
    return request.param, eng, done, jax.tree.map(np.asarray, eng.params)


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_engine_under_each_policy_matches_jax(jax_run, backend):
    name, jeng, jdone, params = jax_run
    pol = counting(name)
    eng = ThinKVEngine(
        ServeConfig(model=PT.port_model(), thinkv=ThinKVConfig(**PT.TK),
                    max_seqs=PT.SLOTS),
        params=params_from_numpy(params, PT.port_model(), "cpu"),
        backend=backend, pool_blocks=PT.pool_blocks(), record_logits=True,
        prefix_cache=True, device="cpu", policy=pol)
    launches = dict(ops.LAUNCHES)
    eng.submit(PT.prompts(), max_new_tokens=PT.MAX_NEW,
               priorities=PT.PRIORITIES)
    done = eng.run()
    assert ops.LAUNCHES == launches        # plain versions on the CPU
    assert pol.calls > 0, "the trace never reached select_tokens"
    assert PT.outputs(done) == PT.outputs(jdone)
    worst = max(float(np.abs(np.stack(eng.request_logits[a])
                             - np.stack(jeng.request_logits[a])).max())
                for a in jeng.request_logits)
    assert worst <= 1e-3
    # every counter the two engines share (times and the port's own
    # commit and spill tallies apart)
    counters = [k for k, v in jeng.metrics.items()
                if isinstance(v, int) and k in eng.metrics]
    assert set(PT.COUNTERS) <= set(counters)
    assert {k: int(eng.metrics[k]) for k in counters} == \
        {k: int(jeng.metrics[k]) for k in counters}
    assert eng.metrics["preemptions"] > 0 and eng.metrics["cow_faults"] > 0
    assert eng.audit_pool() == jeng.audit_pool()
    if name == "uniform":
        assert all(r.stats["avg_bits"] == 4.0 for r in done)
