"""The port's CT cache against the JAX package's, op for op: two requests
share one paged pool and run the same sequence of group commits (past
the token budget, so budget eviction anneals segments), tau refreshes
that open a transition segment and then anneal everything before it
(TBE), partial chunks that advance the buffer without a commit, and a
release.  After every call the metadata, the block tables and the
refcounts must be bit-exact, the code and scale planes byte-exact, and
the pool audit clean."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.core import ct_cache as CJ  # noqa: E402
from repro_torch.config import ThinKVConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core import ct_cache as CT  # noqa: E402

L, H, D = 2, 2, 32
# a tau segment of 16 tokens anneals to 4 (one per cluster of keys below)
TK = dict(refresh_interval=16, token_budget=32, retention_schedule=(16, 4),
          min_retention=4, max_segments=16, kmeans_iters=2)
RUN = 4       # consecutive tokens whose keys share a center
# sparsity fed at each refresh: T, E, T, R, T, E ... (>= 0.80 is a
# transition, < 0.55 execution, else reasoning)
SPARSITY = (0.9, 0.3, 0.9, 0.6, 0.9, 0.3, 0.95, 0.7)


def as_bits(a):
    """Any array (jax, numpy, torch) -> numpy, bf16 as its uint16 bits."""
    if torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().view(np.uint16) if a.dtype == torch.int16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def clustered_keys(rng, g):
    """[L, g, H, D] keys in runs of RUN tokens around well-separated
    centers.  TBE's k-means then has one clear medoid per cluster: a
    cluster of exactly two keys would put both at the same distance from
    their mean, and which one is kept would be decided by float rounding
    (ROADMAP queue 3)."""
    centers = rng.standard_normal((L, g // RUN, H, D)) * 3
    noise = rng.standard_normal((L, g, H, D)) * 0.3
    return (np.repeat(centers, RUN, axis=1) + noise).astype(jnp.bfloat16)


def assert_same_state(pool_j, tables_j, caches_j, pool_t, tables_t,
                      caches_t, where):
    for name, pj, pt in zip(CJ.PoolView._fields, pool_j.view, pool_t.view):
        np.testing.assert_array_equal(as_bits(pt), as_bits(pj),
                                      err_msg=f"{where}: {name}")
    np.testing.assert_array_equal(as_bits(pool_t.refcount),
                                  as_bits(pool_j.refcount),
                                  err_msg=f"{where}: refcount")
    for r, (tj, tt, cj, ct) in enumerate(zip(tables_j, tables_t, caches_j,
                                             caches_t)):
        np.testing.assert_array_equal(as_bits(tt), as_bits(tj),
                                      err_msg=f"{where}: table {r}")
        for f in CJ.CTCache.FIELDS:
            np.testing.assert_array_equal(
                as_bits(getattr(ct, f)), as_bits(getattr(cj, f)),
                err_msg=f"{where}: request {r} {f}")
    audit_t = CT.check_pool_invariants(pool_t, torch.stack(tables_t))
    audit_j = CJ.check_pool_invariants(pool_j, np.stack(
        [np.asarray(t) for t in tables_j]))
    assert audit_t == audit_j


# (group, block size, precision, seed): one block per commit with 4-bit
# planes, and two blocks per commit with an 8-bit level
CASES = [(8, 8, (2, 4, 4), 8), (16, 8, (2, 4, 8), 16)]


@pytest.mark.parametrize("g,bs,prec,seed", CASES, ids=str)
def test_request_op_sequence_matches_reference(g, bs, prec, seed):
    run_op_sequence(g, bs, prec, seed)


def run_op_sequence(g, bs, prec, seed, policies=(None, None)):
    """The op sequence on both packages under ``policies`` (the JAX
    package's and the port's policy object or name; None is the default
    ThinKV policy), held bit-exact after every call."""
    pol_j, pol_t = policies
    tk_j = JTK(group_size=g, block_size=bs, precision=prec, **TK)
    tk_t = ThinKVConfig(group_size=g, block_size=bs, precision=prec, **TK)
    dims_j = CJ.make_dims(tk_j, L, H, D)
    dims_t = CT.make_dims(tk_t, L, H, D)
    assert tuple(dims_j) == tuple(dims_t)
    R, cpu = 2, torch.device("cpu")
    NP = R * dims_t.NB
    pool_j = CJ.init_global_pool(dims_j, NP)
    pool_t = CT.init_global_pool(dims_t, NP, cpu)
    tables_j = [CJ.init_block_table(dims_j) for _ in range(R)]
    tables_t = list(CT.init_block_table(dims_t, cpu, batch=R))
    caches_j = [CJ.init_cache(dims_j) for _ in range(R)]
    caches_t = [CT.init_cache(dims_t, cpu) for _ in range(R)]
    assert_same_state(pool_j, tables_j, caches_j, pool_t, tables_t, caches_t,
                      "init")

    advance_j = jax.jit(lambda pool, table, cache, s, n: CJ.engine_advance(
        tk_j, dims_j, pool, table, cache, s, jnp.bool_(True), n_new=n,
        with_alloc_fail=True, track_cow=False, policy=pol_j))
    ntok, buf, refreshes = [0] * R, [0] * R, [0] * R
    rng = np.random.default_rng(seed)
    # request 0 commits whole groups; request 1 arrives in pieces
    pieces = {0: [g] * 12, 1: [g // 2, 1, g // 2 - 1] + [g] * 9}
    for step in range(max(len(p) for p in pieces.values())):
        for r in range(R):
            if step >= len(pieces[r]):
                continue
            n = pieces[r][step]
            if buf[r] == 0:           # a new group: fill the fp buffer
                k = clustered_keys(rng, g)
                v = rng.standard_normal((L, g, H, D)).astype(jnp.bfloat16)
                caches_j[r] = caches_j[r].replace(buf_k=jnp.asarray(k),
                                                  buf_v=jnp.asarray(v))
                caches_t[r].buf_k.copy_(tensor_from_numpy(k, cpu))
                caches_t[r].buf_v.copy_(tensor_from_numpy(v, cpu))
            at_refresh = (ntok[r] + n) % tk_t.refresh_interval == 0
            s = np.float32(SPARSITY[refreshes[r] % len(SPARSITY)])
            refreshes[r] += at_refresh
            pool_j, tables_j[r], caches_j[r], fail_j, _ = advance_j(
                pool_j, tables_j[r], caches_j[r], jnp.float32(s), n)
            fail_t, cow_t, ntok[r], buf[r] = CT.engine_advance(
                tk_t, dims_t, pool_t, tables_t[r], caches_t[r],
                torch.tensor(s), num_tokens=ntok[r], buf_len=buf[r],
                n_new=n, policy=pol_t)
            assert not bool(fail_j)
            assert fail_t is None or not bool(fail_t)
            assert cow_t is None or int(cow_t) == 0
            assert int(caches_j[r].num_tokens) == ntok[r]
            assert int(caches_j[r].buf_len) == buf[r]
            assert_same_state(pool_j, tables_j, caches_j, pool_t, tables_t,
                              caches_t, f"step {step} request {r}")

    # the sequence reached what it is meant to exercise
    for cj in caches_j:
        valid = np.asarray(cj.slot_state) == CJ.VALID
        assert (valid.sum(1) <= tk_t.token_budget + g).all()
        assert (np.asarray(cj.slot_state) == CJ.EVICTED).any() or \
            (np.asarray(cj.seg_level) > 1).any()
        assert int(CJ.ThoughtType.TRANSITION) in np.asarray(cj.seg_type)
        assert (np.asarray(cj.seg_level)[:, 0] >= 2).all()   # TBE + budget

    # the reference's state carried across equals the port's
    pool_c = convert.pool_from_numpy(
        [np.asarray(p) for p in pool_j.view], np.asarray(pool_j.refcount),
        cpu)
    cache_c = convert.cache_from_numpy(
        {f: np.asarray(getattr(caches_j[1], f)) for f in CJ.CTCache.FIELDS},
        cpu)
    assert_same_state(pool_j, tables_j, caches_j, pool_c, tables_t,
                      [caches_t[0], cache_c], "converted")

    # retiring request 0 returns its blocks
    pool_j = CJ.release_blocks(dims_j, pool_j, tables_j[0])
    tables_j[0] = CJ.init_block_table(dims_j)
    CT.release_blocks(pool_t, tables_t[0])
    tables_t[0].fill_(CT.UNMAPPED)
    caches_j[0] = CJ.init_cache(dims_j)
    caches_t[0].copy_(CT.init_cache(dims_t, cpu))
    assert_same_state(pool_j, tables_j, caches_j, pool_t, tables_t, caches_t,
                      "release")
    assert CT.check_pool_invariants(pool_t, torch.stack(tables_t))[
        "claimed"] == [int((np.asarray(tables_j[1])[l] >= 0).sum())
                       for l in range(L)]


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_commit_quantizes_through_the_group_quant_path(bits):
    """A commit's codes and scales are ``quantize_group``'s at the thought's
    precision (K4's plain version on the CPU), in the slots it allocated."""
    g, bs = 8, 8
    tk_t = ThinKVConfig(group_size=g, block_size=bs, precision=(bits,) * 3,
                        **TK)
    tk_j = JTK(group_size=g, block_size=bs, precision=(bits,) * 3, **TK)
    dims = CT.make_dims(tk_t, L, H, D)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(bits)
    k = rng.standard_normal((L, g, H, D)).astype(jnp.bfloat16)
    v = (rng.standard_normal((L, g, H, D)) * 40).astype(jnp.bfloat16)
    view_t = CT.init_pool_view(dims, dims.NB, cpu)
    cache_t = CT.init_cache(dims, cpu)
    cache_t.buf_k.copy_(tensor_from_numpy(k, cpu))
    cache_t.buf_v.copy_(tensor_from_numpy(v, cpu))
    cache_t.num_tokens.fill_(g)
    CT.commit_group(tk_t, dims, cache_t, view_t)
    dims_j = CJ.make_dims(tk_j, L, H, D)
    cache_j = CJ.init_cache(dims_j).replace(
        buf_k=jnp.asarray(k), buf_v=jnp.asarray(v), num_tokens=jnp.int32(g))
    commit = jax.jit(functools.partial(CJ.commit_group, tk_j, dims_j))
    cache_j, view_j = commit(cache_j, CJ.init_pool_view(dims_j))
    for name, pj, pt in zip(CJ.PoolView._fields, view_j, view_t):
        np.testing.assert_array_equal(as_bits(pt), as_bits(pj),
                                      err_msg=name)
    for f in ("slot_state", "slot_seg", "slot_pos", "slot_bits",
              "block_type", "buf_len"):
        np.testing.assert_array_equal(as_bits(getattr(cache_t, f)),
                                      as_bits(getattr(cache_j, f)),
                                      err_msg=f)
    assert (cache_t.slot_bits[cache_t.slot_state == CT.VALID] == bits).all()


def port_op_sequence(g, bs, prec, seed):
    """The port's side of ``run_op_sequence`` alone: every plane, table,
    refcount and cache field (bf16 as bits) after every call."""
    tk = ThinKVConfig(group_size=g, block_size=bs, precision=prec, **TK)
    dims = CT.make_dims(tk, L, H, D)
    R, cpu = 2, torch.device("cpu")
    pool = CT.init_global_pool(dims, R * dims.NB, cpu)
    tables = list(CT.init_block_table(dims, cpu, batch=R))
    caches = [CT.init_cache(dims, cpu) for _ in range(R)]
    ntok, buf, refreshes = [0] * R, [0] * R, [0] * R
    rng = np.random.default_rng(seed)
    pieces = {0: [g] * 12, 1: [g // 2, 1, g // 2 - 1] + [g] * 9}
    states = []
    for step in range(max(len(p) for p in pieces.values())):
        for r in range(R):
            if step >= len(pieces[r]):
                continue
            n = pieces[r][step]
            if buf[r] == 0:
                caches[r].buf_k.copy_(tensor_from_numpy(
                    clustered_keys(rng, g), cpu))
                caches[r].buf_v.copy_(tensor_from_numpy(
                    rng.standard_normal((L, g, H, D)).astype(jnp.bfloat16),
                    cpu))
            at_refresh = (ntok[r] + n) % tk.refresh_interval == 0
            s = np.float32(SPARSITY[refreshes[r] % len(SPARSITY)])
            refreshes[r] += at_refresh
            _, _, ntok[r], buf[r] = CT.engine_advance(
                tk, dims, pool, tables[r], caches[r], torch.tensor(s),
                num_tokens=ntok[r], buf_len=buf[r], n_new=n)
            states.append(
                [as_bits(p).copy() for p in pool.view]
                + [as_bits(pool.refcount).copy()]
                + [as_bits(t).copy() for t in tables]
                + [as_bits(getattr(c, f)).copy() for c in caches
                   for f in CJ.CTCache.FIELDS])
    return states


@pytest.mark.parametrize("g,bs,prec,seed", CASES, ids=str)
def test_budget_evict_skips_only_rounds_that_change_nothing(
        g, bs, prec, seed, monkeypatch):
    """``budget_evict`` skips its rounds when the caller's host token count
    is within the budget.  The op sequence, which crosses the budget, run
    as the engine runs it and again with that count withheld (every round
    run) leaves every plane, table, refcount and cache field (slot_state
    and seg_type among them) bit-identical after every call, and takes
    both branches."""
    evict, counts = CT.budget_evict, []

    def counting(*a, num_tokens=None, **k):
        counts.append(num_tokens)
        return evict(*a, num_tokens=num_tokens, **k)
    monkeypatch.setattr(CT, "budget_evict", counting)
    skipping = port_op_sequence(g, bs, prec, seed)
    assert any(n <= TK["token_budget"] for n in counts)
    assert any(n > TK["token_budget"] for n in counts)
    monkeypatch.setattr(CT, "budget_evict",
                        lambda *a, num_tokens=None, **k: evict(*a, **k))
    every_round = port_op_sequence(g, bs, prec, seed)
    assert len(skipping) == len(every_round)
    for i, (a, b) in enumerate(zip(skipping, every_round)):
        for j, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(x, y, err_msg=f"call {i} part {j}")
