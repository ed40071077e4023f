"""The port's prefix cache against the JAX package's: one op sequence
through both — registrations at commit boundaries and at a prompt's end
(``full_only``), a repeated registration, lookups of the longest entry, of
an exact-length-only entry and misses, a probe (``record=False``) that
freshens an entry's LRU stamp, eviction by LRU (directly and when
registering past the capacity) and of a named entry, ``cached_tables`` and
``stats``.  After every step the entries (keys in order, lengths, LRU
stamps, tables, snapshots), the hit/miss/eviction counts and the pool's
refcounts must be equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ct_cache as CJ  # noqa: E402
from repro.serving.prefix_cache import PrefixCache as JaxCache  # noqa: E402
from repro_torch.core import ct_cache as CT  # noqa: E402
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402

DIMS = dict(L=2, NB=6, BS=4, H=2, D=16, G=8, S=8, nibble=True)
NP, V = 12, 32


def build(seed):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, 40).astype(np.int64)
    q = np.concatenate([p[:10], rng.integers(0, 256, 14)]).astype(np.int64)
    r = rng.integers(0, 256, 24).astype(np.int64)
    # a prefill's boundary tables grow: each maps the previous one's blocks
    # and one more (physical ids permuted per layer)
    perm = np.stack([rng.permutation(NP) for _ in range(DIMS["L"])])
    tables = {}
    for n, k in ((8, 1), (16, 2), (21, 3), (24, 3), (32, 4), (40, 5)):
        t = np.full((DIMS["L"], DIMS["NB"]), -1, np.int32)
        t[:, :k] = perm[:, :k]
        tables[n] = t
    q_table = np.full((DIMS["L"], DIMS["NB"]), -1, np.int32)
    q_table[:, :2] = perm[:, 6:8]
    return p, q, r, tables, q_table, rng


def snapshot(rng, n):
    """A cache snapshot (numpy leaves) and logits for boundary ``n``."""
    dims = CT.CacheDims(**DIMS)
    base = CT.init_cache(dims, torch.device("cpu"))
    out = {f: getattr(base, f).numpy().copy() for f in CT.CTCache.FIELDS
           if getattr(base, f).dtype != torch.bfloat16}
    out["slot_state"] = rng.integers(0, 3, out["slot_state"].shape
                                     ).astype(np.uint8)
    out["num_tokens"] = np.array(n, np.int32)
    out["buf_len"] = np.array(n % DIMS["G"], np.int32)
    buf = (rng.standard_normal((DIMS["L"], DIMS["G"], DIMS["H"], DIMS["D"]))
           .astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    out["buf_k"], out["buf_v"] = buf, buf[::-1].copy()
    return out, rng.standard_normal(V).astype(np.float32)


class Both:
    """The two caches and pools, driven in step."""

    def __init__(self):
        self.j = JaxCache(CJ.CacheDims(**DIMS), capacity=4)
        self.t = PrefixCache(CT.CacheDims(**DIMS), capacity=4)
        self.pool_j = CJ.init_global_pool(CJ.CacheDims(**DIMS), NP)
        self.pool_t = CT.init_global_pool(CT.CacheDims(**DIMS), NP,
                                          torch.device("cpu"))

    def register(self, prompt, n, table, snap, logits, full_only):
        def jx(a):
            return jnp.asarray(a).view(jnp.bfloat16) \
                if a.dtype == np.uint16 else jnp.asarray(a)

        def tt(a):
            t = torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16
                                 else a.copy())
            return t.view(torch.bfloat16) if a.dtype == np.uint16 else t
        self.pool_j = self.j.register(
            self.pool_j, prompt, n, jnp.asarray(table),
            CJ.CTCache(**{f: jx(snap[f]) for f in CJ.CTCache.FIELDS}),
            jnp.asarray(logits), full_only)
        self.t.register(
            self.pool_t, prompt, n, torch.from_numpy(table.copy()),
            CT.CTCache(**{f: tt(snap[f]) for f in CT.CTCache.FIELDS}),
            torch.from_numpy(logits.copy()), full_only)

    def lookup(self, prompt, record=True):
        a, b = self.j.lookup(prompt, record), self.t.lookup(prompt, record)
        assert (a is None) == (b is None)
        assert a is None or a.key == b.key
        return b

    def evict_lru(self):
        self.pool_j, a = self.j.evict_lru(self.pool_j)
        b = self.t.evict_lru(self.pool_t)
        assert (a is None) == (b is None) and (a is None or a.key == b.key)

    def evict_entry(self, key):
        self.pool_j = self.j.evict_entry(self.pool_j, self.j.entries[key])
        self.t.evict_entry(self.pool_t, self.t.entries[key])

    def check(self, where):
        assert list(self.t.entries) == list(self.j.entries), where
        for k, e in self.j.entries.items():
            g = self.t.entries[k]
            assert (g.length, g.full_only, g.last_used) == \
                (e.length, e.full_only, e.last_used), where
            np.testing.assert_array_equal(g.table, e.table, err_msg=where)
            np.testing.assert_array_equal(g.blocks_per_layer,
                                          e.blocks_per_layer)
            np.testing.assert_array_equal(g.logits.numpy(), e.logits)
            for f in CT.CTCache.FIELDS:
                x = getattr(g.cache, f)
                x = x.view(torch.int16).numpy().view(np.uint16) \
                    if x.dtype == torch.bfloat16 else x.numpy()
                y = np.asarray(getattr(e.cache, f))
                y = y.view(np.uint16) if y.dtype.name == "bfloat16" else y
                np.testing.assert_array_equal(x, y, err_msg=f"{where} {f}")
        for a, b in zip(self.t.cached_tables(), self.j.cached_tables()):
            np.testing.assert_array_equal(a, b)
        assert self.t.stats() == self.j.stats(), where
        assert [e.key for e in self.t.lru_entries()] == \
            [e.key for e in self.j.lru_entries()], where
        np.testing.assert_array_equal(self.pool_t.refcount.numpy(),
                                      np.asarray(self.pool_j.refcount),
                                      err_msg=where)
        # the cache's entries are the pool's only holders here
        CT.check_pool_invariants(
            self.pool_t, np.zeros((0, DIMS["L"], DIMS["NB"]), np.int32),
            self.t.cached_tables())


@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_cache_op_sequence_matches_reference(seed):
    p, q, r, tables, q_table, rng = build(seed)
    b = Both()
    for n, full_only in ((8, False), (16, False), (21, True)):
        b.register(p, n, tables[n], *snapshot(rng, n), full_only)
        b.check(f"register {n}")
    b.register(p, 16, tables[16], *snapshot(rng, 16), False)   # a touch
    b.check("register 16 again")
    assert len(b.t.entries) == 3
    assert b.lookup(p[:21]).length == 21          # exact: full_only
    assert b.lookup(p[:30]).length == 16          # longest proper
    assert b.lookup(q).length == 8                # shares 10 tokens
    assert b.lookup(r) is None
    assert b.lookup(p[:5]) is None
    b.check("lookups")
    lru = [e.length for e in b.t.lru_entries()]
    assert b.lookup(p[:17], record=False).length == 16    # a probe
    b.check("probe")
    assert [e.length for e in b.t.lru_entries()][-1] == 16 != lru[-1]
    b.evict_lru()
    b.check("evict lru")
    for n in (24, 32):
        b.register(p, n, tables[n], *snapshot(rng, n), False)
        b.check(f"register {n}")
    b.register(q, 16, q_table, *snapshot(rng, 16), False)  # past capacity
    b.check("register past capacity")
    assert b.j.evictions == b.t.evictions == 2
    b.evict_entry(b.t._key(p, 24))
    b.check("evict entry")
    while b.t.entries:
        b.evict_lru()
        b.check("drain")
    b.evict_lru()                                 # empty: nothing
    assert int(b.pool_t.refcount.sum()) == 0
    assert b.t.stats() == b.j.stats()
