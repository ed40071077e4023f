"""The port's shared-pool operations against the JAX package's, on seeded
numpy inputs, bit-exact: ``changed_slots`` (the COW dirty detector),
``sync_block_tables`` with a dirty mask (a COW that succeeds, one that
fails, a fresh claim that fails, both at once, and no dirty mask),
``incref_blocks`` / ``release_blocks``, ``cow_blocks``, ``claim_blocks`` and
``extract_request`` -> ``restore_request``.  Pool planes, refcounts, block
tables, metadata and the returned masks must be equal.

The cases are built with numpy only (``pool_case``), so
``tests/test_torch_cuda.py`` replays them on the card against the port's
CPU results where there is no JAX; the JAX package is imported inside the
tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ct_cache as CT  # noqa: E402

DIMS = dict(L=2, NB=6, BS=4, H=2, D=32, G=8, S=8, nibble=False)
NP = 8                               # physical blocks per layer
FREE, VALID, EVICTED = 0, 1, 2
SYNC_CASES = ("cow_ok", "cow_fail", "fresh_fail", "mixed", "no_dirty")
# other holders' blocks per layer: what is left free for the claims
FILLED = {"cow_ok": 0, "cow_fail": 5, "fresh_fail": 5, "mixed": 4,
          "no_dirty": 0, "ok": 0, "fail": 5}


def bf16_bits(x):
    """float32 -> the bits of its bf16 truncation (uint16)."""
    return (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.uint16)


def planes(rng, n):
    """Random (k_codes, v_codes, k_scales, v_scales) for ``n`` blocks per
    layer; scales as bf16 bit patterns."""
    L, BS, H, D = DIMS["L"], DIMS["BS"], DIMS["H"], DIMS["D"]
    codes = [rng.integers(0, 256, (L, n, BS, H, D), dtype=np.uint8)
             for _ in range(2)]
    scales = [bf16_bits(rng.standard_normal((L, n, BS, H, D // 16)))
              for _ in range(2)]
    return codes + scales


def table_of(ids, n_logical):
    t = np.full((DIMS["L"], DIMS["NB"]), -1, np.int32)
    t[:, :n_logical] = ids
    return t


def refcount_of(tables):
    rc = np.zeros((DIMS["L"], NP), np.int32)
    for t in tables:
        for l in range(DIMS["L"]):
            np.add.at(rc[l], t[l][t[l] >= 0], 1)
    return rc


def pool_case(name: str, seed: int) -> dict:
    """A request (table A: logical blocks 0-2) whose blocks 1 and 2 are also
    held by table B (refcount 2), and a table C of other holders filling
    ``FILLED[name]`` more blocks; physical ids permuted per layer.  The
    metadata before (``state0``/``bt0``) and after a CT update
    (``state``/``bt``: per case a freed block 0, a fresh claim of block 3),
    the update's per-request view and its dirty slots."""
    rng = np.random.default_rng(seed)
    L, NB, BS = DIMS["L"], DIMS["NB"], DIMS["BS"]
    perm = np.stack([rng.permutation(NP) for _ in range(L)]).astype(np.int32)
    n_fill = FILLED[name]
    a, b = table_of(perm[:, :3], 3), table_of(perm[:, 1:3], 2)
    c = table_of(perm[:, 3:3 + n_fill], n_fill)
    bt0 = np.full((L, NB), -1, np.int8)
    bt0[:, :3] = rng.integers(0, 3, (L, 3))
    state0 = np.zeros((L, NB * BS), np.uint8)
    state0[:, :3 * BS] = rng.choice([FREE, VALID, EVICTED], (L, 3 * BS))
    state0[:, ::BS][:, :3] = VALID
    bt, state = bt0.copy(), state0.copy()
    dirty = np.zeros((L, NB * BS), bool)

    def write(block):
        sl = slice(block * BS, (block + 1) * BS)
        hit = rng.random((L, BS)) < 0.5
        hit[:, 0] = True
        dirty[:, sl] |= hit
        state[:, sl] = np.where(hit, VALID, state[:, sl])

    if name in ("cow_ok", "mixed", "no_dirty"):
        bt[:, 3] = 1
        write(3)
    if name == "fresh_fail":
        bt[:, 3] = 2
        write(3)
    if name == "cow_ok":
        bt[:, 0] = -1
        state[:, :BS] = FREE
    if name in ("cow_ok", "cow_fail", "mixed"):
        write(1)
    if name in ("cow_ok", "mixed"):
        write(2)
    return {"pool": planes(rng, NP), "table": a, "others": [b, c],
            "refcount": refcount_of([a, b, c]), "bt0": bt0,
            "state0": state0, "bt": bt, "state": state,
            "view": planes(rng, NB),
            "dirty": None if name == "no_dirty" else dirty}


# ---------------------------------------------------------------------------
# the two packages' sides
# ---------------------------------------------------------------------------

def torch_of(a, dev="cpu"):
    a = np.asarray(a)
    t = torch.from_numpy(np.array(a.view(np.int16) if a.dtype == np.uint16
                                  else a))
    return (t.view(torch.bfloat16) if a.dtype == np.uint16 else t).to(dev)


def numpy_of(t):
    t = t.cpu().clone()            # the pool changes in place afterwards
    return t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()


def port_state(case, dev="cpu"):
    dims = CT.CacheDims(**DIMS)
    pool = CT.GlobalPool(CT.PoolView(*(torch_of(p, dev)
                                       for p in case["pool"])),
                         torch_of(case["refcount"], dev))
    cache = CT.init_cache(dims, torch.device(dev))
    cache.slot_state.copy_(torch_of(case["state"], dev))
    cache.block_type.copy_(torch_of(case["bt"], dev))
    view = CT.PoolView(*(torch_of(p, dev) for p in case["view"]))
    dirty = None if case["dirty"] is None else torch_of(case["dirty"], dev)
    return dims, pool, torch_of(case["table"], dev), cache, view, dirty


def port_sync(case, dev="cpu") -> dict:
    """``sync_block_tables`` on the port; everything it changed, as numpy."""
    dims, pool, table, cache, view, dirty = port_state(case, dev)
    failed, cow = CT.sync_block_tables(dims, pool, table, cache, view,
                                       dirty_slots=dirty)
    return {"planes": [numpy_of(p) for p in pool.view],
            "refcount": numpy_of(pool.refcount), "table": numpy_of(table),
            "slot_state": numpy_of(cache.slot_state),
            "block_type": numpy_of(cache.block_type),
            "failed": numpy_of(failed), "cow": numpy_of(cow)}


def port_ops(case, dev="cpu") -> dict:
    """incref / release, cow_blocks, claim_blocks and extract -> restore on
    the port, in that order on one pool; every intermediate as numpy."""
    dims, pool, table, _, _, _ = port_state(case, dev)
    out = {}
    CT.incref_blocks(pool, table)
    out["incref"] = numpy_of(pool.refcount)
    CT.release_blocks(pool, table)
    out["release"] = numpy_of(pool.refcount)
    mask = torch.zeros_like(table, dtype=torch.bool)
    mask[:, :3] = True                 # block 0 is private: skipped
    ok = CT.cow_blocks(dims, pool, table, mask)
    out["cow"] = ([numpy_of(p) for p in pool.view], numpy_of(pool.refcount),
                  numpy_of(table), bool(ok))
    view, mapped = CT.extract_request(pool, table)
    out["extract"] = ([numpy_of(p) for p in view], numpy_of(mapped))
    CT.release_blocks(pool, table)
    new, ok = CT.restore_request(pool, mapped, view)
    out["restore"] = ([numpy_of(p) for p in pool.view],
                      numpy_of(pool.refcount), numpy_of(new), bool(ok))
    claim = torch.zeros_like(mapped)
    claim[:, 3:6] = True
    new, ok = CT.claim_blocks(pool, claim)
    out["claim"] = (numpy_of(pool.refcount), numpy_of(new), bool(ok))
    return out


def jax_sync(case) -> dict:
    import jax.numpy as jnp
    from repro.core import ct_cache as CJ
    dims = CJ.CacheDims(**DIMS)
    pool = CJ.GlobalPool(CJ.PoolView(*jax_planes(case["pool"])),
                         jnp.asarray(case["refcount"]))
    cache = CJ.init_cache(dims).replace(
        slot_state=jnp.asarray(case["state"]),
        block_type=jnp.asarray(case["bt"]))
    dirty = None if case["dirty"] is None else jnp.asarray(case["dirty"])
    pool, table, cache, failed, cow = CJ.sync_block_tables(
        dims, pool, jnp.asarray(case["table"]), cache,
        CJ.PoolView(*jax_planes(case["view"])), dirty_slots=dirty)
    return {"planes": [bits(p) for p in pool.view],
            "refcount": np.asarray(pool.refcount), "table": np.asarray(table),
            "slot_state": np.asarray(cache.slot_state),
            "block_type": np.asarray(cache.block_type),
            "failed": np.asarray(failed), "cow": np.asarray(cow)}


def jax_ops(case) -> dict:
    import jax.numpy as jnp
    from repro.core import ct_cache as CJ
    dims = CJ.CacheDims(**DIMS)
    pool = CJ.GlobalPool(CJ.PoolView(*jax_planes(case["pool"])),
                         jnp.asarray(case["refcount"]))
    table = jnp.asarray(case["table"])
    out = {}
    pool = CJ.incref_blocks(dims, pool, table)
    out["incref"] = np.asarray(pool.refcount)
    pool = CJ.release_blocks(dims, pool, table)
    out["release"] = np.asarray(pool.refcount)
    mask = np.zeros(table.shape, bool)
    mask[:, :3] = True
    pool, table, ok = CJ.cow_blocks(dims, pool, table, jnp.asarray(mask))
    out["cow"] = ([bits(p) for p in pool.view], np.asarray(pool.refcount),
                  np.asarray(table), bool(ok))
    view, mapped = CJ.extract_request(dims, pool, table)
    out["extract"] = ([bits(p) for p in view], np.asarray(mapped))
    pool = CJ.release_blocks(dims, pool, table)
    pool, new, ok = CJ.restore_request(dims, pool, mapped, view)
    out["restore"] = ([bits(p) for p in pool.view],
                      np.asarray(pool.refcount), np.asarray(new), bool(ok))
    claim = np.zeros(mapped.shape, bool)
    claim[:, 3:6] = True
    pool, new, ok = CJ.claim_blocks(dims, pool, jnp.asarray(claim))
    out["claim"] = (np.asarray(pool.refcount), np.asarray(new), bool(ok))
    return out


def jax_planes(ps):
    import jax.numpy as jnp
    return [jnp.asarray(p).view(jnp.bfloat16) if p.dtype == np.uint16
            else jnp.asarray(p) for p in ps]


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_equal_trees(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_equal_trees(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for n, (g, w) in enumerate(zip(got, want)):
            assert_equal_trees(g, w, f"{where}[{n}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=where)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_changed_slots_matches_reference(seed):
    """A slot is dirty iff any of its four planes differ; a change to one
    scale bit alone is a change."""
    from repro.core import ct_cache as CJ
    rng = np.random.default_rng(seed)
    old = planes(rng, DIMS["NB"])
    new = [p.copy() for p in old]
    L, NB, BS = DIMS["L"], DIMS["NB"], DIMS["BS"]
    for n, p in enumerate(new):
        hit = rng.random((L, NB, BS)) < 0.15
        lane = rng.integers(0, p.shape[-1])
        flip = 1 if n < 2 else 0x0100           # a code, or a scale bit
        p[..., 0, lane][hit] ^= np.array(flip, p.dtype)
    got = CT.changed_slots(CT.PoolView(*(torch_of(p) for p in old)),
                           CT.PoolView(*(torch_of(p) for p in new)))
    want = CJ.changed_slots(CJ.PoolView(*jax_planes(old)),
                            CJ.PoolView(*jax_planes(new)))
    assert got.shape == (L, NB * BS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()
    assert not CT.changed_slots(CT.PoolView(*(torch_of(p) for p in old)),
                                CT.PoolView(*(torch_of(p) for p in old))
                                ).any()


@pytest.mark.parametrize("name", SYNC_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_sync_block_tables_matches_reference(name, seed):
    case = pool_case(name, seed)
    got, want = port_sync(case), jax_sync(case)
    assert_equal_trees(got, want, name)
    cow, failed = got["cow"], got["failed"]
    source = case["table"][:, 1]                # shared with table B
    if name == "cow_ok":
        assert cow[:, 1:3].all() and not failed.any()
        assert got["refcount"][np.arange(2), source].tolist() == [1, 1]
    if name == "cow_fail":
        assert failed[:, 1].all() and not cow.any()
        assert (got["table"][:, 1] == source).all()
        for n in range(4):                      # the source is not written
            np.testing.assert_array_equal(
                got["planes"][n][np.arange(2), source],
                case["pool"][n][np.arange(2), source])
        dirty1 = case["dirty"][:, 4:8]
        assert (got["slot_state"][:, 4:8][dirty1] == FREE).all()
    if name == "fresh_fail":
        assert failed[:, 3].all() and (got["block_type"][:, 3] == -1).all()
        assert (got["slot_state"][:, 12:16] == FREE).all()
    if name == "mixed":
        assert cow[:, 1].all() and failed[:, 2].all() and failed[:, 3].all()
    if name == "no_dirty":
        assert not cow.any() and not failed.any()


@pytest.mark.parametrize("name", ["ok", "fail"])
@pytest.mark.parametrize("seed", [0, 3])
def test_ref_cow_claim_extract_restore_match_reference(name, seed):
    """incref / release, ``cow_blocks`` (a private block in the mask is
    skipped; with the pool full the claim fails and the old mapping
    stays), ``extract_request`` -> ``restore_request`` and
    ``claim_blocks``, in sequence on one pool."""
    case = pool_case(name, seed)
    got, want = port_ops(case), jax_ops(case)
    assert_equal_trees(got, want, name)
    assert got["cow"][3] == (name == "ok")
    assert got["restore"][3] == (name == "ok")
    if name == "ok":
        # the restored request reads its spilled planes through the table
        table = torch_of(got["restore"][2])
        pool = CT.PoolView(*(torch_of(p) for p in got["restore"][0]))
        for g, w in zip(CT.gather_view(pool, table), got["extract"][0]):
            mapped = got["extract"][1]
            np.testing.assert_array_equal(numpy_of(g)[mapped], w[mapped])
