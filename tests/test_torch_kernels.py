"""Plain versions of K1-K3 (what ``kernels.ops`` runs for CPU tensors)
against the JAX Pallas kernels in interpret mode, and against the JAX
oracles for the ``kv_valid`` case the Pallas kernel does not take.

f32 on both sides; only the summation order differs, so the bar is 1e-5
absolute."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as QJ  # noqa: E402
from repro.kernels import ref as RJ  # noqa: E402
from repro.kernels.ct_paged_attention import (  # noqa: E402
    ct_paged_attention_batched, ct_paged_attention_fused)
from repro.kernels.flash_prefill import flash_prefill  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as RT  # noqa: E402

ATOL = 1e-5


def pool_inputs(seed, L, R, H, GQ, D, BS, NB, G=8):
    """Pool planes with mixed bits, evicted/free slots and -1 table entries
    (unmapped logical blocks hold only FREE slots), numpy from a seed."""
    rng = np.random.default_rng(seed)
    NP = R * NB + 2
    codes = lambda: rng.integers(0, 256, (L, NP, BS, H, D)).astype(np.uint8)
    scales = lambda: np.asarray(QJ.e4m3_round(jnp.asarray(rng.uniform(
        0.002, 0.03, (L, NP, BS, H, D // 16)).astype(np.float32)))).astype(
            jnp.bfloat16)
    table = np.stack([np.stack([rng.permutation(NP)[:NB]
                                for _ in range(L)]) for _ in range(R)])
    table = np.where(rng.random((R, L, NB)) < 0.25, -1, table).astype(
        np.int32)
    u = rng.random((L, R, NB, BS))
    state = np.where(u < 0.7, 1, np.where(u < 0.85, 2, 0)).astype(np.uint8)
    state[np.transpose(table < 0, (1, 0, 2))] = 0
    bits = rng.choice(np.array([2, 4, 8], np.uint8), (L, R, NB, BS))
    return dict(
        qh=rng.standard_normal((L, R, H, GQ, D)).astype(np.float32),
        k_codes=codes(), v_codes=codes(), k_scales=scales(),
        v_scales=scales(), slot_state=state, slot_bits=bits,
        block_table=table,
        buf_k=rng.standard_normal((L, R, G, H, D)).astype(jnp.bfloat16),
        buf_v=rng.standard_normal((L, R, G, H, D)).astype(jnp.bfloat16),
        buf_len=np.array([0, G // 2 + 1][:R], np.int32))


def to_torch(d):
    return {k: tensor_from_numpy(v, "cpu") for k, v in d.items()}


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


SHAPES = [dict(GQ=2, D=16, BS=8), dict(GQ=8, D=32, BS=16),
          dict(GQ=2, D=32, BS=16), dict(GQ=8, D=16, BS=8),
          dict(GQ=8, D=256, BS=16)]           # the last paligemma-3b's


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fused_plain_matches_pallas(shape):
    """K1: every layer and slot, pool merged with the fp TBQ buffer; slot 0
    has an empty buffer (the pool partition alone, early in a request)."""
    a = pool_inputs(11, L=2, R=2, H=2, NB=4, **shape)
    out_j = ct_paged_attention_fused(*map(jnp.asarray, a.values()),
                                     interpret=True)
    launches = dict(ops.LAUNCHES)
    out_t = ops.paged_decode_attention_fused(*to_torch(a).values())
    assert ops.LAUNCHES == launches
    close(out_t, out_j)


def test_fused_fully_masked_pool_gives_the_buffer_result():
    """A slot whose pool partition is fully masked returns the buffer's
    attention (finite sentinel, no NaN from the merge)."""
    a = pool_inputs(12, L=1, R=2, H=2, GQ=2, D=16, BS=8, NB=4)
    a["slot_state"][:] = 0
    a["block_table"][:] = -1
    out_t = ops.paged_decode_attention_fused(*to_torch(a).values())
    assert torch.isfinite(out_t).all()
    t = to_torch(a)
    ob, _, _ = RT.buffer_attention_batched_ref(t["qh"][0], t["buf_k"][0],
                                               t["buf_v"][0], t["buf_len"])
    close(out_t[0, 1], ob[1].numpy())


@pytest.mark.parametrize("h", [3, 4])
def test_fused_plain_matches_pallas_at_head_dim_112(h):
    """K1 at head_dim 112 (zamba2-7b's: 7 scale groups a row, so a head's
    scales start 2-byte aligned at odd heads) with GQ 1 as in zamba2, bits
    2/4/8, BS 16, over odd and even kv head counts; slot 0 of layer 0 is a
    fully masked row (its pool all masked, its buffer empty: output 0) and
    slot 1 of layer 1 has its pool masked (the buffer's attention)."""
    a = pool_inputs(30 + h, L=2, R=2, H=h, GQ=1, D=112, BS=16, NB=4, G=16)
    a["slot_state"][0, 0] = 0
    a["slot_state"][1, 1] = 0
    out_j = ct_paged_attention_fused(*map(jnp.asarray, a.values()),
                                     interpret=True)
    out_t = ops.paged_decode_attention_fused(*to_torch(a).values())
    close(out_t, out_j)
    assert float(out_t[0, 0].abs().max()) == 0.0
    np.testing.assert_allclose(
        RT.ct_paged_attention_fused_warps_ref(*to_torch(a).values()).numpy(),
        np.asarray(out_j), rtol=0, atol=1e-4)


def test_only_k1_takes_head_dim_112():
    """K1 has a D 112 instance; K2 and K3 do not, and refuse it on either
    device."""
    ops._check_head_dim("K1", 112, ops.K1_HEAD_DIMS)
    with pytest.raises(ValueError, match="head_dim 16, 32, 64, 128, 256"):
        ops._check_head_dim("K2", 112)
    a = to_torch(pool_inputs(33, L=1, R=1, H=2, GQ=2, D=112, BS=16, NB=2))
    with pytest.raises(ValueError, match="K2 takes head_dim"):
        ops.paged_decode_attention_batched(
            a["qh"][0], a["k_codes"][0], a["v_codes"][0], a["k_scales"][0],
            a["v_scales"][0], a["slot_state"][0], a["slot_bits"][0],
            a["block_table"][:, 0].contiguous())
    q = torch.zeros((16, 2, 112))
    with pytest.raises(ValueError, match="K3 takes head_dim"):
        ops.prefill_attention_stats(q, q, q)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_batched_plain_matches_pallas(shape):
    """K2: one layer's pool walk with (out, m, l) stats."""
    a = pool_inputs(13, L=1, R=2, H=2, NB=4, **shape)
    args = [a["qh"][0], a["k_codes"][0], a["v_codes"][0], a["k_scales"][0],
            a["v_scales"][0], a["slot_state"][0], a["slot_bits"][0],
            np.ascontiguousarray(a["block_table"][:, 0])]
    outs_j = ct_paged_attention_batched(*map(jnp.asarray, args),
                                        interpret=True)
    outs_t = ops.paged_decode_attention_batched(
        *(tensor_from_numpy(x, "cpu") for x in args))
    for t, j in zip(outs_t, outs_j):
        close(t, j)


def test_merge_and_buffer_attention_match_oracles():
    a = pool_inputs(14, L=1, R=2, H=2, GQ=4, D=16, BS=8, NB=4)
    qh, bk, bv, bl = a["qh"][0], a["buf_k"][0], a["buf_v"][0], a["buf_len"]
    oj, mj, lj = RJ.buffer_attention_batched_ref(*map(jnp.asarray,
                                                      (qh, bk, bv, bl)))
    ot, mt, lt = RT.buffer_attention_batched_ref(
        *(tensor_from_numpy(x, "cpu") for x in (qh, bk, bv, bl)))
    for t, j in ((ot, oj), (mt, mj), (lt, lj)):
        close(t, j)
    rng = np.random.default_rng(15)
    o2 = rng.standard_normal(np.asarray(oj).shape).astype(np.float32)
    m2 = rng.standard_normal(np.asarray(mj).shape).astype(np.float32)
    l2 = rng.uniform(0.5, 3, np.asarray(lj).shape).astype(np.float32)
    mj_ = RJ.merge_flash_ref(oj[1], mj[1], lj[1], jnp.asarray(o2[1]),
                             jnp.asarray(m2[1]), jnp.asarray(l2[1]))
    mt_ = RT.merge_flash_ref(ot[1], mt[1], lt[1], torch.from_numpy(o2[1]),
                             torch.from_numpy(m2[1]), torch.from_numpy(l2[1]))
    close(mt_, mj_)


@pytest.mark.parametrize("hq,h,d", [(4, 2, 32), (8, 8, 16), (8, 1, 32),
                                    (8, 1, 256)])
def test_flash_prefill_stats_plain_matches_pallas(hq, h, d):
    """K3 with stats, window 0, S = 128 (the big-chunk shape)."""
    rng = np.random.default_rng(16)
    s = 128
    q = rng.standard_normal((s, hq, d)).astype(np.float32)
    k = rng.standard_normal((s, h, d)).astype(np.float32)
    v = rng.standard_normal((s, h, d)).astype(np.float32)
    outs_j = flash_prefill(*map(jnp.asarray, (q, k, v)), block_q=64,
                           block_k=64, interpret=True, return_stats=True)
    outs_t = ops.prefill_attention_stats(
        *map(torch.from_numpy, (q, k, v)))
    for t, j in zip(outs_t, outs_j):
        close(t, j)
    out_j = flash_prefill(*map(jnp.asarray, (q, k, v)), block_q=64,
                          block_k=64, interpret=True)
    close(RT.flash_prefill_ref(*map(torch.from_numpy, (q, k, v))), out_j)


@pytest.mark.parametrize("s,n_valid", [(8, 5), (16, 11), (16, 16), (8, 1)])
def test_flash_prefill_n_valid_matches_kv_valid_oracle(s, n_valid):
    """K3 with ``n_valid < S``: the padded g-sized chunk the JAX engine
    routes to ``flash_prefill_stats_ref(kv_valid=...)``."""
    rng = np.random.default_rng(17 + s)
    q = rng.standard_normal((s, 8, 16)).astype(np.float32)
    k = rng.standard_normal((s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((s, 2, 16)).astype(np.float32)
    outs_j = RJ.flash_prefill_stats_ref(
        *map(jnp.asarray, (q, k, v)), kv_valid=jnp.arange(s) < n_valid)
    outs_t = ops.prefill_attention_stats(*map(torch.from_numpy, (q, k, v)),
                                         n_valid=n_valid)
    for t, j in zip(outs_t, outs_j):
        close(t, j)


@pytest.mark.parametrize("window", (0, 40))
def test_prefill_attention_plain_matches_pallas(window):
    """K3 without stats (``ops.prefill_attention``, the plain variant's
    entry): S = 128 with and without a sliding window."""
    rng = np.random.default_rng(18 + window)
    q = rng.standard_normal((128, 4, 32)).astype(np.float32)
    k = rng.standard_normal((128, 2, 32)).astype(np.float32)
    v = rng.standard_normal((128, 2, 32)).astype(np.float32)
    out_j = flash_prefill(*map(jnp.asarray, (q, k, v)), window=window,
                          block_q=64, block_k=64, interpret=True)
    launches = dict(ops.LAUNCHES)
    out_t = ops.prefill_attention(*map(torch.from_numpy, (q, k, v)),
                                  window=window)
    assert ops.LAUNCHES == launches
    close(out_t, out_j)


def _batched_args(a):
    return [a["qh"][0], a["k_codes"][0], a["v_codes"][0], a["k_scales"][0],
            a["v_scales"][0], a["slot_state"][0], a["slot_bits"][0],
            np.ascontiguousarray(a["block_table"][:, 0])]


def _pool_edge(case):
    """K2 inputs whose live-block walk has an edge: no live block, one live
    block at the last table entry, a mapped block whose slots are all
    EVICTED (2), or a ragged GQ; unmapped (-1) entries hold FREE slots."""
    a = pool_inputs(19, L=1, R=2, H=2, GQ=100 if case == "ragged" else 4,
                    D=32, BS=16, NB=5)
    st, tb = a["slot_state"], a["block_table"]
    if case == "empty":
        tb[:] = -1
        st[:] = 0
    elif case in ("last_block_only", "all_evicted"):
        last = case == "last_block_only"
        tb[:] = -1
        tb[:, 0, -1 if last else 1] = [3, 7]
        st[:] = 0
        if last:
            st[0, :, -1, 3] = 1
        else:
            st[0, :, 1] = 2
    return a


@pytest.mark.parametrize("splits", (1, 3, 7))
@pytest.mark.parametrize("case", ("random", "empty", "last_block_only",
                                  "all_evicted", "ragged"))
def test_split_kv_decomposition_matches_pallas(case, splits):
    """K2's split-KV walk (live blocks only, ``splits`` shares, flash merge
    of the partials) against the Pallas kernel in interpret mode: a fully
    masked row stays (out 0, m -1e30, l 0), with no NaN."""
    args = _batched_args(_pool_edge(case))
    outs_j = ct_paged_attention_batched(*map(jnp.asarray, args),
                                        interpret=True)
    outs_t = RT.ct_paged_attention_split_ref(
        *(tensor_from_numpy(x, "cpu") for x in args), splits=splits)
    for t, j in zip(outs_t, outs_j):
        assert torch.isfinite(t).all()
        close(t, j)
    if case in ("empty", "all_evicted"):
        assert float(outs_t[1].max()) == float(np.float32(-1e30))
        assert float(outs_t[2].abs().max()) == 0.0


@pytest.mark.parametrize("gq,want", [(512, 4), (64, 32), (4, 32), (100, 16)])
def test_kv_splits_fill_the_card(gq, want):
    """K2's share count at r1-llama-8b's shapes (R 1, H 8, NB 128) on 132
    SMs: about two blocks per SM, at most 32 shares and one per entry."""
    assert ops.kv_splits(1, 8, gq, 128, 132, 128) == want
    assert ops.kv_splits(1, 8, gq, 3, 132, 128) == 3
    assert ops.kv_splits(4, 8, 512, 128, 132, 128) == 1


def _fused_edge(case):
    """K1 inputs whose warp-split walk has an edge: no live block, one live
    block at the last table entry, a mapped block whose slots are all
    EVICTED, two live blocks (fewer than the kernel's 4 warps), an empty
    or a full fp buffer; "random" mixes 2/4/8 bits, evicted and free slots
    and -1 entries."""
    a = pool_inputs(20, L=2, R=2, H=2, GQ=4, D=32, BS=16, NB=5)
    st, tb = a["slot_state"], a["block_table"]
    G = a["buf_k"].shape[2]
    if case in ("empty", "last_block_only", "all_evicted", "few_live"):
        tb[:] = -1
        st[:] = 0
    if case == "last_block_only":
        tb[:, :, -1] = [[3, 7], [8, 1]]
        st[:, :, -1, 5] = 1
    elif case == "all_evicted":
        tb[:, :, 1] = [[3, 7], [8, 1]]
        st[:, :, 1] = 2
    elif case == "few_live":
        tb[:, :, 1:3] = [[[3, 4], [7, 9]], [[8, 2], [1, 0]]]
        st[:, :, 1:3, ::3] = 1
    elif case == "buf_empty":
        a["buf_len"][:] = 0
    elif case == "buf_full":
        a["buf_len"][:] = G
    return a


@pytest.mark.parametrize("warps", (1, 4))
@pytest.mark.parametrize("case", ("random", "empty", "last_block_only",
                                  "all_evicted", "few_live", "buf_empty",
                                  "buf_full"))
def test_fused_warp_decomposition_matches_pallas(case, warps):
    """K1's walk (live blocks and then the fp buffer as items, dealt to
    ``warps`` warps in turn, flash merge of the warps' partials) against
    the Pallas kernel in interpret mode, within 1e-5: a slot with no live
    block and an empty buffer gives 0, with no NaN."""
    a = _fused_edge(case)
    out_j = ct_paged_attention_fused(*map(jnp.asarray, a.values()),
                                     interpret=True)
    out_t = RT.ct_paged_attention_fused_warps_ref(*to_torch(a).values(),
                                                  warps=warps)
    assert torch.isfinite(out_t).all()
    close(out_t, out_j)
    if case == "empty":
        assert float(out_t[:, 0].abs().max()) == 0.0      # buf_len[0] = 0


@pytest.mark.parametrize("d,ok", [(16, True), (32, True), (64, True),
                                  (128, True), (8, False), (48, False),
                                  (256, True), (512, False)])
def test_paged_kernels_take_the_head_dims_they_have_instances_for(d, ok):
    """K1 and K2 have CUDA instances for head_dim 16 (the trace config's),
    32, 64, 128 and 256 (paligemma-3b's); the wrappers' check refuses any
    other on the card."""
    if ok:
        ops._check_head_dim("K1", d, ops.K1_HEAD_DIMS)
        ops._check_head_dim("K2", d)
    else:
        for kernel, dims in (("K1", ops.K1_HEAD_DIMS), ("K2", ops.HEAD_DIMS)):
            with pytest.raises(ValueError, match=f"{kernel} takes head_dim "
                               f"{', '.join(map(str, dims))}"):
                ops._check_head_dim(kernel, d, dims)


@pytest.mark.parametrize("gq,want", [(1024, 8), (128, 32), (8, 32)])
def test_kv_splits_count_the_column_slices_at_head_dim_256(gq, want):
    """At head_dim 256 a K2 row tile is two blocks (column slices of 128),
    so paligemma-3b's big chunk (R 1, H 1, GQ 1024, NB 128) takes half the
    shares its 16 row tiles alone would give (about two blocks per SM);
    head_dims up to 128 are one slice."""
    assert ops.kv_splits(1, 1, gq, 128, 132, 256) == want
    assert ops.kv_splits(1, 1, gq, 128, 132, 128) == \
        ops.kv_splits(1, 1, gq, 128, 132, 16) == min(2 * 132 // -(-gq // 64),
                                                     32)
