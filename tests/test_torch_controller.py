"""The port's single-request ThinKV controller against the JAX package's,
on the CPU: the ``ct_paged_attention`` wrapper (its plain version, K2's on
gathered metadata) against the Pallas kernel in interpret mode, and a
``step_token`` sequence (appends, commits past the budget, tau refreshes
that open and then close a transition segment) whose state must stay
bit-exact, with the decode attention, the layer sparsity and the
compression accounting held to the JAX package's bars at every tau
boundary.

Keys come in runs around separated centres, so TBE's k-means has one clear
medoid per cluster (ROADMAP queue 3: ties are decided by float rounding)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.core import ct_cache as CJ  # noqa: E402
from repro.core import quantization as QJ  # noqa: E402
from repro.core import thinkv as TVJ  # noqa: E402
from repro.kernels import ops as OJ  # noqa: E402
from repro.kernels.ct_paged_attention import ct_paged_attention  # noqa: E402
from repro_torch.config import ThinKVConfig  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core import ct_cache as CT  # noqa: E402
from repro_torch.core import thinkv as TVT  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as RT  # noqa: E402

L, H, D = 2, 2, 32
TK = dict(refresh_interval=16, token_budget=32, retention_schedule=(16, 4),
          min_retention=4, max_segments=16, kmeans_iters=2)
RUN = 4
# planted sparsity per tau window, R -> E -> T -> R (examples/quickstart.py)
SPARSITY = (0.65, 0.30, 0.92, 0.65)


def as_bits(a):
    """Any array (jax, numpy, torch) -> numpy, bf16 as its uint16 bits."""
    if torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def t(a):
    return tensor_from_numpy(a, "cpu")


# ---------------------------------------------------------------------------
# the single-request wrapper
# ---------------------------------------------------------------------------

def wrapper_inputs(seed, hq, d, nb=6, bs=16):
    """A shuffled physical pool of nb + 3 blocks, PHYSICAL metadata, and a
    raw table with -1 entries (physical block 0 holds VALID slots, so an
    unmapped entry that read it unmasked would change the result)."""
    rng = np.random.default_rng(seed)
    np_ = nb + 3
    codes = lambda: rng.integers(0, 256, (np_, bs, H, d)).astype(np.uint8)
    scales = lambda: np.asarray(QJ.e4m3_round(jnp.asarray(rng.uniform(
        0.002, 0.03, (np_, bs, H, d // 16)).astype(np.float32)))).astype(
            jnp.bfloat16)
    u = rng.random((np_, bs))
    state = np.where(u < 0.7, 1, np.where(u < 0.85, 2, 0)).astype(np.uint8)
    state[0] = 1
    table = rng.permutation(np_)[:nb].astype(np.int32)
    table[[1, 4]] = -1
    return (rng.standard_normal((hq, d)).astype(np.float32), codes(),
            codes(), scales(), scales(), state,
            rng.choice(np.array([2, 4, 8], np.uint8), (np_, bs)), table)


@pytest.mark.parametrize("gq", (1, 4))
@pytest.mark.parametrize("d", (32, 64, 128))
def test_wrapper_plain_matches_pallas(gq, d):
    args = wrapper_inputs(d + gq, H * gq, d)
    outs_j = ct_paged_attention(*map(jnp.asarray, args), group=16,
                                interpret=True)
    launches = dict(ops.LAUNCHES)
    outs_t = ops.paged_decode_attention(*map(t, args))
    assert ops.LAUNCHES == launches          # CPU tensors: the plain version
    for a, b, r in zip(outs_t, RT.ct_paged_attention_ref(*map(t, args)),
                       outs_j):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=3e-5,
                                   atol=3e-5)


def test_wrapper_refuses_logical_metadata():
    q, kc, vc, ks, vs, state, bits, table = map(t, wrapper_inputs(0, 4, 32))
    with pytest.raises(ValueError, match="shape"):
        ops.paged_decode_attention(q, kc, vc, ks, vs, state[table.long()],
                                   bits, table)
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q, kc, vc, ks, vs, state, bits,
                                   table.long())


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

def clustered_stream(rng, n):
    """[n, L, H, D] f32 keys in runs of RUN tokens around separated
    centres, and standard-normal values."""
    centres = rng.standard_normal((n // RUN, L, H, D)) * 3
    keys = np.repeat(centres, RUN, axis=0) + \
        rng.standard_normal((n, L, H, D)) * 0.3
    return keys.astype(np.float32), \
        rng.standard_normal((n, L, H, D)).astype(np.float32)


def assert_same_state(cache_j, view_j, cache_t, view_t, where):
    for name, pj, pt in zip(CJ.PoolView._fields, view_j, view_t):
        np.testing.assert_array_equal(as_bits(pt), as_bits(pj),
                                      err_msg=f"{where}: {name}")
    for f in CJ.CTCache.FIELDS:
        np.testing.assert_array_equal(as_bits(getattr(cache_t, f)),
                                      as_bits(getattr(cache_j, f)),
                                      err_msg=f"{where}: {f}")


# (group, block size, precision, seed): one block per commit with 4-bit
# planes, and two blocks per commit with an 8-bit level
CASES = [(8, 8, (2, 4, 4), 8), (16, 8, (2, 4, 8), 16)]


@pytest.mark.parametrize("g,bs,prec,seed", CASES, ids=str)
def test_step_token_sequence_matches_reference(g, bs, prec, seed):
    tk_j = JTK(group_size=g, block_size=bs, precision=prec, **TK)
    tk_t = ThinKVConfig(group_size=g, block_size=bs, precision=prec, **TK)
    dims_j = CJ.make_dims(tk_j, L, H, D)
    dims_t = CT.make_dims(tk_t, L, H, D)
    assert tuple(dims_j) == tuple(dims_t)
    cache_j, view_j = CJ.init_cache(dims_j), CJ.init_pool_view(dims_j)
    cpu = torch.device("cpu")
    cache_t = CT.init_cache(dims_t, cpu)
    view_t = CT.init_pool_view(dims_t, dims_t.NB, cpu)
    step_j = jax.jit(functools.partial(TVJ.step_token, tk_j, dims_j))
    tau = tk_t.refresh_interval
    n = 6 * tau
    rng = np.random.default_rng(seed)
    keys, values = clustered_stream(rng, n)
    checks = 0
    for i in range(n):
        s = np.float32(SPARSITY[(i // tau) % len(SPARSITY)])
        cache_j, view_j = step_j(cache_j, view_j, jnp.asarray(keys[i]),
                                 jnp.asarray(values[i]), jnp.float32(s))
        cache_t, view_t = TVT.step_token(tk_t, dims_t, cache_t, view_t,
                                         t(keys[i]), t(values[i]),
                                         torch.tensor(s))
        assert_same_state(cache_j, view_j, cache_t, view_t, f"token {i}")
        if (i + 1) % tau:
            continue
        # a tau boundary: the read side against the reference's
        checks += 1
        q = rng.standard_normal((2 * H, D)).astype(np.float32)
        for layer in range(L):
            out_j = OJ.thinkv_decode_attention(dims_j, cache_j, view_j,
                                               jnp.asarray(q), layer,
                                               force="pallas")
            out_t = ops.thinkv_decode_attention(dims_t, cache_t, view_t,
                                                t(q), layer)
            np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                       rtol=3e-4, atol=3e-4)
            ref_j = TVJ.decode_attention_ref(dims_j, cache_j, view_j,
                                             jnp.asarray(q), layer)
            ref_t = TVT.decode_attention_ref(dims_t, cache_t, view_t, t(q),
                                             layer)
            np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref_j),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(out_t.numpy(), ref_t.numpy(),
                                       rtol=3e-4, atol=3e-4)
            np.testing.assert_allclose(
                float(TVT.layer_sparsity(dims_t, cache_t, view_t, t(q),
                                         layer)),
                float(TVJ.layer_sparsity(dims_j, cache_j, view_j,
                                         jnp.asarray(q), layer)),
                rtol=3e-4, atol=3e-4)
        comp_j = TVJ.compression_ratio(tk_j, dims_j, cache_j,
                                       jnp.int32(i + 1))
        comp_t = TVT.compression_ratio(tk_t, dims_t, cache_t, i + 1)
        assert set(comp_t) == set(comp_j)
        for k in comp_j:
            np.testing.assert_allclose(np.asarray(comp_t[k], np.float64),
                                       np.asarray(comp_j[k], np.float64),
                                       rtol=1e-6, err_msg=k)
        np.testing.assert_array_equal(CT.valid_counts(cache_t).numpy(),
                                      np.asarray(CJ.valid_counts(cache_j)))
    assert checks == 6
    # the sequence reached what it is meant to exercise
    state = np.asarray(cache_j.slot_state)
    assert (state == CJ.EVICTED).any() or \
        (np.asarray(cache_j.seg_level) > 1).any()
    assert int(CJ.ThoughtType.TRANSITION) in np.asarray(cache_j.seg_type)
    assert (state == CJ.VALID).sum(1).max() <= tk_t.token_budget + g
