"""The dense serve steps (``repro_torch/serving/serve_step.py``) and the
FullKV paths of ``repro_torch/models/lm.py`` against the JAX package's, on
r1-llama-8b's smoke config with the JAX parameters carried across, on the
CPU.

* the prefill step and ``lm.prefill``: logits within 1e-3, the post-RoPE
  caches within 1e-5 (f32 on both sides);
* the FullKV decode step over f32 caches (the JAX step needs caches of the
  weights' dtype) with ragged cache lengths: logits within 1e-3, caches
  within 1e-5;
* the ThinKV decode step over a numpy-seeded paged pool and bf16 buffer,
  each port backend against the same JAX backend (its ``kernel`` backend
  through the Pallas kernel in interpret mode, ``force="pallas"``):
  logits within 1e-3, buffers within one bf16 step, ``buf_len`` exact;
  the port's kernel backend calls K1's wrapper once per layer for the
  whole batch;
* ``full_attention``'s q-chunked path above 2048 query rows against the
  reference's ``_full_attention``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import ct_cache as CJ  # noqa: E402
from repro.layers import attention as AJ  # noqa: E402
from repro.models import factory as FJ  # noqa: E402
from repro.models import lm as LJ  # noqa: E402
from repro.serving import serve_step as SSJ  # noqa: E402
from repro_torch.config import ThinKVConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import batch_from_numpy  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.layers import attention as AT  # noqa: E402
from repro_torch.models import lm as LT  # noqa: E402
from repro_torch.serving import serve_step as SST  # noqa: E402

ARCH = "r1-llama-8b"
TK = dict(refresh_interval=8, group_size=8, block_size=8, token_budget=32,
          retention_schedule=(16, 8, 4), min_retention=4, max_segments=64,
          kmeans_iters=2)
B, S = 3, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    several pytest workers on one host the threads' wake-ups dominate:
    run this module's torch ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(ARCH)
    jp = FJ.build_model(jcfg).init_params(0)
    tcfg = get_smoke_config(ARCH)
    return jcfg, jp, tcfg, params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def close(t, j, atol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=0, atol=atol)


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def test_prefill_step_and_lm_prefill(models):
    jcfg, jp, tcfg, tp = models
    toks = tokens(0, (B, S), tcfg.vocab_size)
    want = SSJ.make_prefill_step(None, jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got = SST.make_prefill_step(None, tcfg)(
        tp, {"tokens": torch.from_numpy(toks).long()})
    assert tuple(got.shape) == (B, tcfg.vocab_size)
    close(got, want, 1e-3)
    lg_j, kc_j, vc_j = LJ.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    lg_t, kc_t, vc_t = LT.prefill(tp, {"tokens": torch.from_numpy(toks)
                                       .long()}, tcfg)
    assert tuple(kc_t.shape) == (tcfg.num_layers, B, S, tcfg.num_kv_heads,
                                 tcfg.head_dim)
    close(lg_t, lg_j, 1e-3)
    close(lg_t, got, 1e-5)
    close(kc_t, kc_j, 1e-5)
    close(vc_t, vc_j, 1e-5)


def test_fullkv_decode_step(models):
    """One token per request over caches of T = S + 8 rows filled to
    ragged lengths (the rest of each cache random, masked out)."""
    jcfg, jp, tcfg, tp = models
    toks = tokens(1, (B, S), tcfg.vocab_size)
    _, kc, vc = LJ.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    rng = np.random.default_rng(2)
    T = S + 8
    shape = (B, tcfg.num_layers, T, tcfg.num_kv_heads, tcfg.head_dim)
    caches = []
    for c in (kc, vc):
        full = rng.standard_normal(shape).astype(np.float32)
        full[:, :, :S] = np.asarray(c).transpose(1, 0, 2, 3, 4)
        caches.append(full)
    clen = np.asarray([S, S - 5, 11], np.int32)
    batch = {"tokens": tokens(3, (B,), tcfg.vocab_size),
             "positions": clen.copy(), "k_cache": caches[0],
             "v_cache": caches[1], "cache_len": clen}
    want = SSJ.make_decode_step_fullkv(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = SST.make_decode_step_fullkv(tcfg)(tp, batch_from_numpy(batch,
                                                                "cpu"))
    close(got[0], want[0], 1e-3)
    close(got[1], want[1], 1e-5)
    close(got[2], want[2], 1e-5)
    # the new rows landed at cache_len, the rest untouched
    for b, n in enumerate(clen):
        assert not np.array_equal(got[1][b, :, n].numpy(), caches[0][b, :, n])
    assert np.array_equal(got[1][:, :, T - 1].numpy(), caches[0][:, :, T - 1])


def thinkv_batch(seed, cfg, dims, b=B):
    """A ThinKV step's batch from numpy seed ``seed``: random codes,
    E4M3-valued bf16 scales, valid / evicted / free slots, bits 2, 4, 8,
    bf16 buffers with buf_len 0, 3 and G - 1."""
    rng = np.random.default_rng(seed)
    L, NB, BS, H, D, G = dims.L, dims.NB, dims.BS, dims.H, dims.D, dims.G
    shape = (b, L, NB, BS, H)
    u = rng.random((b, L, dims.NS))

    def scales():
        s = torch.from_numpy(rng.random(shape + (D // 16,), np.float32)
                             * 0.04 + 0.004)
        return s.to(torch.float8_e4m3fn).float().to(torch.bfloat16) \
            .view(torch.int16).numpy().view(jnp.bfloat16)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, b).astype(np.int32),
        "positions": rng.integers(40, 400, b).astype(np.int32),
        "k_codes": rng.integers(0, 256, shape + (D,)).astype(np.uint8),
        "v_codes": rng.integers(0, 256, shape + (D,)).astype(np.uint8),
        "k_scales": scales(), "v_scales": scales(),
        "slot_state": np.where(u < 0.6, 1, np.where(u < 0.8, 2, 0))
        .astype(np.uint8),
        "slot_bits": np.asarray([2, 4, 8], np.uint8)[
            rng.integers(0, 3, (b, L, dims.NS))],
        "buf_k": rng.standard_normal((b, L, G, H, D)).astype(jnp.bfloat16),
        "buf_v": rng.standard_normal((b, L, G, H, D)).astype(jnp.bfloat16),
        "buf_len": np.asarray([0, 3, G - 1][:b], np.int32)}


def bf16_steps_apart(got, want):
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    return float((np.abs(g - w) / np.maximum(np.maximum(np.abs(g),
                                                        np.abs(w)),
                                             1e-30)).max())


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_thinkv_decode_step(models, backend, monkeypatch):
    jcfg, jp, tcfg, tp = models
    jtk, ttk = JTK(**TK), ThinKVConfig(**TK)
    dims = CJ.make_dims(jtk, jcfg.num_layers, jcfg.num_kv_heads,
                        jcfg.head_dim)
    batch = thinkv_batch(4, tcfg, dims)
    want = SSJ.make_decode_step_thinkv(
        jcfg, jtk, backend=backend,
        force="pallas" if backend == "kernel" else None)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    calls = []
    k1 = ops.paged_decode_attention_fused
    monkeypatch.setattr(ops, "paged_decode_attention_fused",
                        lambda *a, **kw: calls.append(a[0].shape)
                        or k1(*a, **kw))
    launches = dict(ops.LAUNCHES)
    got = SST.make_decode_step_thinkv(tcfg, ttk, backend=backend)(
        tp, batch_from_numpy(batch, "cpu"))
    assert ops.LAUNCHES == launches        # plain versions on the CPU
    if backend == "kernel":
        # one K1 call per layer for the whole batch: L 1, R B
        assert calls == [(1, B, dims.H, tcfg.num_heads // dims.H, dims.D)] \
            * tcfg.num_layers
    else:
        assert not calls
    err = float(np.abs(got[0].numpy() - np.asarray(want[0])).max())
    print(f"{backend}: logits {err:.3g} from JAX's")
    assert err <= 1e-3
    for g, w in zip(got[1:3], want[1:3]):
        assert g.dtype == torch.bfloat16
        assert bf16_steps_apart(g, w) <= 2 ** -7
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[3].numpy(), batch["buf_len"] + 1)


def test_the_step_backends_differ_by_the_bf16_dequant(models):
    """The reference backend rounds the dequantized pool, the queries and
    the probabilities to bf16 (the reference's numerics); the kernel
    backend reads the pool in f32: the two differ by more than the
    kernels' error, less than the bf16 rounding's reach."""
    _, _, tcfg, tp = models
    ttk = ThinKVConfig(**TK)
    dims = CJ.make_dims(JTK(**TK), tcfg.num_layers, tcfg.num_kv_heads,
                        tcfg.head_dim)
    batch = batch_from_numpy(thinkv_batch(5, tcfg, dims), "cpu")
    ref = SST.make_decode_step_thinkv(tcfg, ttk, backend="reference")(
        tp, batch)
    ker = SST.make_decode_step_thinkv(tcfg, ttk, backend="kernel")(
        tp, batch)
    gap = float((ref[0] - ker[0]).abs().max())
    assert 1e-4 < gap < 0.1, gap
    with pytest.raises(ValueError, match="backend"):
        SST.make_decode_step_thinkv(tcfg, ttk, backend="auto")


@pytest.mark.parametrize("s,window", [(2080, 0), (2112, 64)])
def test_long_full_attention_takes_the_chunked_path(s, window):
    """Above 2048 query rows both packages attend in q chunks (512 rows,
    halved until they divide S): the port's against the reference's."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((1, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, s, 2, 16)).astype(np.float32)
    want = AJ._full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window)
    got = AT.full_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                            window=window)
    close(got, want, 1e-5)
    short = AT.full_attention(*(torch.from_numpy(a[:, :64]) for a in
                                (q, k, v)), causal=True, window=window)
    close(short, AJ._full_attention(*(jnp.asarray(a[:, :64]) for a in
                                      (q, k, v)), causal=True, window=window),
          1e-5)
