"""The port's encoder-decoder (whisper) and its serve steps against the JAX
package's, on the CPU, with the JAX parameters carried across by
``convert.py``, on whisper-medium's smoke form (2 + 2 layers, 16 stub
frames, 4 q / 2 kv heads of 16).

* ``layernorm``; ``encode`` (non-causal), ``cross_caches`` and
  ``logits_fn`` / ``hidden_fn`` with ``frames``: within 1e-4 (tied
  embeddings scaled by sqrt(d_model), learned positions, GELU MLP);
* ``decode_step_fullkv`` with the cross KV token by token: within 1e-4 of
  the reference and of the port's own teacher-forced forward;
* the three serve steps on both backends (the batch keys of
  ``repro.models.factory.input_specs``): prefill logits and FullKV logits
  and caches within 1e-4; the ThinKV step on a seeded pool (bits 2/4/8
  mixed, slots evicted and free) with the cross KV TBQ'd at 4 bits by the
  port's ``quantize_group`` (bit-exact to the reference's) against the
  JAX step on the same backend (its kernel backend through the Pallas
  kernel in interpret mode): logits within 1e-3, buffers within one bf16
  step (a later layer's rows: or 1e-3), ``buf_len`` exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import ct_cache as CJ  # noqa: E402
from repro.core import quantization as QJ  # noqa: E402
from repro.layers import norms as NJ  # noqa: E402
from repro.models import encdec as EJ  # noqa: E402
from repro.models import factory as FJ  # noqa: E402
from repro.serving import serve_step as SSJ  # noqa: E402
from repro_torch.config import ThinKVConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import batch_from_numpy  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import quantization as QT  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.layers import norms as NT  # noqa: E402
from repro_torch.models import encdec as ET  # noqa: E402
from repro_torch.models import factory as FT  # noqa: E402
from repro_torch.serving import serve_step as SST  # noqa: E402
from test_torch_hybrid import bf16_steps_or  # noqa: E402
from test_torch_serve_step import (TK, bf16_steps_apart,  # noqa: E402
                                   thinkv_batch)

ARCH = "whisper-medium"
B, S = 3, 10


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


def frames(seed, cfg, b=B):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def test_layernorm_matches_reference():
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((4, 7, 48)) + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    want = NJ.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = NT.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x))
    close(got, want, 1e-5)


def test_encoder_cross_caches_and_forward(models):
    jcfg, jp, tcfg, tp = models
    assert "lm_head" not in jp["embed"] and not hasattr(tp, "lm_head")
    fr, toks = frames(0, tcfg), tokens(1, (B, S), tcfg.vocab_size)
    enc_j = EJ.encode(jp, jnp.asarray(fr), jcfg)
    enc_t = ET.encode(tp, torch.from_numpy(fr), tcfg)
    close(enc_t, enc_j, 1e-4)
    for g, w in zip(ET.cross_caches(tp, enc_t, tcfg),
                    EJ.cross_caches(jp, enc_j, jcfg)):
        assert tuple(g.shape) == (tcfg.num_layers, B, tcfg.encoder_seq,
                                  tcfg.num_kv_heads, tcfg.head_dim)
        close(g, w, 1e-4)
    bj = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)}
    bt = {"tokens": torch.from_numpy(toks).long(),
          "frames": torch.from_numpy(fr)}
    want, _ = EJ.logits_fn(jp, bj, jcfg)
    got, aux = ET.logits_fn(tp, bt, tcfg)
    assert float(aux) == 0.0
    close(got, want, 1e-4)
    close(ET.hidden_fn(tp, bt, tcfg), EJ.hidden_fn(jp, bj, jcfg), 1e-4)


def test_fullkv_decode_with_cross_kv_token_by_token(models):
    jcfg, jp, tcfg, tp = models
    fr, toks = frames(2, tcfg, 2), tokens(3, (2, S), tcfg.vocab_size)
    enc = ET.encode(tp, torch.from_numpy(fr), tcfg)
    ck, cv = (c.transpose(0, 1).contiguous()
              for c in ET.cross_caches(tp, enc, tcfg))
    shape = (2, tcfg.num_layers, S, tcfg.num_kv_heads, tcfg.head_dim)
    kc_t, vc_t = torch.zeros(shape), torch.zeros(shape)
    kc_j, vc_j = jnp.zeros(shape), jnp.zeros(shape)
    one = jax.vmap(lambda t, p, kc, vc, n, a, b: EJ.decode_step_fullkv(
        jp, t, p, kc, vc, n, a, b, jcfg))
    ckj, cvj = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy())
    fwd = ET.decode_train(tp, torch.from_numpy(toks).long(), enc, tcfg)
    for i in range(S):
        pos = np.full(2, i, np.int32)
        lg_j, kc_j, vc_j = one(jnp.asarray(toks[:, i]), jnp.asarray(pos),
                               kc_j, vc_j, jnp.asarray(pos), ckj, cvj)
        p = torch.from_numpy(pos)
        lg_t, kc_t, vc_t = ET.decode_step_fullkv(
            tp, torch.from_numpy(toks[:, i]), p, kc_t, vc_t, p, ck, cv, tcfg)
        close(lg_t, lg_j, 1e-4)
        close(lg_t, fwd[:, i].numpy(), 1e-4)
    close(kc_t, kc_j, 1e-4)
    close(vc_t, vc_j, 1e-4)


def test_prefill_and_fullkv_serve_steps(models):
    jcfg, jp, tcfg, tp = models
    fr, toks = frames(4, tcfg), tokens(5, (B, S), tcfg.vocab_size)
    want = SSJ.make_prefill_step(None, jcfg)(
        jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)})
    got = SST.make_prefill_step(FT.build_model(tcfg), tcfg)(
        tp, {"tokens": torch.from_numpy(toks).long(),
             "frames": torch.from_numpy(fr)})
    assert tuple(got.shape) == (B, tcfg.vocab_size)
    close(got, want, 1e-4)
    rng = np.random.default_rng(6)
    T = S + 4
    shape = (B, tcfg.num_layers, T, tcfg.num_kv_heads, tcfg.head_dim)
    cshape = (B, tcfg.num_layers, tcfg.encoder_seq, tcfg.num_kv_heads,
              tcfg.head_dim)
    clen = np.asarray([S, 3, 0], np.int32)
    batch = {"tokens": tokens(7, (B,), tcfg.vocab_size),
             "positions": clen.copy(),
             "k_cache": rng.standard_normal(shape).astype(np.float32),
             "v_cache": rng.standard_normal(shape).astype(np.float32),
             "cache_len": clen,
             "cross_k": rng.standard_normal(cshape).astype(np.float32),
             "cross_v": rng.standard_normal(cshape).astype(np.float32)}
    want = SSJ.make_decode_step_fullkv(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = SST.make_decode_step_fullkv(tcfg)(tp, batch_from_numpy(batch,
                                                                "cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        close(g, w, 1e-4)


def cross_tbq(seed, cfg, b=B):
    """Cross KV [B, L, T_enc, Hkv, hd] from a numpy seed, TBQ'd at 4 bits
    by the reference and by the port: (the batch's four arrays, whether
    the two quantizations are bit-exact)."""
    rng = np.random.default_rng(seed)
    shape = (b, cfg.num_layers, cfg.encoder_seq, cfg.num_kv_heads,
             cfg.head_dim)
    out, exact = {}, True
    for n in ("k", "v"):
        x = rng.standard_normal(shape).astype(np.float32)
        cj, sj = QJ.quantize_group(jnp.asarray(x), 4)
        ct, st = QT.quantize_group(torch.from_numpy(x), 4)
        sj16 = np.asarray(sj.astype(jnp.bfloat16))
        exact &= np.array_equal(ct.numpy(), np.asarray(cj))
        exact &= np.array_equal(
            st.to(torch.bfloat16).view(torch.int16).numpy(),
            sj16.view(np.int16))
        out[f"cross_{n}_codes"], out[f"cross_{n}_scales"] = \
            np.asarray(cj), sj16
    return out, exact


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_thinkv_serve_step(models, backend, monkeypatch):
    """The ThinKV step: the decoder's self-attention pool and buffer read
    by the backend (K1's wrapper once per layer for the batch on the kernel
    backend, plain on the CPU), the TBQ'd cross KV dequantized and attended
    in plain torch on both."""
    jcfg, jp, tcfg, tp = models
    jtk, ttk = JTK(**TK), ThinKVConfig(**TK)
    dims = CJ.make_dims(jtk, jcfg.num_layers, jcfg.num_kv_heads,
                        jcfg.head_dim)
    cross, exact = cross_tbq(9, tcfg)
    assert exact
    batch = {**thinkv_batch(8, tcfg, dims), **cross}
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
    assert ops.LAUNCHES == launches
    if backend == "kernel":
        assert calls == [(1, B, dims.H, tcfg.num_heads // dims.H,
                          dims.D)] * tcfg.num_layers
    else:
        assert not calls
    assert len(got) == len(want) == 4
    err = float(np.abs(got[0].numpy() - np.asarray(want[0])).max())
    print(f"{backend}: logits {err:.3g} from JAX's")
    assert err <= 1e-3
    for g, w in zip(got[1:3], want[1:3]):
        assert g.dtype == torch.bfloat16
        assert bf16_steps_apart(g[:, 0], w[:, 0]) <= 2 ** -7
        assert bf16_steps_or(g, w, 1e-3) <= 1
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[3].numpy(), batch["buf_len"] + 1)
