"""The VLM family (paligemma-3b) in the port against the JAX package on the
CPU, with the JAX parameters carried by ``convert.params_from_numpy``.

* the config field for field, at full and at smoke size (4 q / 1 kv head,
  head_dim 16, 4 image tokens of width 32);
* ``layers/embedding.py``'s ``frontend_stub`` and its weight's shape;
* ``lm.assemble_inputs`` with and without ``patches``: the projected
  patches prepended, positions over the whole sequence;
* the teacher-forced forward with tied embeddings scaled by sqrt(d_model)
  and GeGLU, with and without an image prefix: logits within 1e-4;
* the three serve steps with a patch prefix: the prefill step over
  P + S rows, one FullKV step and one ThinKV step per backend (the JAX
  kernel backend through the Pallas kernel in interpret mode) at
  positions after the prefix: logits within 1e-3, caches within 1e-5,
  buffers within one bf16 step;
* the entry points (``init_params``, ``ThinKVEngine``, the CLI) take the
  family on the CPU and, with no card, refuse the default device.

The engine on the flash and pressure traces is in
``test_torch_archs_engine.py``, the vlm record in
``test_torch_trace_fixture.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import ct_cache as CJ  # noqa: E402
from repro.layers import embedding as EJ  # noqa: E402
from repro.models import lm as LJ  # noqa: E402
from repro.serving import serve_step as SSJ  # noqa: E402
from repro_torch.config import ArchFamily, ServeConfig  # noqa: E402
from repro_torch.config import ThinKVConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import batch_from_numpy  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.layers import embedding as ET  # noqa: E402
from repro_torch.models import factory as FT  # noqa: E402
from repro_torch.models import lm as LT  # noqa: E402
from repro_torch.serving import serve_step as SST  # noqa: E402
from repro_torch.serving.engine import ThinKVEngine  # noqa: E402
from test_torch_archs import TK, close, jax_params, plain  # noqa: E402
from test_torch_serve_step import (bf16_steps_apart, thinkv_batch,  # noqa
                                   tokens)

ARCH = "paligemma-3b"
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
    """(jax cfg, jax params as jnp arrays, port cfg, port LM)."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = jax_params(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, jp), tcfg, \
        params_from_numpy(jp, tcfg, "cpu")


def patches(seed, cfg, b=B):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_image_tokens, cfg.frontend_dim)).astype(np.float32)


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_equals_the_reference(size):
    """Every field of the port's config equals the JAX config's, and the
    JAX fields the port leaves out stand at their defaults."""
    import repro.config as RC
    jcfg, tcfg = ((jax_config(ARCH), get_config(ARCH)) if size == "full"
                  else (jax_smoke(ARCH), get_smoke_config(ARCH)))
    kept = {f.name for f in dataclasses.fields(tcfg)}
    assert {"num_image_tokens", "frontend_dim", "hybrid_attn_every",
            "encoder_layers", "encoder_seq", "cross_attention"} <= kept
    for name in kept:
        assert plain(getattr(jcfg, name)) == plain(getattr(tcfg, name)), name
    defaults = {f.name: f.default for f in dataclasses.fields(RC.ModelConfig)}
    for name in set(defaults) - kept:
        assert getattr(jcfg, name) == defaults[name], name
    assert tcfg.family == ArchFamily.VLM and tcfg.tie_embeddings
    if size == "full":
        assert (tcfg.num_layers, tcfg.d_model, tcfg.num_heads,
                tcfg.num_kv_heads, tcfg.head_dim, tcfg.d_ff,
                tcfg.vocab_size, tcfg.num_image_tokens,
                tcfg.frontend_dim) == (18, 2048, 8, 1, 256, 16384, 257216,
                                       256, 1152)
    else:
        assert (tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim,
                tcfg.num_image_tokens, tcfg.frontend_dim) == (4, 1, 16, 4, 32)


def test_frontend_stub(models):
    """The projector of precomputed patch embeddings: the reference's
    weight shape, and its product within 1e-5."""
    jcfg, jp, tcfg, tp = models
    jshape = EJ.frontend_stub_params(jax.random.PRNGKey(0), jcfg)
    assert ET.frontend_stub_shapes(tcfg) == \
        {k: tuple(v.shape) for k, v in jshape.items()}
    assert tuple(tp.frontend_proj.shape) == (32, 64)
    feats = patches(1, tcfg)
    want = EJ.frontend_stub(jp["frontend"], jnp.asarray(feats))
    got = ET.frontend_stub(tp.frontend_params, torch.from_numpy(feats))
    close(got, want, 1e-5)


@pytest.mark.parametrize("with_patches", [False, True])
def test_assemble_inputs(models, with_patches):
    """Embedded tokens (scaled by sqrt(d_model): the embedding is tied)
    with the projected patches first when the batch has them; positions
    number the whole sequence."""
    jcfg, jp, tcfg, tp = models
    toks = tokens(2, (B, S), tcfg.vocab_size)
    jb, tb = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks).long()}
    if with_patches:
        feats = patches(3, tcfg)
        jb["patches"], tb["patches"] = jnp.asarray(feats), \
            torch.from_numpy(feats)
    hj, pj = LJ.assemble_inputs(jp, jb, jcfg)
    ht, pt = LT.assemble_inputs(tp, tb, tcfg)
    n = S + (tcfg.num_image_tokens if with_patches else 0)
    assert tuple(ht.shape) == (B, n, tcfg.d_model)
    close(ht, hj, 1e-5)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    scaled = tp.embedding[tb["tokens"]] * tcfg.d_model ** 0.5
    close(ht[:, n - S:], scaled.numpy(), 1e-6)


@pytest.mark.parametrize("with_patches", [False, True])
def test_forward_with_tied_scaled_embeddings(models, with_patches):
    """The teacher-forced logits (the tied embedding as the output head,
    GeGLU) over the text, and over the image prefix and the text."""
    jcfg, jp, tcfg, tp = models
    toks = tokens(4, (B, S), tcfg.vocab_size)
    jb, tb = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks).long()}
    if with_patches:
        feats = patches(5, tcfg)
        jb["patches"], tb["patches"] = jnp.asarray(feats), \
            torch.from_numpy(feats)
    want, _ = LJ.logits_fn(jp, jb, jcfg)
    got, aux = FT.build_model(tcfg).logits(tp, tb, tcfg)
    assert float(aux) == 0.0
    close(got, want, 1e-4)


def test_seeded_init_has_the_reference_shapes(models):
    """``init_params`` builds the reference's tree: no ``lm_head`` (the
    embedding is tied), the frontend's projector at its fan-in scale."""
    jcfg, jp, tcfg, tp = models
    mine = LT.init_params(tcfg, seed=3, device="cpu")
    assert not hasattr(mine, "lm_head") and "lm_head" not in jp["embed"]
    assert set(mine.embed_params) == {"embedding"}
    assert tuple(mine.frontend_proj.shape) == jp["frontend"]["proj"].shape
    assert float(mine.frontend_proj.abs().max()) <= \
        2 * tcfg.frontend_dim ** -0.5 + 1e-7
    for name, (group, key) in mine.layer_params.items():
        assert tuple(getattr(mine, name).shape) == \
            jp["layers"][group][key].shape, name


def test_prefill_and_fullkv_steps_with_a_patch_prefix(models):
    """The prefill step over an image prefix and the text (P + S rows),
    ``lm.prefill``'s caches, and one FullKV step at positions past the
    prefix over caches of ragged length."""
    jcfg, jp, tcfg, tp = models
    P = tcfg.num_image_tokens
    toks = tokens(6, (B, S), tcfg.vocab_size)
    feats = patches(7, tcfg)
    jb = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(feats)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "patches": torch.from_numpy(feats)}
    want = SSJ.make_prefill_step(None, jcfg)(jp, jb)
    got = SST.make_prefill_step(None, tcfg)(tp, tb)
    assert tuple(got.shape) == (B, tcfg.vocab_size)
    close(got, want, 1e-3)
    lg_j, kc, vc = LJ.prefill(jp, jb, jcfg)
    lg_t, kc_t, vc_t = LT.prefill(tp, tb, tcfg)
    assert kc_t.shape[2] == P + S
    close(lg_t, lg_j, 1e-3)
    close(kc_t, kc, 1e-5)
    close(vc_t, vc, 1e-5)
    rng = np.random.default_rng(8)
    T = P + S + 8
    shape = (B, tcfg.num_layers, T, tcfg.num_kv_heads, tcfg.head_dim)
    caches = []
    for c in (kc, vc):
        full = rng.standard_normal(shape).astype(np.float32)
        full[:, :, :P + S] = np.asarray(c).transpose(1, 0, 2, 3, 4)
        caches.append(full)
    clen = np.asarray([P + S, P + S - 5, P + 11], np.int32)
    batch = {"tokens": tokens(9, (B,), tcfg.vocab_size),
             "positions": clen.copy(), "k_cache": caches[0],
             "v_cache": caches[1], "cache_len": clen}
    want = SSJ.make_decode_step_fullkv(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = SST.make_decode_step_fullkv(tcfg)(tp, batch_from_numpy(batch,
                                                                "cpu"))
    close(got[0], want[0], 1e-3)
    close(got[1], want[1], 1e-5)
    close(got[2], want[2], 1e-5)


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_thinkv_decode_step_after_a_patch_prefix(models, backend):
    """The ThinKV step per backend against JAX's (its kernel backend in
    interpret mode) at positions past a 4-token image prefix: logits
    within 1e-3, buffers within one bf16 step, ``buf_len`` exact; the
    port's kernel backend calls K1 once per layer for the batch."""
    jcfg, jp, tcfg, tp = models
    jtk, ttk = JTK(**TK), ThinKVConfig(**TK)
    dims = CJ.make_dims(jtk, jcfg.num_layers, jcfg.num_kv_heads,
                        jcfg.head_dim)
    batch = thinkv_batch(10, tcfg, dims)
    batch["positions"] = batch["positions"] + tcfg.num_image_tokens
    want = SSJ.make_decode_step_thinkv(
        jcfg, jtk, backend=backend,
        force="pallas" if backend == "kernel" else None)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    calls = ops.LAUNCHES["ct_paged_attention_fused"]
    k1 = ops.paged_decode_attention_fused
    seen = []
    ops.paged_decode_attention_fused = \
        lambda *a, **kw: seen.append(a[0].shape) or k1(*a, **kw)
    try:
        got = SST.make_decode_step_thinkv(tcfg, ttk, backend=backend)(
            tp, batch_from_numpy(batch, "cpu"))
    finally:
        ops.paged_decode_attention_fused = k1
    assert ops.LAUNCHES["ct_paged_attention_fused"] == calls
    assert seen == ([(1, B, dims.H, tcfg.num_heads, dims.D)] *
                    tcfg.num_layers if backend == "kernel" else [])
    assert float(np.abs(got[0].numpy() - np.asarray(want[0])).max()) <= 1e-3
    for g, w in zip(got[1:3], want[1:3]):
        assert bf16_steps_apart(g, w) <= 2 ** -7
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_entry_points_take_the_family_and_the_card_by_default():
    """``init_params``, the factory, the serve-step makers, the engine and
    the CLI's ``--arch`` take paligemma-3b on the CPU; with no card the
    default device is refused, never replaced by the CPU."""
    from repro_torch.launch import serve
    cfg = get_smoke_config(ARCH)
    assert FT.build_model(cfg).module is LT
    for make in (lambda: SST.make_prefill_step(None, cfg),
                 lambda: SST.make_decode_step_fullkv(cfg),
                 lambda: SST.make_decode_step_thinkv(cfg, None,
                                                     backend="kernel")):
        assert callable(make())
    eng = ThinKVEngine(ServeConfig(model=cfg, thinkv=ThinKVConfig(**TK),
                                   max_seqs=1), device="cpu")
    assert eng.mcfg is cfg and not hasattr(eng.model, "lm_head")
    assert serve.build_parser().parse_args(["--arch", ARCH]).arch == ARCH
    if not torch.cuda.is_available():
        for make in (lambda: LT.init_params(cfg),
                     lambda: ThinKVEngine(ServeConfig(model=cfg,
                                                      max_seqs=1)),
                     lambda: serve.main(["--arch", ARCH])):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
