"""The port's layers and dense forward against the JAX package's, on the
smoke r1-llama-8b config with the JAX parameters carried across
(``convert.params_from_numpy``).  f32 on both sides; only the order of
summation differs, so the bar is 1e-5 absolute."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.layers import attention as AJ  # noqa: E402
from repro.layers import embedding as EJ  # noqa: E402
from repro.layers import mlp as MJ  # noqa: E402
from repro.layers import norms as NJ  # noqa: E402
from repro.layers import rope as RJ  # noqa: E402
from repro.models import lm as LMJ  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.layers import attention as AT  # noqa: E402
from repro_torch.layers import embedding as ET  # noqa: E402
from repro_torch.layers import mlp as MT  # noqa: E402
from repro_torch.layers import norms as NT  # noqa: E402
from repro_torch.layers import rope as RT  # noqa: E402
from repro_torch.models.lm import init_params  # noqa: E402

ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params as numpy, torch cfg, converted torch LM)."""
    jcfg = jax_smoke("r1-llama-8b")
    tcfg = get_smoke_config("r1-llama-8b")
    jp = jax.tree.map(np.asarray, LMJ.init(jax.random.PRNGKey(3), jcfg))
    return jcfg, jp, tcfg, params_from_numpy(jp, tcfg, "cpu")


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol)


def test_smoke_config_is_the_reference_one(models):
    jcfg, _, tcfg, _ = models
    for f in dataclasses.fields(tcfg):
        jv, tv = getattr(jcfg, f.name), getattr(tcfg, f.name)
        assert (jv.value if hasattr(jv, "value") else jv) == \
            (tv.value if hasattr(tv, "value") else tv), f.name


def test_embed_and_unembed(models):
    jcfg, jp, tcfg, lm = models
    tok = np.random.default_rng(0).integers(0, tcfg.vocab_size, (3, 7))
    close(ET.embed(lm.embed_params, torch.from_numpy(tok), tcfg),
          EJ.embed(jp["embed"], jnp.asarray(tok), jcfg))
    h = np.random.default_rng(1).standard_normal((5, tcfg.d_model)) \
        .astype(np.float32)
    close(ET.unembed(lm.embed_params, torch.from_numpy(h), tcfg),
          EJ.unembed(jp["embed"], jnp.asarray(h), jcfg))


def test_rmsnorm(models):
    tcfg = models[2]
    x = np.random.default_rng(2).standard_normal((4, 6, tcfg.d_model)) \
        .astype(np.float32) * 3
    scale = np.linspace(0.5, 1.5, tcfg.d_model, dtype=np.float32)
    close(NT.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
                     tcfg.norm_eps),
          NJ.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                     tcfg.norm_eps))


@pytest.mark.parametrize("theta,hd", [(5e5, 16), (1e4, 128)])
def test_rope(theta, hd):
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 4000, (5, 9))
    x = rng.standard_normal((5, 9, 4, hd)).astype(np.float32)
    cj, sj = RJ.rope_freqs(jnp.asarray(pos), hd, theta)
    ct, st = RT.rope_freqs(torch.from_numpy(pos), hd, theta)
    close(ct, cj)
    close(st, sj)
    close(RT.apply_rope(torch.from_numpy(x), ct, st),
          RJ.apply_rope(jnp.asarray(x), cj, sj))


def test_qkv_projections_decode_and_out_proj(models):
    jcfg, jp, tcfg, lm = models
    rng = np.random.default_rng(4)
    pj = jax.tree.map(lambda a: jnp.asarray(a[1]), jp["layers"]["attn"])
    pt = lm.layer(1)["attn"]
    x = rng.standard_normal((6, tcfg.d_model)).astype(np.float32)
    for t, j in zip(AT._project_qkv(pt, torch.from_numpy(x), tcfg),
                    AJ._project_qkv(pj, jnp.asarray(x), jcfg)):
        close(t, j)
    pos = rng.integers(0, 3000, 6).astype(np.int32)
    outs_j = jax.vmap(lambda xx, pp: AJ.qkv_decode(pj, xx, jcfg, pp))(
        jnp.asarray(x), jnp.asarray(pos))
    outs_t = AT.qkv_decode(pt, torch.from_numpy(x), tcfg,
                           torch.from_numpy(pos))
    for t, j in zip(outs_t, outs_j):
        close(t, j)
    o = rng.standard_normal((6, tcfg.num_heads, tcfg.head_dim)) \
        .astype(np.float32)
    close(AT.out_proj(pt, torch.from_numpy(o)), AJ.out_proj(pj, jnp.asarray(o)))


def test_mlp(models):
    jcfg, jp, tcfg, lm = models
    x = np.random.default_rng(5).standard_normal((7, tcfg.d_model)) \
        .astype(np.float32)
    pj = jax.tree.map(lambda a: jnp.asarray(a[0]), jp["layers"]["mlp"])
    close(MT.mlp(lm.layer(0)["mlp"], torch.from_numpy(x), tcfg.act,
                 tcfg.mlp_gated),
          MJ.mlp(pj, jnp.asarray(x), jcfg.act, jcfg.mlp_gated))


def test_dense_forward(models):
    jcfg, jp, tcfg, lm = models
    tok = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 24))
    lj, _ = LMJ.logits_fn(jax.tree.map(jnp.asarray, jp),
                          {"tokens": jnp.asarray(tok)}, jcfg)
    close(lm(torch.from_numpy(tok)), lj)


def test_seeded_init_has_the_reference_shapes_and_scales(models):
    """The port draws its own numbers (torch.Generator), with the
    reference's shapes, dtypes and distributions."""
    _, jp, tcfg, _ = models
    lm = init_params(tcfg, seed=0, device="cpu")
    again = init_params(tcfg, seed=0, device="cpu")
    flat = {"embedding": jp["embed"]["embedding"],
            "lm_head": jp["embed"]["lm_head"],
            "final_norm": jp["final_norm"]["scale"],
            "wq": jp["layers"]["attn"]["wq"], "wo": jp["layers"]["attn"]["wo"],
            "norm1": jp["layers"]["norm1"]["scale"],
            "w_down": jp["layers"]["mlp"]["w_down"]}
    for name, a in flat.items():
        t = getattr(lm, name)
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, name
        assert torch.equal(t, getattr(again, name)), name
        np.testing.assert_allclose(float(t.std()), float(np.std(a)),
                                   rtol=0.15, err_msg=name)
        np.testing.assert_allclose(float(t.abs().max()),
                                   float(np.abs(a).max()), rtol=0.15,
                                   err_msg=name)
