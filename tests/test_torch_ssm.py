"""The port's falcon-mamba path against the JAX package's, on the CPU: the
selective scan's plain version (K5's) against the Pallas kernel in
interpret mode and against the JAX oracle, the Mamba-1 layer, the SSM LM
and the serving steps on the smoke config with the JAX parameters carried
across (``convert.params_from_numpy``).

Bars: 3e-4 against the Pallas kernel (the JAX package's own bar between
its kernel and its oracle), 1e-5 against JAX's plain functions (f32 on
both sides, another summation order), 5e-3 between the port's decode and
its own teacher-forced forward (the JAX package's bar between the two)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ref as RJ  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro.layers import ssm as SJ  # noqa: E402
from repro.models import factory as FJ  # noqa: E402
from repro.models import ssm_lm as MJ  # noqa: E402
from repro.serving import serve_step as SSJ  # noqa: E402
from repro_torch.config import ServeConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as RT  # noqa: E402
from repro_torch.layers import ssm as ST  # noqa: E402
from repro_torch.models import factory as FT  # noqa: E402
from repro_torch.models import ssm_lm as MT  # noqa: E402
from repro_torch.serving import serve_step as SST  # noqa: E402
from repro_torch.serving.engine import ThinKVEngine  # noqa: E402

ATOL = 1e-5
ARCH = "falcon-mamba-7b"


def close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def scan_inputs(seed, s, di, n, lead=()):
    """The JAX package's kernel-test inputs (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(lead + (s, di)).astype(np.float32),
            (0.01 + 0.1 * rng.random(lead + (s, di))).astype(np.float32),
            rng.standard_normal(lead + (s, n)).astype(np.float32),
            rng.standard_normal(lead + (s, n)).astype(np.float32),
            (-np.exp(rng.standard_normal((di, n)))).astype(np.float32))


@pytest.mark.parametrize("s,di,n", [(64, 128, 16), (128, 256, 16),
                                    (96, 64, 8)])
def test_mamba_scan_plain_matches_pallas_and_oracle(s, di, n):
    args = scan_inputs(s + di + n, s, di, n)
    y_k = mamba_scan(*map(jnp.asarray, args), d_block=64, chunk=32,
                     interpret=True)
    y_r = RJ.mamba_scan_ref(*map(jnp.asarray, args))
    launches = dict(ops.LAUNCHES)
    y_t = ops.mamba_scan(*map(torch.from_numpy, args))
    assert ops.LAUNCHES == launches          # CPU tensors: the plain version
    close(y_t, y_k, atol=3e-4, rtol=3e-4)
    close(y_t, y_r)
    close(RT.mamba_scan_ref(*map(torch.from_numpy, args)), y_r)


def test_mamba_scan_batch_axis_is_per_row_scans():
    """A leading batch axis (one launch per prefill layer on the card) is
    the unbatched scan of every row."""
    x, dt, b, c, a = map(torch.from_numpy, scan_inputs(5, 40, 24, 16, (3,)))
    y = ops.mamba_scan(x, dt, b, c, a)
    assert y.shape == x.shape
    for r in range(3):
        close(y[r], ops.mamba_scan(x[r], dt[r], b[r], c[r], a).numpy())


def test_mamba_scan_refuses_what_the_kernel_does_not_take():
    x, dt, b, c, a = map(torch.from_numpy, scan_inputs(6, 8, 16, 16))
    with pytest.raises(TypeError):
        ops.mamba_scan(x.double(), dt, b, c, a)
    with pytest.raises(ValueError, match="shape"):
        ops.mamba_scan(x, dt, b[:, :8].contiguous(), c, a)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mamba_scan(x, dt.t().contiguous().t(), b, c, a)
    big = torch.zeros((8, 32))
    with pytest.raises(ValueError, match="state size"):
        ops.mamba_scan(x, dt, big, big, torch.zeros((16, 32)))


def test_configs_are_the_reference_ones():
    from repro.configs import get_config as jax_config
    for jcfg, tcfg in ((jax_config(ARCH), get_config(ARCH)),
                       (jax_smoke(ARCH), get_smoke_config(ARCH))):
        for f in dataclasses.fields(tcfg):
            jv, tv = getattr(jcfg, f.name), getattr(tcfg, f.name)
            if f.name == "ssm":
                jv, tv = dataclasses.asdict(jv), dataclasses.asdict(tv)
            assert (jv.value if hasattr(jv, "value") else jv) == \
                (tv.value if hasattr(tv, "value") else tv), f.name
    assert ST.mamba1_dims(get_config(ARCH)) == (8192, 256, 16, 4)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params as numpy, torch cfg, converted torch SSMLM)."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = jax.tree.map(np.asarray, MJ.init(jax.random.PRNGKey(1), jcfg))
    return jcfg, jp, tcfg, params_from_numpy(jp, tcfg, "cpu")


def test_mamba1_forward_and_decode_step(models):
    jcfg, jp, tcfg, m = models
    rng = np.random.default_rng(7)
    pj = jax.tree.map(lambda a: jnp.asarray(a[1]), jp["layers"]["mixer"])
    pt = m.layer(1)["mixer"]
    x = rng.standard_normal((2, 10, tcfg.d_model)).astype(np.float32)
    close(ST.mamba1_forward(pt, torch.from_numpy(x), tcfg),
          SJ.mamba1_forward(pj, jnp.asarray(x), jcfg))
    close(ST.causal_conv1d(torch.from_numpy(x), pt["conv_w"][:64],
                           pt["conv_b"][:64]),
          SJ.causal_conv1d(jnp.asarray(x), pj["conv_w"][:64],
                           pj["conv_b"][:64]))
    st_j = SJ.mamba1_init_state(jcfg)
    st_t = ST.mamba1_init_state(tcfg, (1,), torch.device("cpu"))
    for t in range(6):
        y_j, st_j = SJ.mamba1_decode_step(pj, jnp.asarray(x[0, t]), st_j,
                                          jcfg)
        y_t, st_t = ST.mamba1_decode_step(pt, torch.from_numpy(x[:1, t]),
                                          st_t, tcfg)
        close(y_t[0], y_j)
        close(st_t.conv[0], st_j.conv)
        close(st_t.h[0], st_j.h)


def test_seeded_init_has_the_reference_shapes_and_constants(models):
    _, jp, tcfg, _ = models
    m = MT.init_params(tcfg, seed=0, device="cpu")
    again = MT.init_params(tcfg, seed=0, device="cpu")
    flat = {"embedding": jp["embed"]["embedding"],
            "final_norm": jp["final_norm"]["scale"],
            "norm": jp["layers"]["norm"]["scale"],
            **{k: jp["layers"]["mixer"][k] for k in ST.MAMBA1_PARAMS}}
    assert set(flat) == {n for n, _ in m.named_parameters()}
    for name, a in flat.items():
        t = getattr(m, name)
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, name
        assert torch.equal(t, getattr(again, name)), name
        if name == "A_log":   # XLA's f32 log(7) is one ulp off; torch's is
            # correctly rounded
            np.testing.assert_array_max_ulp(t.numpy(), a, maxulp=1)
        elif name in ("conv_b", "dt_bias", "D", "norm", "final_norm"):
            np.testing.assert_array_equal(t.numpy(), a, err_msg=name)
        else:
            np.testing.assert_allclose(float(t.std()), float(np.std(a)),
                                       rtol=0.2, err_msg=name)


def test_ssm_lm_logits_and_decode_sequence(models):
    jcfg, jp, tcfg, m = models
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (3, 12))
    lj, _ = MJ.logits_fn(jax.tree.map(jnp.asarray, jp),
                         {"tokens": jnp.asarray(toks)}, jcfg)
    lt, aux = MT.logits_fn(m, {"tokens": torch.from_numpy(toks)}, tcfg)
    close(lt, lj)
    assert float(aux) == 0.0
    st_j = MJ.init_decode_state(jcfg)
    st_t = MT.init_decode_state(tcfg, 3, "cpu")
    step_j = jax.jit(MJ.decode_step, static_argnums=3)
    for i in range(12):
        lg_t, st_t = MT.decode_step(m, torch.from_numpy(toks[:, i]), st_t,
                                    tcfg)
        lg_j, st_j = step_j(jax.tree.map(jnp.asarray, jp),
                            jnp.asarray(toks[0, i]), st_j, jcfg)
        close(lg_t[0], lg_j)
        close(st_t.h[0], st_j.h)
        close(st_t.conv[0], st_j.conv)
        # the port's own decode against its teacher-forced forward
        close(lg_t, lt[:, i], atol=5e-3, rtol=5e-3)


def test_serve_steps_batch_of_three(models):
    """``make_prefill_step`` on the prompts, then greedy tokens through
    ``make_decode_step_fullkv`` (and the ThinKV step, which is the same for
    this family), against the reference's vmapped steps."""
    jcfg, jp, tcfg, m = models
    jparams = jax.tree.map(jnp.asarray, jp)
    prompts = np.random.default_rng(9).integers(0, tcfg.vocab_size, (3, 9))
    pre_j = SSJ.make_prefill_step(FJ.build_model(jcfg), jcfg)
    pre_t = SST.make_prefill_step(FT.build_model(tcfg), tcfg)
    lg_j = pre_j(jparams, {"tokens": jnp.asarray(prompts)})
    lg_t = pre_t(m, {"tokens": torch.from_numpy(prompts)})
    assert lg_t.shape == (3, tcfg.vocab_size)
    close(lg_t, lg_j)
    dec_j = jax.jit(SSJ.make_decode_step_fullkv(jcfg))
    dec_t = SST.make_decode_step_thinkv(tcfg, None)
    st_j = MJ.init_decode_state(jcfg)
    conv_j = jnp.broadcast_to(st_j.conv, (3,) + st_j.conv.shape)
    h_j = jnp.broadcast_to(st_j.h, (3,) + st_j.h.shape)
    st_t = MT.init_decode_state(tcfg, 3, "cpu")
    conv_t, h_t = st_t.conv, st_t.h
    assert tuple(conv_t.shape) == conv_j.shape
    assert tuple(h_t.shape) == h_j.shape
    tok_j = tok_t = None
    for i in range(prompts.shape[1] + 6):     # the prompt, then 6 greedy
        if i < prompts.shape[1]:
            tok_j, tok_t = jnp.asarray(prompts[:, i]), \
                torch.from_numpy(prompts[:, i])
        lg_j, conv_j, h_j = dec_j(jparams, {"tokens": tok_j,
                                            "conv_state": conv_j,
                                            "ssm_state": h_j})
        lg_t, conv_t, h_t = dec_t(m, {"tokens": tok_t, "conv_state": conv_t,
                                      "ssm_state": h_t})
        close(lg_t, lg_j)
        close(conv_t, conv_j)
        close(h_t, h_j)
        if i == prompts.shape[1] - 1:
            close(lg_t, lg_j)
            close(lg_t, pre_t(m, {"tokens": torch.from_numpy(prompts)}),
                  atol=5e-3, rtol=5e-3)
        tok_j, tok_t = jnp.argmax(lg_j, -1), lg_t.argmax(-1)
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))


def test_backends_agree_on_the_cpu(models):
    """The reference backend (``mamba_scan_ref`` on any device) is what the
    card's kernel backend is held against."""
    _, _, tcfg, m = models
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, tcfg.vocab_size, (2, 7)))
    lk, _ = MT.logits_fn(m, {"tokens": toks}, tcfg, backend="kernel")
    lr, _ = MT.logits_fn(m, {"tokens": toks}, tcfg, backend="reference")
    close(lk, lr.numpy(), atol=0)
    with pytest.raises(ValueError, match="backend"):
        MT.logits_fn(m, {"tokens": toks}, tcfg, backend="pallas")


def test_other_families_name_their_roadmap_item():
    """The dense serve-step makers build since item 12 was ported, the
    MoE and VLM families' since their parts of item 15 were, the
    encoder-decoder and hybrid families' since items 15c and 15b were: the
    factory maps each family to its module; only training (item 16) still
    raises, naming its item."""
    cfg = get_smoke_config("r1-llama-8b")
    for c in (cfg, get_smoke_config("mixtral-8x7b"),
              get_smoke_config("paligemma-3b")):
        assert FT.build_model(c).module.__name__.endswith(".lm")
        for make in (lambda: SST.make_prefill_step(None, c),
                     lambda: SST.make_decode_step_fullkv(c),
                     lambda: SST.make_decode_step_thinkv(c, None),
                     lambda: SST.make_decode_step_thinkv(c, None,
                                                         backend="kernel")):
            assert callable(make())
    for fam, arch in (("encdec", "whisper-medium"), ("hybrid", "zamba2-7b")):
        other = get_smoke_config(arch)
        assert other.family.value == fam
        assert FT.build_model(other).module.__name__.endswith(f".{fam}")
        for make in (lambda: SST.make_prefill_step(None, other),
                     lambda: SST.make_decode_step_fullkv(other),
                     lambda: SST.make_decode_step_thinkv(other, None),
                     lambda: SST.make_decode_step_thinkv(other, None,
                                                         backend="kernel")):
            assert callable(make())
    with pytest.raises(NotImplementedError, match="item 16"):
        FT.build_model(cfg).loss(None, None, cfg)


def test_engine_refuses_the_attention_free_family():
    cfg = ServeConfig(model=get_smoke_config(ARCH), max_seqs=1)
    with pytest.raises(ValueError, match="serve_step"):
        ThinKVEngine(cfg, device="cpu")


@pytest.mark.parametrize("s,di,n", [(40, 96, 5), (33, 64, 16), (24, 128, 8)])
def test_mamba_scan_lanes_decomposition_matches_pallas(s, di, n):
    """K5's arithmetic order (a channel's state lanes padded to 16 and
    split over 2 threads, partial sums joined by a butterfly) against the
    Pallas kernel in interpret mode (3e-4, the JAX package's bar) and its
    oracle (1e-5), at ragged S, d_inner and N."""
    args = scan_inputs(s * di + n, s, di, n)
    y_k = mamba_scan(*map(jnp.asarray, args), d_block=64, chunk=32,
                     interpret=True)
    y_t = RT.mamba_scan_lanes_ref(*map(torch.from_numpy, args))
    close(y_t, y_k, atol=3e-4, rtol=3e-4)
    close(y_t, RJ.mamba_scan_ref(*map(jnp.asarray, args)))
