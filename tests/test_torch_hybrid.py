"""The port's Mamba-2 mixer, hybrid model (zamba2) and hybrid serve steps
against the JAX package's, on the CPU, with the JAX parameters carried
across by ``convert.py``.

* ``mamba2_forward`` at ragged S (the chunk shrinks until it divides S) and
  ``mamba2_decode_step`` over S steps: within 1e-5 of the reference;
* the smoke form with a tail (``reduced(zamba2, num_layers=5,
  hybrid_attn_every=2)``: 2 groups of 2 Mamba-2 layers, each followed by
  the shared block, then 1 tail layer): ``logits_fn`` and ``hidden_fn``
  within 1e-4, ``decode_step_fullkv`` token by token within 1e-4 of the
  reference and of the port's own forward;
* the three serve steps on both backends (the batch keys of
  ``repro.models.factory.input_specs``): prefill logits within 1e-4;
  FullKV logits, caches and states within 1e-4; the ThinKV step on a
  seeded pool (bits 2/4/8 mixed, slots evicted and free) against the JAX
  step on the same backend (its kernel backend through the Pallas kernel
  in interpret mode): logits and states within 1e-3, buffers within one
  bf16 step (a later invocation's rows: or 1e-3), ``buf_len`` exact; also at head_dim 112 (4 q / 4 kv
  heads, GQ 1 as in the full config), where the port's plain K1 at D 112
  is held to JAX's Pallas K1 at D 112.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import InputShape  # noqa: E402
from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import ct_cache as CJ  # noqa: E402
from repro.layers import ssm as SJ  # noqa: E402
from repro.models import factory as FJ  # noqa: E402
from repro.models import hybrid as HJ  # noqa: E402
from repro.serving import serve_step as SSJ  # noqa: E402
from repro_torch.config import ThinKVConfig, reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import batch_from_numpy  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.layers import ssm as ST  # noqa: E402
from repro_torch.models import factory as FT  # noqa: E402
from repro_torch.models import hybrid as HT  # noqa: E402
from repro_torch.serving import serve_step as SST  # noqa: E402
from test_torch_serve_step import (TK, bf16_steps_apart,  # noqa: E402
                                   thinkv_batch)

ARCH = "zamba2-7b"
TAIL = dict(num_layers=5, hybrid_attn_every=2)
D112 = dict(TAIL, num_heads=4, num_kv_heads=4, head_dim=112)
B, S = 3, 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    several pytest workers on one host the threads' wake-ups dominate:
    run this module's torch ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(**over):
    """(JAX config, JAX params, port config, port params) of a smoke form
    of zamba2-7b, the JAX package's seeded weights carried across."""
    jcfg = jax_reduced(jax_config(ARCH), **over)
    tcfg = reduced(get_config(ARCH), **over)
    jp = FJ.build_model(jcfg).init_params(0)
    return jcfg, jp, tcfg, params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def tail():
    return build(**TAIL)


@pytest.fixture(scope="module")
def wide():
    return build(**D112)


def close(t, j, atol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=0, atol=atol)


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def mixer(jp, tp, i):
    """Layer ``i``'s Mamba-2 parameters in each package's layout."""
    return jax.tree.map(lambda x: x[i], jp["layers"]["mixer"]), tp.mixer(i)


@pytest.mark.parametrize("s", [21, 40, 16])
def test_mamba2_forward_matches_reference(tail, s):
    """At S 21 and 40 the chunk (16 in the smoke form) shrinks to 7 and
    10; at 16 it is one whole chunk."""
    jcfg, jp, tcfg, tp = tail
    jm, tm = mixer(jp, tp, 1)
    x = np.random.default_rng(s).standard_normal(
        (2, s, tcfg.d_model)).astype(np.float32)
    want = SJ.mamba2_forward(jm, jnp.asarray(x), jcfg)
    got = ST.mamba2_forward(tm, torch.from_numpy(x), tcfg)
    close(got, want, 1e-5)


def test_mamba2_decode_steps_match_reference(tail):
    """S decode steps from zero state against the reference's per-request
    step (vmapped), and the last outputs against the chunked forward."""
    jcfg, jp, tcfg, tp = tail
    jm, tm = mixer(jp, tp, 0)
    x = np.random.default_rng(3).standard_normal(
        (2, 21, tcfg.d_model)).astype(np.float32)
    jst = jax.vmap(lambda _: SJ.mamba2_init_state(jcfg))(jnp.arange(2))
    tst = ST.mamba2_init_state(tcfg, (2,))
    assert tuple(tst.conv.shape) == tuple(jst.conv.shape)
    assert tuple(tst.h.shape) == tuple(jst.h.shape)
    step = jax.vmap(lambda xt, st: SJ.mamba2_decode_step(jm, xt, st, jcfg))
    ys = []
    for t in range(x.shape[1]):
        yj, jst = step(jnp.asarray(x[:, t]), jst)
        yt, tst = ST.mamba2_decode_step(tm, torch.from_numpy(x[:, t]), tst,
                                        tcfg)
        close(yt, yj, 1e-5)
        ys.append(yt)
    close(tst.conv, jst.conv, 1e-5)
    close(tst.h, jst.h, 1e-5)
    fwd = ST.mamba2_forward(tm, torch.from_numpy(x), tcfg)
    close(torch.stack(ys, 1), fwd.numpy(), 1e-4)


def test_forward_with_a_tail_matches_reference(tail):
    jcfg, jp, tcfg, tp = tail
    assert HT._groups(tcfg) == HJ._groups(jcfg) == (2, 1)
    assert tcfg.num_attention_layers() == jcfg.num_attention_layers() == 2
    toks = tokens(0, (2, S), tcfg.vocab_size)
    batch_j, batch_t = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks).long()}
    want, _ = HJ.logits_fn(jp, batch_j, jcfg)
    got, aux = HT.logits_fn(tp, batch_t, tcfg)
    assert float(aux) == 0.0
    close(got, want, 1e-4)
    close(HT.hidden_fn(tp, batch_t, tcfg), HJ.hidden_fn(jp, batch_j, jcfg),
          1e-4)


def test_fullkv_decode_token_by_token(tail):
    """The port's batched ``decode_step_fullkv`` against the reference's
    per-request one (vmapped) at every position, and against the port's
    own forward."""
    jcfg, jp, tcfg, tp = tail
    toks = tokens(1, (2, S), tcfg.vocab_size)
    n_attn = tcfg.num_attention_layers()
    shape = (2, n_attn, S, tcfg.num_kv_heads, tcfg.head_dim)
    kc_t, vc_t = torch.zeros(shape), torch.zeros(shape)
    kc_j, vc_j = jnp.zeros(shape), jnp.zeros(shape)
    st_t = HT.init_decode_state(tcfg, 2, "cpu")
    st_j = jax.vmap(lambda _: HJ.init_decode_state(jcfg))(jnp.arange(2))
    one = jax.vmap(lambda t, p, st, kc, vc, n: HJ.decode_step_fullkv(
        jp, t, p, st, kc, vc, n, jcfg))
    fwd, _ = HT.logits_fn(tp, {"tokens": torch.from_numpy(toks).long()},
                          tcfg)
    for i in range(S):
        pos = np.full(2, i, np.int32)
        lg_j, st_j, kc_j, vc_j = one(jnp.asarray(toks[:, i]),
                                     jnp.asarray(pos), st_j, kc_j, vc_j,
                                     jnp.asarray(pos))
        p = torch.from_numpy(pos)
        lg_t, st_t, kc_t, vc_t = HT.decode_step_fullkv(
            tp, torch.from_numpy(toks[:, i]), p, st_t, kc_t, vc_t, p, tcfg)
        close(lg_t, lg_j, 1e-4)
        close(lg_t, fwd[:, i].numpy(), 1e-4)
    close(kc_t, kc_j, 1e-4)
    close(st_t.h, st_j.h, 1e-4)


def bf16_steps_or(got, want, floor):
    """max |got - want| / max(floor, one bf16 step at max(|got|, |want|))."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    big = np.maximum(np.maximum(np.abs(g), np.abs(w)), 1e-30)
    step = np.exp2(np.floor(np.log2(big)) - 7)
    return float((np.abs(g - w) / np.maximum(step, floor)).max())


def states(seed, cfg, b=B):
    """Random Mamba-2 decode states [B, L, ...] from a numpy seed."""
    rng = np.random.default_rng(seed)
    st = ST.mamba2_init_state(cfg, (b, cfg.num_layers))
    return {"conv_state": rng.standard_normal(tuple(st.conv.shape))
            .astype(np.float32),
            "ssm_state": 0.3 * rng.standard_normal(tuple(st.h.shape))
            .astype(np.float32)}


def test_prefill_and_fullkv_serve_steps(tail):
    jcfg, jp, tcfg, tp = tail
    toks = tokens(2, (B, S), tcfg.vocab_size)
    want = SSJ.make_prefill_step(None, jcfg)(jp, {"tokens":
                                                  jnp.asarray(toks)})
    got = SST.make_prefill_step(FT.build_model(tcfg), tcfg)(
        tp, {"tokens": torch.from_numpy(toks).long()})
    assert tuple(got.shape) == (B, tcfg.vocab_size)
    close(got, want, 1e-4)
    rng = np.random.default_rng(4)
    T = S + 4
    n_attn = tcfg.num_attention_layers()
    shape = (B, n_attn, T, tcfg.num_kv_heads, tcfg.head_dim)
    clen = np.asarray([S, 5, 0], np.int32)
    batch = {"tokens": tokens(5, (B,), tcfg.vocab_size),
             "positions": clen.copy(),
             "k_cache": rng.standard_normal(shape).astype(np.float32),
             "v_cache": rng.standard_normal(shape).astype(np.float32),
             "cache_len": clen, **states(6, tcfg)}
    want = SSJ.make_decode_step_fullkv(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = SST.make_decode_step_fullkv(tcfg)(tp, batch_from_numpy(batch,
                                                                "cpu"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        close(g, w, 1e-4)


@pytest.mark.parametrize("form", ["tail", "wide"])
@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_thinkv_serve_step(request, form, backend, monkeypatch):
    """The ThinKV step over the shared block's pools (n_attn layers), the
    port's backend against the same JAX backend; the kernel backend calls
    K1's wrapper once per invocation for the whole batch (plain on the
    CPU)."""
    jcfg, jp, tcfg, tp = request.getfixturevalue(form)
    jtk, ttk = JTK(**TK), ThinKVConfig(**TK)
    n_attn = tcfg.num_attention_layers()
    dims = CJ.make_dims(jtk, n_attn, jcfg.num_kv_heads, jcfg.head_dim)
    batch = {**thinkv_batch(7, tcfg, dims), **states(8, tcfg)}
    assert batch["k_codes"].shape[1] == n_attn == 2
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
                          dims.D)] * n_attn
    else:
        assert not calls
    assert len(got) == len(want) == 6
    err = float(np.abs(got[0].numpy() - np.asarray(want[0])).max())
    print(f"{form} {backend}: logits {err:.3g} from JAX's")
    assert err <= 1e-3
    # the layers after the first shared block read its attention output
    close(got[1], want[1], 1e-3)
    close(got[2], want[2], 1e-3)
    for g, w in zip(got[3:5], want[3:5]):
        assert g.dtype == torch.bfloat16
        # the first invocation's new rows within one bf16 step; a later
        # one's read the earlier attention outputs (within 1e-3), so each
        # element within one bf16 step or 1e-3
        assert bf16_steps_apart(g[:, 0], w[:, 0]) <= 2 ** -7
        assert bf16_steps_or(g, w, 1e-3) <= 1
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    np.testing.assert_array_equal(got[5].numpy(), batch["buf_len"] + 1)


def test_full_config_shapes():
    """zamba2-7b's full form: 13 invocations of the shared block over 81
    layers (13 groups of 6, a tail of 3), 112 Mamba-2 heads of 64, the
    step's state shapes as the reference's ``input_specs``."""
    cfg = get_config(ARCH)
    assert HT._groups(cfg) == (13, 3)
    assert cfg.num_attention_layers() == 13
    di, nh, hp, g, n, cw = ST.mamba2_dims(cfg)
    assert (di, nh, hp, g, n, cw) == SJ.mamba2_dims(jax_config(ARCH))
    specs = FJ.input_specs(jax_config(ARCH),
                           InputShape("decode", 4096, 2, "decode"),
                           thinkv_budget=1024)
    st = ST.mamba2_init_state(cfg, (2, cfg.num_layers), device="meta")
    assert tuple(st.conv.shape) == specs["conv_state"].shape
    assert tuple(st.h.shape) == specs["ssm_state"].shape
    assert specs["k_codes"].shape[1] == 13
