"""The dense configs with qkv bias or another head grouping (qwen2-7b, yi-6b,
yi-9b, mistral-large-123b) and the MoE family (mixtral-8x7b,
llama4-scout-17b-a16e) in the port, against the JAX package on the CPU.

* every registered config equals the JAX config field for field, at full
  size and at smoke size (the JAX fields the port does not keep stand at
  their defaults);
* the teacher-forced forward of each new smoke config (2 layers, d_model
  64, 4 q / 2 kv heads at head_dim 16) against ``logits_fn``: logits
  within 1e-4, the MoE auxiliary loss within 1e-6;
* qwen2-7b smoke (with non-zero biases written into the JAX tree from a
  numpy seed: the reference initialises them to zero, which would hold
  nothing) and the two MoE smoke configs through the prefill step, the
  FullKV step (mixtral's window cut to 8 rows so that it masks) and the
  ThinKV step on both backends (JAX's kernel backend in interpret mode):
  logits within 1e-3;
* the engine at 8 slots on mixtral smoke, where a tick's 16 choices meet
  a capacity of 5 per expert: the port drops choices at decode and still
  gives the live JAX engine's tokens, counters, audit and logits (1e-3).

The flash and pressure traces on these configs are in
``test_torch_archs_engine.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ServeConfig as JSC  # noqa: E402
from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import ct_cache as CJ  # noqa: E402
from repro.models import factory as FJ  # noqa: E402
from repro.models import lm as LJ  # noqa: E402
from repro.serving import serve_step as SSJ  # noqa: E402
from repro.serving.engine import ThinKVEngine as JaxEngine  # noqa: E402
from repro_torch.config import ServeConfig, ThinKVConfig  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import batch_from_numpy  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.layers import moe as MT  # noqa: E402
from repro_torch.models import factory as FT  # noqa: E402
from repro_torch.models import lm as LT  # noqa: E402
from repro_torch.serving import serve_step as SST  # noqa: E402
from repro_torch.serving.engine import ThinKVEngine  # noqa: E402
from test_torch_serve_step import (bf16_steps_apart, thinkv_batch,  # noqa
                                   tokens)

NEW_ARCHS = ("qwen2-7b", "yi-6b", "yi-9b", "mistral-large-123b",
             "mixtral-8x7b", "llama4-scout-17b-a16e")
# the configs the engine, the serve steps and the traces are held on
SERVED = ("qwen2-7b", "mixtral-8x7b", "llama4-scout-17b-a16e")
TK = dict(refresh_interval=8, group_size=8, block_size=8, token_budget=32,
          retention_schedule=(16, 8, 4), min_retention=4, max_segments=64,
          kmeans_iters=2)
BIAS_SCALE = 0.3
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


def jax_params(jcfg, seed: int = 0) -> dict:
    """The JAX package's seeded parameters as numpy; under qkv bias the
    zero-initialised biases are replaced by ``BIAS_SCALE`` N(0, 1) draws
    from ``np.random.default_rng(seed + 100)``."""
    tree = jax.tree.map(np.asarray, FJ.build_model(jcfg).init_params(seed))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        attn = tree["layers"]["attn"]
        for b in ("bq", "bk", "bv"):
            attn[b] = (BIAS_SCALE * rng.standard_normal(attn[b].shape)) \
                .astype(np.float32)
    return tree


def close(t, j, atol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=0, atol=atol)


def plain(v):
    if dataclasses.is_dataclass(v):
        return {k: plain(x) for k, x in dataclasses.asdict(v).items()}
    return v.value if hasattr(v, "value") else v


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_ones(arch):
    """Field for field, full and smoke (zamba2-7b's and whisper-medium's
    hybrid and encoder-decoder fields among them); every JAX field the
    port leaves out (dtype) at its default."""
    import repro.config as RC
    defaults = {f.name: f.default for f in dataclasses.fields(RC.ModelConfig)}
    for jcfg, tcfg in ((jax_config(arch), get_config(arch)),
                       (jax_smoke(arch), get_smoke_config(arch))):
        kept = {f.name for f in dataclasses.fields(tcfg)}
        for name in kept:
            assert plain(getattr(jcfg, name)) == plain(getattr(tcfg, name)), \
                (arch, name)
        for name in set(defaults) - kept:
            assert getattr(jcfg, name) == defaults[name], (arch, name)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def models(request):
    """(arch, jax cfg, jax params as numpy, port cfg, port LM)."""
    arch = request.param
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = jax_params(jcfg)
    return arch, jcfg, jp, tcfg, params_from_numpy(jp, tcfg, "cpu")


def test_forward_matches_logits_fn(models):
    """The teacher-forced forward and the factory's model, with qkv bias
    (qwen2: non-zero) and routed MoE layers (the B·S tokens together)."""
    arch, jcfg, jp, tcfg, tp = models
    toks = tokens(11, (B, S), tcfg.vocab_size)
    want, aux_j = LJ.logits_fn(jax.tree.map(jnp.asarray, jp),
                               {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux_t = FT.build_model(tcfg).logits(
        tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    close(got, want, 1e-4)
    assert abs(float(aux_t) - float(aux_j)) <= 1e-6
    assert (float(aux_t) > 0) == (tcfg.moe is not None)
    if tcfg.qkv_bias:
        assert float(tp.bq.abs().max()) > 0.5


def test_seeded_init_has_the_reference_shapes(models):
    """``init_params`` builds the reference's tree: the same parameter
    names and shapes, zero biases, a f32 router at the reference's
    scale."""
    arch, jcfg, jp, tcfg, tp = models
    mine = LT.init_params(tcfg, seed=3, device="cpu")
    for name, (group, key) in mine.layer_params.items():
        assert tuple(getattr(mine, name).shape) == \
            jp["layers"][group][key].shape, name
    if tcfg.qkv_bias:
        assert all(float(getattr(mine, b).abs().max()) == 0
                   for b in ("bq", "bk", "bv"))
    if tcfg.moe is not None:
        assert mine.router.dtype == torch.float32
        assert float(mine.router.abs().max()) <= 0.04 + 1e-7
        assert 0.01 < float(mine.router.std()) < 0.02


@pytest.fixture(scope="module", params=SERVED)
def served(request):
    arch = request.param
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = jax_params(jcfg)
    return arch, jcfg, jax.tree.map(jnp.asarray, jp), tcfg, \
        params_from_numpy(jp, tcfg, "cpu")


def test_prefill_and_fullkv_steps(served):
    """The prefill step, ``lm.prefill`` and one FullKV decode step over
    ragged caches.  Mixtral's 4096-row window does not mask at these
    lengths, so both packages' configs take a window of 8 rows here."""
    arch, jcfg, jp, tcfg, tp = served
    if tcfg.sliding_window:
        jcfg = dataclasses.replace(jcfg, sliding_window=8)
        tcfg = dataclasses.replace(tcfg, sliding_window=8)
    toks = tokens(12, (B, S), tcfg.vocab_size)
    want = SSJ.make_prefill_step(None, jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got = SST.make_prefill_step(None, tcfg)(
        tp, {"tokens": torch.from_numpy(toks).long()})
    close(got, want, 1e-3)
    lg_j, kc, vc = LJ.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    lg_t, kc_t, vc_t = LT.prefill(tp, {"tokens": torch.from_numpy(toks)
                                       .long()}, tcfg)
    close(lg_t, lg_j, 1e-3)
    close(kc_t, kc, 1e-5)
    close(vc_t, vc, 1e-5)
    rng = np.random.default_rng(13)
    T = S + 8
    shape = (B, tcfg.num_layers, T, tcfg.num_kv_heads, tcfg.head_dim)
    caches = []
    for c in (kc, vc):
        full = rng.standard_normal(shape).astype(np.float32)
        full[:, :, :S] = np.asarray(c).transpose(1, 0, 2, 3, 4)
        caches.append(full)
    clen = np.asarray([S, S - 5, 11], np.int32)
    batch = {"tokens": tokens(14, (B,), tcfg.vocab_size),
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
def test_thinkv_decode_step(served, backend, monkeypatch):
    """The ThinKV step per backend against JAX's (its kernel backend in
    interpret mode): logits within 1e-3, buffers within one bf16 step;
    the port's kernel backend calls K1 once per layer for the batch,
    and a MoE layer routes each request's token alone."""
    arch, jcfg, jp, tcfg, tp = served
    jtk, ttk = JTK(**TK), ThinKVConfig(**TK)
    dims = CJ.make_dims(jtk, jcfg.num_layers, jcfg.num_kv_heads,
                        jcfg.head_dim)
    batch = thinkv_batch(15, tcfg, dims)
    want = SSJ.make_decode_step_thinkv(
        jcfg, jtk, backend=backend,
        force="pallas" if backend == "kernel" else None)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    calls, groups = [], []
    k1, route = ops.paged_decode_attention_fused, MT.moe_route
    monkeypatch.setattr(ops, "paged_decode_attention_fused",
                        lambda *a, **kw: calls.append(a[0].shape)
                        or k1(*a, **kw))
    monkeypatch.setattr(MT, "moe_route", lambda r, xt, c:
                        groups.append(tuple(xt.shape[:2])) or
                        route(r, xt, c))
    got = SST.make_decode_step_thinkv(tcfg, ttk, backend=backend)(
        tp, batch_from_numpy(batch, "cpu"))
    gq = tcfg.num_heads // dims.H
    assert calls == ([(1, B, dims.H, gq, dims.D)] * tcfg.num_layers
                     if backend == "kernel" else [])
    assert groups == ([(B, 1)] * tcfg.num_layers if tcfg.moe else [])
    err = float(np.abs(got[0].numpy() - np.asarray(want[0])).max())
    assert err <= 1e-3
    for g, w in zip(got[1:3], want[1:3]):
        assert bf16_steps_apart(g, w) <= 2 ** -7
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


EIGHT_SLOTS, EIGHT_LENS, EIGHT_NEW = 8, (20, 9, 14, 31, 12, 17, 8, 25), 12


def test_eight_slot_moe_engine_drops_choices_at_decode(monkeypatch):
    """Mixtral smoke on 8 slots: a tick routes the 8 slots as one group
    (16 choices, capacity 5 per expert), so decode drops choices; the
    port's engine on both backends gives the live JAX engine's tokens,
    counters and audit, logits within 1e-3."""
    arch = "mixtral-8x7b"
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    assert MT.capacity(tcfg, EIGHT_SLOTS) == 5
    jp = jax_params(jcfg, seed=2)
    rng = np.random.default_rng(8)
    ps = [rng.integers(0, 256, n).astype(np.int64) for n in EIGHT_LENS]
    je = JaxEngine(JSC(model=jcfg, thinkv=JTK(**TK), max_seqs=EIGHT_SLOTS),
                   params=jax.tree.map(jnp.asarray, jp),
                   backend="reference", record_logits=True)
    je.submit(ps, max_new_tokens=EIGHT_NEW)
    jdone = {r.arrival: r.output for r in je.run()}
    counters = ("ticks", "tokens", "prefill_chunks", "prefill_tokens",
                "admissions", "queue_wait_ticks")
    for backend in ("reference", "kernel"):
        eng = ThinKVEngine(
            ServeConfig(model=tcfg, thinkv=ThinKVConfig(**TK),
                        max_seqs=EIGHT_SLOTS),
            params=params_from_numpy(jp, tcfg, "cpu"), backend=backend,
            record_logits=True, device="cpu")
        dropped, in_tick = [], [False]
        tick, route = eng._tick, MT.moe_route

        def ticked(*a, **kw):
            in_tick[0] = True
            try:
                return tick(*a, **kw)
            finally:
                in_tick[0] = False

        def counted(r, xt, c):
            rt = route(r, xt, c)
            if in_tick[0]:
                assert tuple(xt.shape[:2]) == (1, EIGHT_SLOTS)
                dropped.append(int((~rt.keep).sum()))
            return rt
        monkeypatch.setattr(eng, "_tick", ticked)
        monkeypatch.setattr(MT, "moe_route", counted)
        eng.submit(ps, max_new_tokens=EIGHT_NEW)
        done = {r.arrival: r.output for r in eng.run()}
        monkeypatch.undo()
        assert sum(dropped) > 0, backend
        assert done == jdone, backend
        assert {k: int(eng.metrics[k]) for k in counters} == \
            {k: int(je.metrics[k]) for k in counters}, backend
        assert eng.audit_pool() == je.audit_pool(), backend
        for a, lg in je.request_logits.items():
            np.testing.assert_allclose(np.stack(eng.request_logits[a]),
                                       np.stack(lg), rtol=0, atol=1e-3)


def test_entry_points_take_the_slice_and_refuse_the_rest():
    """The factory, the serve-step makers, the engine and the CLI's
    ``--arch`` take every config this slice covers and the VLM family
    (paligemma-3b, ported since).  zamba2-7b and whisper-medium (the hybrid
    and encoder-decoder families, ROADMAP queue 1 items 15b and 15c) are
    built by the factory and taken by the three serve-step makers on both
    backends; the engine and the CLI refuse them with a ValueError naming
    the serve steps, as the reference's engine serves neither, and
    ``models/lm.py`` refuses their configs, naming the factory.  Tensor
    parallelism (item 13) is ported: the engine takes a mesh whose rank
    count divides the kv heads and refuses one that does not; training
    (item 16a) is ported: the factory's ``loss`` is ``models/lm.py``'s
    ``loss_fn``.  Tied embeddings are taken (no ``lm_head``; embeddings
    scaled by sqrt(d_model)) and give the JAX forward's logits."""
    from repro_torch.launch import serve
    from repro_torch.models import encdec as ET
    from repro_torch.models import hybrid as HT
    for arch in NEW_ARCHS + ("paligemma-3b",):
        cfg = get_smoke_config(arch)
        assert FT.build_model(cfg).module is LT
        for make in (lambda: SST.make_prefill_step(None, cfg),
                     lambda: SST.make_decode_step_fullkv(cfg),
                     lambda: SST.make_decode_step_thinkv(cfg, None),
                     lambda: SST.make_decode_step_thinkv(cfg, None,
                                                         backend="kernel")):
            assert callable(make())
        eng = ThinKVEngine(ServeConfig(model=cfg, thinkv=ThinKVConfig(**TK),
                                       max_seqs=1), device="cpu")
        assert eng.mcfg is cfg
        assert serve.build_parser().parse_args(["--arch", arch]).arch == arch
    for arch, mod, cls in (("zamba2-7b", HT, HT.HybridLM),
                           ("whisper-medium", ET, ET.EncDecLM)):
        cfg = get_smoke_config(arch)
        model = FT.build_model(cfg)
        assert model.module is mod
        assert isinstance(model.init_params(0, "cpu"), cls)
        for make in (lambda: SST.make_prefill_step(model, cfg),
                     lambda: SST.make_decode_step_fullkv(cfg),
                     lambda: SST.make_decode_step_thinkv(cfg, None),
                     lambda: SST.make_decode_step_thinkv(cfg, None,
                                                         backend="kernel")):
            assert callable(make())
        with pytest.raises(ValueError, match="serving/serve_step.py"):
            ThinKVEngine(ServeConfig(model=cfg, max_seqs=1), device="cpu")
        with pytest.raises(ValueError, match="serving/serve_step.py"):
            serve.main(["--arch", arch, "--device", "cpu"])
        with pytest.raises(ValueError, match="models/factory.py"):
            LT.init_params(cfg, device="cpu")
    base = get_smoke_config("r1-llama-8b")
    from repro_torch.launch.mesh import ServeMesh, make_serve_mesh
    assert ThinKVEngine(ServeConfig(model=base, max_seqs=1), device="cpu",
                        mesh=make_serve_mesh("model=1", device="cpu")
                        )._nshard == 1
    with pytest.raises(ValueError, match="cannot shard"):
        ThinKVEngine(ServeConfig(model=base, max_seqs=1), device="cpu",
                     mesh=ServeMesh(0, 4, None, torch.device("cpu")))
    assert FT.build_model(base).loss is LT.loss_fn
    jcfg = dataclasses.replace(jax_smoke("r1-llama-8b"), tie_embeddings=True)
    tied = dataclasses.replace(base, tie_embeddings=True)
    assert not hasattr(LT.init_params(tied, device="cpu"), "lm_head")
    jp = jax_params(jcfg)
    assert "lm_head" not in jp["embed"]
    toks = tokens(16, (B, S), tied.vocab_size)
    want, _ = LJ.logits_fn(jax.tree.map(jnp.asarray, jp),
                           {"tokens": jnp.asarray(toks)}, jcfg)
    got = params_from_numpy(jp, tied, "cpu")(torch.from_numpy(toks).long())
    close(got, want, 1e-4)
