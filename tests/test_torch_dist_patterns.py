"""The mesh patterns of the port (``repro_torch.distributed.ring_attention``,
``training/pipeline.py``, ``distributed/compression.py``'s cross-pod
gradient, ``distributed/overlap.py``) on 8 gloo CPU ranks against the live
JAX functions.

The JAX side runs in a subprocess with 8 forced host devices (the flag must
be set before JAX starts), at the shapes and seeds of the reference's own
tests (``tests/test_ring_attention.py``, ``tests/test_distributed.py``),
and writes its inputs and outputs to an npz.  The port runs every pattern
in one spawn of 8 ranks, each pattern on its own mesh over them; a rank
gets its blocks of the inputs (``sharding.shard_of``, as ``shard_map``
hands the reference's local functions theirs) and its outputs are
gathered back.  Bars:

* ring attention at the four shapes of the reference's test: within 3e-5
  (its bar) of the JAX ring; its gradient (of the output weighted by a
  seeded tensor, for q, k and v) within 1e-4 of each gradient's largest
  |g| (the port's gradient bar) of the gradient of the plain attention and
  of the JAX ring's;
* the pipeline: within 2e-5 of the JAX pipeline and of the stages applied
  in turn (the reference's bar);
* the compressed cross-pod gradient: within 0.02 relative of the exact one
  (the reference's bar), and each within 1e-6 of the JAX function's;
* ``overlapped_moe_ffn`` and ``chunked_all_to_all``: within 1e-5 of the
  JAX outputs (the reference checks only shape and finiteness).

Also: the ring branch of ``attn_forward`` under ``set_constraint_mesh`` on
4 ranks equals the plain branch within 3e-5, and is taken exactly where
the reference takes it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import MeshConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed.compression import \
    make_cross_pod_grad_fn  # noqa: E402
from repro_torch.distributed.overlap import (chunked_all_to_all,  # noqa
                                             overlapped_moe_ffn)
from repro_torch.distributed.ring_attention import ring_attention  # noqa
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.layers import attention as A  # noqa: E402
from repro_torch.training.pipeline import pipeline_apply  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING_ATOL = 3e-5
GRAD_REL = 1e-4
PIPE_ATOL = 2e-5
POD_REL = 0.02
POD_ATOL = 1e-6
MOE_ATOL = 1e-5
# (mesh shape, axis names, B, S, Hq, Hkv, D, seed): tests/test_ring_attention
RING = [((8,), ("model",), 2, 256, 7, 1, 32, 0),
        ((8,), ("model",), 2, 256, 8, 2, 32, 0),
        ((2, 4), ("data", "model"), 4, 128, 7, 1, 32, 0),
        ((4, 2), ("data", "model"), 4, 64, 6, 6, 16, 3)]

JAX_PATTERNS = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.distributed.compression import make_cross_pod_grad_fn
from repro.distributed.overlap import chunked_all_to_all, overlapped_moe_ffn
from repro.distributed.ring_attention import ring_attention
from repro.layers.attention import _dense_attention
from repro.training.pipeline import pipeline_apply
RING = %r
out = {}
for i, (shape, names, b, s, hq, hkv, d, seed) in enumerate(RING):
    mesh = jax.make_mesh(shape, names)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    w = np.random.default_rng(100 + i).standard_normal(
        (b, s, hq, d)).astype(np.float32)
    ring = lambda a, b_, c: ring_attention(a, b_, c, mesh)
    dense = lambda a, b_, c: _dense_attention(a, b_, c, causal=True,
                                              window=0)
    with mesh:
        o = jax.jit(ring)(q, k, v)
        g = jax.jit(jax.grad(lambda *a: jnp.sum(ring(*a) * w),
                             argnums=(0, 1, 2)))(q, k, v)
    gd = jax.grad(lambda *a: jnp.sum(dense(*a) * w), argnums=(0, 1, 2))(
        q, k, v)
    for n, x in zip(("q", "k", "v", "w", "out"), (q, k, v, w, o)):
        out[f"ring{i}_{n}"] = np.asarray(x)
    for n, a, c in zip("qkv", g, gd):
        out[f"ring{i}_dring_{n}"] = np.asarray(a)
        out[f"ring{i}_ddense_{n}"] = np.asarray(c)
mesh = jax.make_mesh((4, 2), ("pod", "model"))
rng = np.random.default_rng(4)
S, M, mb, d = 4, 8, 2, 16
ws = (rng.standard_normal((S, d, d)) * 0.3).astype(np.float32)
h0 = rng.standard_normal((M, mb, d)).astype(np.float32)
with mesh:
    po = pipeline_apply(lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws),
                        jnp.asarray(h0), mesh, num_microbatches=M,
                        axis="pod")
out.update(pipe_ws=ws, pipe_h0=h0, pipe_out=np.asarray(po))
mesh = jax.make_mesh((8,), ("pod",))
rng = np.random.default_rng(3)
w = rng.standard_normal((16,)).astype(np.float32)
batch = rng.standard_normal((8, 16)).astype(np.float32)
loss = lambda p, b: jnp.mean((b @ p) ** 2)
res = jnp.zeros((16,), jnp.float32)
with mesh:
    gc, _ = make_cross_pod_grad_fn(loss, mesh, compress=True)(w, batch, res)
    ge, _ = make_cross_pod_grad_fn(loss, mesh, compress=False)(w, batch,
                                                               res)
out.update(pod_w=w, pod_batch=batch, pod_gc=np.asarray(gc),
           pod_ge=np.asarray(ge))
mesh = jax.make_mesh((8,), ("model",))
rng = np.random.default_rng(5)
n, d, f = 64, 16, 32
x = rng.standard_normal((n, d)).astype(np.float32)
wu = (rng.standard_normal((8, d, f)) * 0.2).astype(np.float32)
wd = (rng.standard_normal((8, f, d)) * 0.2).astype(np.float32)
with mesh:
    y = overlapped_moe_ffn(jnp.asarray(x), jnp.asarray(wu.reshape(8 * d, f)),
                           jnp.asarray(wd.reshape(8 * f, d)), mesh, chunks=2)
out.update(moe_x=x, moe_wu=wu, moe_wd=wd, moe_y=np.asarray(y))
rng = np.random.default_rng(6)
xa = rng.standard_normal((64, 4, 8)).astype(np.float32)
wa = (rng.standard_normal((8, 8)) * 0.3).astype(np.float32)
with mesh:
    ya = jax.shard_map(
        lambda xl: chunked_all_to_all(xl, "model", 2,
                                      lambda c: jnp.tanh(c @ wa)),
        mesh=mesh, in_specs=(P("model"),), out_specs=P("model"),
        check_vma=False)(jnp.asarray(xa))
out.update(a2a_x=xa, a2a_w=wa, a2a_y=np.asarray(ya))
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX patterns' inputs and outputs, from 8 forced host devices."""
    path = str(tmp_path_factory.mktemp("patterns") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=8"))
    r = subprocess.run([sys.executable, "-c", JAX_PATTERNS % (RING,), path],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def patterns_rank(mesh8, ref):
    """Every pattern on this rank of 8, each on its own mesh over them;
    returns rank 0's gathered outputs (the others return None)."""
    torch.manual_seed(0)
    out = {}
    for i, (shape, names, *_rest) in enumerate(RING):
        mesh = M.make_mesh(MeshConfig(shape, names), mesh8.rank, "cpu")
        dp = SH.dp_axes(mesh)
        blk = lambda a: SH.shard_of(t(a), (dp,), mesh)  # noqa: E731
        q, k, v = (blk(ref[f"ring{i}_{n}"]).clone().requires_grad_(True)
                   for n in "qkv")
        o = ring_attention(q, k, v, mesh)
        (o * blk(ref[f"ring{i}_w"])).sum().backward()
        out[f"ring{i}_out"] = SH.unshard(o.detach(), (dp,), mesh)
        for n, x in zip("qkv", (q, k, v)):
            out[f"ring{i}_d{n}"] = SH.unshard(x.grad, (dp,), mesh)

    mesh = M.make_mesh(MeshConfig((4, 2), ("pod", "model")), mesh8.rank,
                       "cpu")
    ws = SH.shard_of(t(ref["pipe_ws"]), ("pod",), mesh)
    out["pipe_out"] = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws,
                                     t(ref["pipe_h0"]), mesh,
                                     num_microbatches=8, axis="pod")

    mesh = M.make_mesh(MeshConfig((8,), ("pod",)), mesh8.rank, "cpu")
    batch = SH.shard_of(t(ref["pod_batch"]), ("pod",), mesh)
    loss = lambda p, b: torch.mean((b @ p) ** 2)  # noqa: E731
    for name, compress in (("pod_gc", True), ("pod_ge", False)):
        out[name], _ = make_cross_pod_grad_fn(loss, mesh, compress=compress)(
            t(ref["pod_w"]), batch, torch.zeros(16))

    mesh = M.make_mesh(MeshConfig((8,), ("model",)), mesh8.rank, "cpu")
    x, wu, wd = (SH.shard_of(t(a), ("model",), mesh) for a in (
        ref["moe_x"], ref["moe_wu"].reshape(-1, 32),
        ref["moe_wd"].reshape(-1, 16)))
    y = overlapped_moe_ffn(x, wu, wd, mesh, chunks=2)
    out["moe_y"] = SH.unshard(y, ("model",), mesh)
    wa = t(ref["a2a_w"])
    ya = chunked_all_to_all(SH.shard_of(t(ref["a2a_x"]), ("model",), mesh),
                            mesh, "model", 2, lambda c: torch.tanh(c @ wa))
    out["a2a_y"] = SH.unshard(ya, ("model",), mesh)
    out["collectives"] = dict(SH.COLLECTIVES)
    out["ring_attn_forward"] = ring_attn_forward_case(mesh8)
    return {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in out.items()} if mesh8.rank == 0 else None


def ring_attn_forward_case(mesh8):
    """yi-6b's smoke attention over 256 positions: the ring branch under a
    constraint mesh of 4 model ranks (data 2) against the plain branch."""
    cfg = get_smoke_config("yi-6b")
    mesh = M.make_mesh(MeshConfig((2, 4), ("data", "model")), mesh8.rank,
                       "cpu")
    g = torch.Generator().manual_seed(11)
    p = {w: torch.randn(s, generator=g) * 0.1 for w, s in (
        ("wq", (cfg.d_model, cfg.q_dim)), ("wk", (cfg.d_model, cfg.kv_dim)),
        ("wv", (cfg.d_model, cfg.kv_dim)), ("wo", (cfg.q_dim, cfg.d_model)))}
    x = torch.randn((2, 256, cfg.d_model), generator=g)
    pos = torch.arange(256)[None]
    plain = A.attn_forward(p, x, cfg, pos)
    SH.set_constraint_mesh(mesh)
    try:
        taken = A.ring_selected(cfg, 256)
        ring = A.attn_forward(p, x, cfg, pos)
    finally:
        SH.set_constraint_mesh(None)
    return {"taken": taken,
            "max_abs": float((ring - plain).abs().max())}


@pytest.fixture(scope="module")
def port(jax_ref):
    return M.run_ranks(patterns_rank, "data=8", "cpu", jax_ref,
                       timeout=600, threads=1)[0]


def rel_close(got, want, rel):
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale, \
        (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("i", range(len(RING)),
                         ids=[f"{s}-{h}q{k}kv" for s, _, _, _, h, k, _, _
                              in RING])
def test_ring_attention_matches_the_jax_ring(jax_ref, port, i):
    np.testing.assert_allclose(port[f"ring{i}_out"], jax_ref[f"ring{i}_out"],
                               rtol=RING_ATOL, atol=RING_ATOL)


@pytest.mark.parametrize("i", range(len(RING)),
                         ids=[f"{s}-{h}q{k}kv" for s, _, _, _, h, k, _, _
                              in RING])
def test_ring_attention_gradient_matches_plain_attention(jax_ref, port, i):
    """The gradient through the ring (permutes, chunk slices and gathers
    under autograd) against the plain attention's and the JAX ring's."""
    for n in "qkv":
        for want in ("ddense", "dring"):
            rel_close(port[f"ring{i}_d{n}"], jax_ref[f"ring{i}_{want}_{n}"],
                      GRAD_REL)


def test_pipeline_matches_jax_and_the_stages_in_turn(jax_ref, port):
    np.testing.assert_allclose(port["pipe_out"], jax_ref["pipe_out"],
                               rtol=PIPE_ATOL, atol=PIPE_ATOL)
    seq = jax_ref["pipe_h0"]
    for w in jax_ref["pipe_ws"]:
        seq = np.tanh(seq @ w)
    np.testing.assert_allclose(port["pipe_out"], seq, rtol=PIPE_ATOL,
                               atol=PIPE_ATOL)


def test_compressed_cross_pod_gradient(jax_ref, port):
    gc, ge = port["pod_gc"], port["pod_ge"]
    assert np.linalg.norm(gc - ge) / np.linalg.norm(ge) < POD_REL
    for k in ("pod_gc", "pod_ge"):
        np.testing.assert_allclose(port[k], jax_ref[k], rtol=POD_ATOL,
                                   atol=POD_ATOL)


def test_overlapped_moe_ffn_and_chunked_all_to_all(jax_ref, port):
    for k in ("moe_y", "a2a_y"):
        assert port[k].shape == jax_ref[k].shape, k
        np.testing.assert_allclose(port[k], jax_ref[k], rtol=MOE_ATOL,
                                   atol=MOE_ATOL)


def test_patterns_communicate_through_the_counted_helpers(port):
    kinds = {k for k, _ in port["collectives"]}
    assert {"all_gather", "all_reduce", "send", "recv", "broadcast",
            "all_to_all"} <= kinds, port["collectives"]


def test_attn_forward_takes_the_ring_under_a_constraint_mesh(port):
    case = port["ring_attn_forward"]
    assert case["taken"]
    assert case["max_abs"] <= RING_ATOL, case


@pytest.mark.parametrize("arch,shape,seq,taken", [
    ("yi-6b", (2, 4), 256, True),          # smoke d_model 64: 64/4 < 128
    ("yi-6b", (2, 4), 250, False),         # S does not divide by |model|
    ("qwen2-7b", (16, 16), 4096, True),    # 28 heads % 16 != 0
    ("yi-6b", (16, 16), 4096, False),      # 32 heads, 4096/16 = 256
    ("r1-llama-8b", (4, 2), 512, False),   # 32 heads, 4096/2
    ("paligemma-3b", (16, 16), 4096, True),  # 8 heads % 16 != 0
    ("whisper-medium", (2, 8), 448, False),  # 16 heads, 1024/8 = 128
    ("whisper-medium", (1, 16), 448, True),  # 1024/16 = 64 < 128
])
def test_ring_is_selected_where_the_reference_selects_it(arch, shape, seq,
                                                          taken):
    """``ring_selected`` against the reference's condition
    (``repro/layers/attention.py:178-196``), worked by hand for each
    case; never without an installed constraint mesh."""
    from repro_torch.configs import get_config
    smoke = arch == "yi-6b" and shape == (2, 4)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    assert A.ring_selected(cfg, seq) is False
    SH.set_constraint_mesh(MeshConfig(shape, ("data", "model")))
    try:
        assert A.ring_selected(cfg, seq) is taken
    finally:
        SH.set_constraint_mesh(None)
