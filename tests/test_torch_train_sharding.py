"""The train half of the sharding rules (``repro_torch.distributed.
sharding``: ``param_specs`` in train and serve mode, ``train_batch_specs``,
``decode_batch_specs``, ``shard_of``, ``constrain``) against the
reference's.

The reference's rules need only the mesh's axis names and sizes, so they
run here on ``jax.eval_shape`` of each registered config's
``init_params`` (the full widths, no memory) and a stand-in mesh object
(``axis_names``, ``devices = np.empty(shape)``).  Every spec must be
equal, entry for entry, on the (2, 4), (16, 16) and (2, 16, 16) meshes.
The blocks ``shard_of`` cuts must be those ``NamedSharding`` lays out for
the same spec, device i holding rank i's block (an 8-device subprocess
writes its index map); the blocks of all ranks tile the tensor exactly.
"""
import functools
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.distributed import sharding as SJ  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.config import MeshConfig  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.convert import param_paths  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import TrainMesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def stand_in(key):
    shape, names = MESHES[key]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def port_mesh(key):
    shape, names = MESHES[key]
    return MeshConfig(shape, names)


@functools.lru_cache(maxsize=None)
def jax_shapes(arch):
    cfg = jax_config(arch)
    return jax.eval_shape(lambda: jax_build(cfg).init_params(0))


def jax_specs_by_port_name(arch, key, mode):
    specs = SJ.param_specs(jax_shapes(arch), stand_in(key), mode=mode)
    out = {}
    for name, path in param_paths(get_config(arch)).items():
        leaf = specs
        for k in path:
            leaf = leaf[k]
        out[name] = tuple(leaf)
    return out


def test_every_registered_config_is_covered():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)


@pytest.mark.parametrize("key", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, key):
    """Train and serve mode, every parameter, full widths; the port's
    names cover every leaf of the reference's tree."""
    n_leaves = len(jax.tree.leaves(jax_shapes(arch)))
    for mode in ("train", "serve"):
        want = jax_specs_by_port_name(arch, key, mode)
        got = SH.param_specs(get_config(arch), port_mesh(key), mode=mode)
        assert len(got) == n_leaves
        assert got == want, {k: (got[k], want[k]) for k in got
                             if got[k] != want[k]}


def train_batches():
    """Batches whose first axis divides every dp size, some, or none."""
    out = []
    for b in (512, 8, 3, 1):
        out.append({"tokens": np.zeros((b, 16), np.int32),
                    "targets": np.zeros((b, 16), np.int32),
                    "loss_mask": np.zeros((b, 16), np.float32),
                    "patches": np.zeros((b, 4, 8), np.float32),
                    "frames": np.zeros((b, 6, 8), np.float32),
                    "scale": np.zeros((), np.float32)})
    return out


def decode_batches():
    """The FullKV decode step's keys, the CT pool's and cross caches',
    batches that split over dp and one that cannot (a single request)."""
    out = []
    for b, t in ((32, 64), (8, 4096), (1, 512), (1, 8192)):
        cache = np.zeros((b, 2, t, 4, 8), np.float32)
        out.append({"tokens": np.zeros((b,), np.int32),
                    "positions": np.zeros((b,), np.int32),
                    "k_cache": cache, "v_cache": cache,
                    "k_codes": cache.astype(np.uint8), "slot_state": cache,
                    "cross_k": cache, "cache_len": np.zeros((b,), np.int32),
                    "other": np.zeros((b, 3, t), np.float32)})
    return out


@pytest.mark.parametrize("key", MESHES)
def test_batch_specs_equal_the_references(key):
    for batch in train_batches():
        want = SJ.train_batch_specs(batch, stand_in(key))
        got = SH.train_batch_specs(batch, port_mesh(key))
        assert got == {k: tuple(v) for k, v in want.items()}
    for batch in decode_batches():
        want = SJ.decode_batch_specs(batch, stand_in(key))
        got = SH.decode_batch_specs(batch, port_mesh(key))
        assert got == {k: tuple(v) for k, v in want.items()}


LAYOUT_MESHES = {"2x4": ((2, 4), ("data", "model")),
                 "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
LAYOUT_SPECS = [(("pod", "data"), "model"), ("model", ("pod", "data")),
                (None, ("pod", "data"), "model"), ("data",), ("model",),
                (("data", "model"),), (None, "model", "data"), ()]
SHAPE = (8, 12, 4)

NAMED_SHARDING = r'''
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
meshes, specs, shape = json.loads(sys.argv[1])
out = {}
for key, (mshape, names) in meshes.items():
    mesh = Mesh(np.array(jax.devices()).reshape(mshape), tuple(names))
    for i, spec in enumerate(specs):
        spec = [tuple(a) if isinstance(a, list) else a for a in spec]
        if any(a is not None and not set(a if isinstance(a, tuple) else (a,))
               <= set(names) for a in spec):
            continue
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
        out[f"{key}/{i}"] = [[[s.start or 0, s.stop if s.stop is not None
                               else n] for s, n in zip(idx[d], shape)]
                             for d in jax.devices()]
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def named_layouts():
    """{mesh/spec: per device (= rank) the [start, stop) of each dim}."""
    import json
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=8"))
    arg = json.dumps([LAYOUT_MESHES, LAYOUT_SPECS, SHAPE])
    r = subprocess.run([sys.executable, "-c", NAMED_SHARDING, arg], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout)


@pytest.mark.parametrize("key", LAYOUT_MESHES)
def test_blocks_are_named_shardings_blocks(named_layouts, key):
    """Rank i's block is device i's slice under ``NamedSharding`` (axes
    the mesh lacks are left out, as the spec could not name them); the
    blocks tile the tensor."""
    shape, names = LAYOUT_MESHES[key]
    x = torch.arange(int(np.prod(SHAPE))).reshape(SHAPE)
    checked = 0
    for i, spec in enumerate(LAYOUT_SPECS):
        layout = named_layouts.get(f"{key}/{i}")
        if layout is None:
            continue
        cover = torch.zeros(SHAPE, dtype=torch.int64)
        for rank, bounds in enumerate(layout):
            mesh = TrainMesh(names, shape, rank)
            blk = SH.shard_of(x, spec, mesh)
            want = x[tuple(slice(a, b) for a, b in bounds)]
            assert torch.equal(blk, want), (spec, rank)
            assert blk.shape == SH.block_shape(SHAPE, spec, mesh)
            cover[tuple(slice(a, b) for a, b in bounds)] += 1
        reps = int(np.prod(shape)) // SH.axes_size(MeshConfig(shape, names),
                                                    tuple(a for e in spec
                                                          for a in
                                                          SH._as_tuple(e)))
        assert bool((cover == reps).all())
        checked += 1
    assert checked >= 5


def test_block_index_is_major_axis_first():
    mesh = TrainMesh(("pod", "data", "model"), (2, 4, 2), 13)
    assert mesh.coords == {"pod": 1, "data": 2, "model": 1}
    assert SH.block_index(mesh, ("pod", "data")) == 1 * 4 + 2
    assert SH.block_index(mesh, ("data", "pod")) == 2 * 2 + 1
    assert SH.block_index(mesh, "model") == 1


def test_constrain_has_no_pytorch_meaning():
    x = torch.ones(4, 8)
    SH.set_constraint_mesh(MeshConfig((2, 4), ("data", "model")))
    try:
        assert SH.constrain(x, "dp", None) is x
    finally:
        SH.set_constraint_mesh(None)
    assert SH.constraint_mesh() is None


def test_axes_a_mesh_lacks_count_as_one():
    """A ``--mesh-shape 2`` run (axes data only): the rules refuse the
    mesh, as the reference's ``_fits`` does (``KeyError``); a spec naming
    ``model`` (written by hand) splits nothing along it in ``shard_of``."""
    mesh = MeshConfig((2,), ("data",))
    cfg = get_config("r1-llama-8b")
    with pytest.raises(KeyError, match="model"):
        SH.param_specs(cfg, mesh)
    tm = TrainMesh(("data",), (2,), 1)
    x = torch.arange(8 * 6).reshape(8, 6)
    assert torch.equal(SH.shard_of(x, ("model", "data"), tm), x[:, 3:])


@pytest.mark.parametrize("arch", ["r1-llama-8b", "mixtral-8x7b",
                                  "falcon-mamba-7b"])
def test_param_specs_refuse_a_mesh_without_model(arch):
    """Both packages refuse a ``("data",)`` mesh (``KeyError`` at the first
    rule naming ``model``), and on ``("data", "model")`` the port's specs
    are the reference's; the serving check keeps its ``.get`` (a mesh
    without ``model`` serves on one rank in both)."""
    data_only = types.SimpleNamespace(axis_names=("data",),
                                      devices=np.empty((2,)))
    with pytest.raises(KeyError, match="model"):
        SJ.param_specs(jax_shapes(arch), data_only)
    with pytest.raises(KeyError, match="model"):
        SH.param_specs(get_config(arch), MeshConfig((2,), ("data",)))
    with pytest.raises(KeyError, match="model"):
        SH.axes_size(MeshConfig((2,), ("data",)), ("data", "model"))
    two = types.SimpleNamespace(axis_names=("data", "model"),
                                devices=np.empty((2, 2)))
    for mode in ("train", "serve"):
        specs = SJ.param_specs(jax_shapes(arch), two, mode=mode)
        want = {}
        for name, path in param_paths(get_config(arch)).items():
            leaf = specs
            for k in path:
                leaf = leaf[k]
            want[name] = tuple(leaf)
        assert SH.param_specs(get_config(arch),
                              MeshConfig((2, 2), ("data", "model")),
                              mode=mode) == want
    assert SJ.head_shardable(8, data_only) == SH.head_shardable(8, 1)


# ---------------------------------------------------------------------------
# regroup_model on gloo CPU ranks
# ---------------------------------------------------------------------------

REGROUP_W = 12                         # columns; 3 per rank over model 4


def regroup_spans(r: int):
    """Rank r's reads: a span across its block's edge, a span every rank
    reads, and the last columns (blocks several ranks read)."""
    return [(3 * r + 1, min(3 * r + 5, REGROUP_W)), (0, 2), (9, 12)]


def regroup_inputs():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 5, REGROUP_W, generator=g, dtype=torch.float64)
    seeds = [torch.randn(3, 5, sum(b - a for a, b in regroup_spans(r)),
                         generator=g, dtype=torch.float64)
             for r in range(4)]
    return x, seeds


def regroup_rank(mesh) -> dict:
    """This rank's regroup of its block and of the whole tensor: the
    outputs, the gradients of sum(out * seed) and the bytes counted."""
    x, seeds = regroup_inputs()
    r = SH.model_index(mesh)
    out = {}
    for case in ("block", "whole"):
        SH.reset_collectives()
        src = x[..., 3 * r:3 * r + 3] if case == "block" else x
        src = src.clone().requires_grad_(True)
        y = SH.regroup_model(src, mesh, regroup_spans(r), REGROUP_W)
        (y * seeds[r]).sum().backward()
        out[case] = {"y": y.detach(), "grad": src.grad,
                     "traffic": dict(SH.TRAFFIC)}
    return out


@pytest.fixture(scope="module")
def regrouped():
    from repro_torch.launch import mesh as M
    return M.run_ranks(regroup_rank, "data=1,model=4", "cpu", timeout=120,
                       threads=1)


def test_regroup_moves_columns_and_sums_their_gradients(regrouped):
    """``sharding.regroup_model`` on 4 ranks along ``model``, from each
    rank's block and from the whole replicated tensor: its output is the
    whole tensor's spans, and its gradient is that of the one-rank
    autograd of every rank's slicing (columns several ranks read get the
    sum), this rank's block of it (or all of it, whole), exactly; the
    block's all-gather, the gradient's reduce-scatter and the whole
    tensor's to_model sum are counted under (kind, "model", "act")."""
    x, seeds = regroup_inputs()
    xx = x.clone().requires_grad_(True)
    sum((torch.cat([xx[..., a:b] for a, b in regroup_spans(r)], -1)
         * seeds[r]).sum() for r in range(4)).backward()
    nbytes = x.numel() * x.element_size()
    for r, res in enumerate(regrouped):
        want = torch.cat([x[..., a:b] for a, b in regroup_spans(r)], -1)
        for case in ("block", "whole"):
            assert torch.equal(res[case]["y"], want), (r, case)
        assert torch.allclose(res["block"]["grad"],
                              xx.grad[..., 3 * r:3 * r + 3], rtol=0,
                              atol=1e-12), r
        assert torch.allclose(res["whole"]["grad"], xx.grad, rtol=0,
                              atol=1e-12), r
        assert res["block"]["traffic"] == {
            ("all_gather", "model", "act"): nbytes // 4,
            ("reduce_scatter", "model", "act"): nbytes}
        assert res["whole"]["traffic"] == {
            ("all_reduce", "model", "act"): nbytes}
