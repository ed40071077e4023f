"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX or anything of the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def forbidden_imports(source: str):
    """Top-level package names in ``FORBIDDEN`` that ``source`` imports
    (``repro_torch`` is its own package and never matches ``repro``)."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_package_imports(path):
    assert forbidden_imports(path.read_text()) == []


@pytest.mark.parametrize("src,bad", [
    ("import jax", ["jax"]),
    ("import jax.numpy as jnp", ["jax.numpy"]),
    ("from jaxlib import xla_client", ["jaxlib"]),
    ("import repro", ["repro"]),
    ("from repro.config import base", ["repro.config"]),
    ("from repro.serving import scheduler", ["repro.serving"]),
    ("import repro_torch", []),
    ("from repro_torch.core import ct_cache", []),
    ("from . import ops", []),
])
def test_import_check_matches_packages_exactly(src, bad):
    assert forbidden_imports(src) == bad


COLLECTIVES = {"all_gather", "all_gather_into_tensor", "all_gather_object",
               "all_reduce", "all_to_all", "all_to_all_single", "barrier",
               "broadcast", "broadcast_object_list", "gather", "irecv",
               "isend", "recv", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "scatter", "send"}
# the serving helpers, and the launcher that only sets the group up
COLLECTIVE_FILES = {"src/repro_torch/distributed/sharding.py",
                    "src/repro_torch/launch/mesh.py"}


def collective_calls(source: str):
    """``torch.distributed`` collectives that ``source`` calls, through any
    alias of the module (``import torch.distributed as dist``, ``from torch
    import distributed``) or a name imported from it."""
    tree = ast.parse(source)
    mods, names = {"torch.distributed"}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                if node.module == "torch" and a.name == "distributed":
                    mods.add(a.asname or a.name)
                elif node.module == "torch.distributed" and \
                        a.name in COLLECTIVES:
                    names[a.asname or a.name] = a.name

    def dotted(n):
        if isinstance(n, ast.Name):
            return n.id
        if isinstance(n, ast.Attribute):
            return f"{dotted(n.value)}.{n.attr}"
        return ""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in COLLECTIVES and \
                dotted(f.value) in mods:
            out.append(f.attr)
        elif isinstance(f, ast.Name) and f.id in names:
            out.append(names[f.id])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_collectives_only_in_the_sharding_helpers(path):
    """Every ``torch.distributed`` collective of the port goes through
    ``distributed/sharding.py`` (whose helpers count them for the
    contracts' census); ``launch/mesh.py`` only sets the group up."""
    rel = path.relative_to(ROOT).as_posix()
    calls = collective_calls(path.read_text())
    if rel in COLLECTIVE_FILES:
        return
    assert calls == [], f"{rel} calls {calls}"


@pytest.mark.parametrize("src,calls", [
    ("import torch.distributed as dist\ndist.all_reduce(x)", ["all_reduce"]),
    ("import torch\ntorch.distributed.all_gather(o, x)", ["all_gather"]),
    ("from torch import distributed as d\nd.broadcast(x, 0)", ["broadcast"]),
    ("from torch.distributed import all_reduce as ar\nar(x)",
     ["all_reduce"]),
    ("import torch.distributed as dist\ndist.get_rank()", []),
    ("from repro_torch.distributed import sharding as SH\n"
     "SH.gather_heads(x, m, 1)", []),
])
def test_collective_check_matches_calls_exactly(src, calls):
    assert collective_calls(src) == calls


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import init_params
    from repro_torch.serving.engine import ThinKVEngine
    cfg = get_smoke_config("r1-llama-8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ThinKVEngine(ServeConfig(model=cfg, max_seqs=1))
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ThinKVEngine(ServeConfig(model=cfg, max_seqs=1), params=params)


@pytest.mark.parametrize("kw,item", [
    pytest.param(dict(ticks_per_dispatch=2), "11", id="kw1-11"),
    pytest.param(dict(allow_forks=True), "11", id="kw2-11"),
    pytest.param(dict(mesh="model=1"), "13", id="kw3-13"),
    pytest.param(dict(drift_probe=True), "12", id="kw4-12"),
    pytest.param(dict(policy="rkv"), "12", id="kw5-12")])
def test_options_outside_the_slice_name_their_roadmap_item(kw, item):
    """An option of a ROADMAP item not yet ported raises, naming the item;
    item 11's options (multi-tick dispatch, forks), item 12's (the drift
    probe, which records logits, and the rkv policy) and item 13's (a
    tensor-parallel mesh, here of one rank) are ported since, and the
    engine takes them."""
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.engine import ThinKVEngine
    cfg = ServeConfig(model=get_smoke_config("r1-llama-8b"), max_seqs=1)
    if item == "11":
        eng = ThinKVEngine(cfg, device="cpu", **kw)
        assert eng.ticks_per_dispatch == kw.get("ticks_per_dispatch", 1)
        assert eng._track_cow == kw.get("allow_forks", False)
        return
    if item == "12":
        eng = ThinKVEngine(cfg, device="cpu", **kw)
        assert eng.drift_probe == eng.record_logits == \
            kw.get("drift_probe", False)
        assert eng.policy.name == kw.get("policy", "thinkv")
        return
    if item == "13":
        from repro_torch.launch.mesh import make_serve_mesh
        mesh = make_serve_mesh(kw["mesh"], device="cpu")
        eng = ThinKVEngine(cfg, device="cpu", mesh=mesh)
        assert eng.mesh is mesh and eng._nshard == 1
        assert eng.ldims == eng.dims
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        ThinKVEngine(cfg, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(prefix_cache=True),
                                dict(pool_blocks=1)])
def test_the_engine_takes_the_prefix_cache_and_an_oversubscribed_pool(kw):
    """ROADMAP item 10's options are ported: the engine builds with them."""
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.engine import ThinKVEngine
    cfg = ServeConfig(model=get_smoke_config("r1-llama-8b"), max_seqs=1)
    eng = ThinKVEngine(cfg, device="cpu", **kw)
    assert (eng.prefix_cache is not None) == kw.get("prefix_cache", False)
    assert eng.num_pool_blocks == kw.get("pool_blocks", eng.dims.NB)


def test_temperature_above_zero_is_not_ported():
    """Sampling at temperature > 0 was refused until ROADMAP item 11 was
    ported; the engine now takes it and keeps one key stream per slot."""
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.engine import ThinKVEngine
    cfg = ServeConfig(model=get_smoke_config("r1-llama-8b"), max_seqs=1,
                      temperature=0.7)
    eng = ThinKVEngine(cfg, device="cpu")
    assert eng.cfg.temperature == 0.7
    assert tuple(eng._slot_keys.shape) == (1, 2)
