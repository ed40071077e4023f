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
    pytest.param(dict(mesh=object()), "13", id="kw3-13"),
    pytest.param(dict(drift_probe=True), "12", id="kw4-12"),
    pytest.param(dict(policy="rkv"), "12", id="kw5-12")])
def test_options_outside_the_slice_name_their_roadmap_item(kw, item):
    """An option of a ROADMAP item not yet ported raises, naming the item;
    item 11's options (multi-tick dispatch, forks) and item 12's (the
    drift probe, which records logits, and the rkv policy) are ported
    since, and the engine takes them."""
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
