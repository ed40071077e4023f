"""Nothing under bench/ imports JAX or the JAX package ``repro`` (top-level
names compared whole: ``repro_torch`` is another package), and the
reference imports nothing of the measured program."""
import ast
import pathlib

import pytest

import tinycell  # noqa: F401  (puts bench/ on the path)

BENCH = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert top_level_imports(path) <= {"__future__", "math", "typing",
                                       "torch"}


def test_forbidden_names_compare_whole():
    import run
    assert run.forbidden_modules(["repro_torch", "repro_torch.serving",
                                  "reprox", "torch"]) == []
    assert run.forbidden_modules(["repro.core.ct_cache", "jax.numpy",
                                  "jaxlib", "flax"]) == \
        ["flax", "jax", "jaxlib", "repro"]
