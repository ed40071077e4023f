"""The repo's three AST lint rules over ``src/repro_torch`` (ports
``scripts/lint_rules.py``; it lives in the package because ``scripts/`` is
the reference's).

1. **no-blocking-sync** — inside ``async def`` bodies of
   ``serving/orchestrator.py``, ``.block()``, ``torch.cuda.synchronize()``,
   ``.cpu()`` or ``.item()`` stalls the event loop for a device sync and
   kills the prefill/decode overlap the orchestrator exists for.  Passing
   the METHOD to an executor (``run_in_executor(None, res.block)``) is not
   a call, so it passes.
2. **no-refcount-mutation** — ``GlobalPool.refcount`` is the COW and
   prefix-cache ledger; every write goes through the audited ops of
   ``core/ct_cache.py``.  Elsewhere an assignment to ``<x>.refcount`` or
   to an item of it, an in-place method on it (``<x>.refcount.add_(...)``)
   or ``replace(refcount=...)`` would corrupt ``audit_pool``'s
   accounting.  Reads are fine.
3. **no-float64** — the contracts forbid fp64 in the entry points; this
   rule catches its sources: ``torch.float64`` / ``torch.double``,
   ``.double()``, ``np.float64`` and the string ``"float64"``, outside an
   explicit allowlist (each entry with its reason).

``python -m repro_torch.analysis.lint`` exits 0 when clean and 1 printing
``file:line [rule] message`` per violation.  Each ``lint_*`` function
takes explicit paths, so tests run the rules against fixture files.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1]          # src/repro_torch

BLOCKING_METHODS = {"block", "cpu", "item"}

#: files that may spell float64, with the reason
FLOAT64_ALLOWLIST = {
    # host-side statistics of calibration samples (numpy, never on the card)
    "core/calibration.py",
    # the exact f64 product of two f32 values emulates XLA's fused
    # scale-and-shift of jax.random.uniform (one rounding), so sampled
    # tokens equal JAX's
    "serving/prng.py",
    # the plain versions keep f64 inputs in f64 (the card's checks
    # evaluate them so); the engine never passes f64
    "kernels/ref.py",
    # the census detects float64 tensors; this rule spells what it flags
    "analysis/census.py",
    "analysis/lint.py",
}


def _fmt(path: Path, node: ast.AST, rule: str, msg: str) -> str:
    return f"{path}:{node.lineno} [{rule}] {msg}"


def lint_blocking_sync(path: Path) -> list:
    """Rule 1 over one file (the orchestrator)."""
    out = []

    class V(ast.NodeVisitor):
        def __init__(self):
            self.in_async = 0

        def visit_AsyncFunctionDef(self, node):
            self.in_async += 1
            self.generic_visit(node)
            self.in_async -= 1

        def visit_FunctionDef(self, node):
            # a nested plain def runs wherever it is called (often the
            # executor): only coroutine bodies are in scope
            was, self.in_async = self.in_async, 0
            self.generic_visit(node)
            self.in_async = was

        def visit_Call(self, node):
            f = node.func
            if self.in_async and isinstance(f, ast.Attribute):
                if f.attr == "synchronize" and _dotted(f.value) == \
                        "torch.cuda":
                    out.append(_fmt(path, node, "no-blocking-sync",
                                    "torch.cuda.synchronize() inside a "
                                    "coroutine blocks the event loop"))
                elif f.attr in BLOCKING_METHODS:
                    out.append(_fmt(
                        path, node, "no-blocking-sync",
                        f".{f.attr}() called inside a coroutine — park it "
                        f"on the executor instead "
                        f"(run_in_executor(None, x.{f.attr}))"))
            self.generic_visit(node)

    V().visit(ast.parse(path.read_text()))
    return out


def _dotted(node) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    return ""


def _is_refcount(node) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "refcount"


def lint_refcount_mutation(paths) -> list:
    """Rule 2 over ``paths`` (every file but ``core/ct_cache.py``)."""
    out = []
    msg = ("outside core/ct_cache.py — go through the audited pool ops "
           "(incref_blocks / release_blocks / COW)")
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                if _is_refcount(t) or (isinstance(t, ast.Subscript)
                                       and _is_refcount(t.value)):
                    out.append(_fmt(path, node, "no-refcount-mutation",
                                    f"assignment to refcount {msg}"))
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                f = node.func
                if _is_refcount(f.value) and f.attr.endswith("_") and \
                        not f.attr.startswith("_"):
                    out.append(_fmt(path, node, "no-refcount-mutation",
                                    f"in-place refcount.{f.attr}() {msg}"))
                if f.attr in ("replace", "_replace") and any(
                        kw.arg == "refcount" for kw in node.keywords):
                    out.append(_fmt(path, node, "no-refcount-mutation",
                                    f"replace(refcount=...) {msg}"))
    return out


def lint_float64(paths, allow: set = frozenset(), root: Path = SRC) -> list:
    """Rule 3 over ``paths``; ``allow`` holds paths relative to ``root``."""
    out = []
    for path in paths:
        try:
            rel = path.relative_to(root).as_posix()
        except ValueError:
            rel = None
        if rel in allow:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and \
                    node.attr in ("float64", "double") and \
                    _dotted(node.value) in ("torch", "np", "numpy"):
                out.append(_fmt(path, node, "no-float64",
                                f"{_dotted(node)} — the entry points are "
                                f"fp32 / bf16 / int only; a host-side use "
                                f"needs an allowlist entry in "
                                f"analysis/lint.py"))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "double" and not node.args:
                out.append(_fmt(path, node, "no-float64",
                                ".double() — the entry points are fp32 / "
                                "bf16 / int only"))
            elif isinstance(node, ast.Constant) and node.value == "float64":
                out.append(_fmt(path, node, "no-float64",
                                '"float64" dtype string'))
    return out


def run(src: Path = SRC) -> list:
    """Every rule over the package; returns the violations."""
    files = sorted(src.rglob("*.py"))
    ct_cache = src / "core" / "ct_cache.py"
    return (lint_blocking_sync(src / "serving" / "orchestrator.py")
            + lint_refcount_mutation([p for p in files if p != ct_cache])
            + lint_float64(files, FLOAT64_ALLOWLIST, src))


def main() -> int:
    violations = run()
    for v in violations:
        print(v)
    n = len(list(SRC.rglob("*.py")))
    status = "clean" if not violations else f"{len(violations)} violation(s)"
    print(f"lint: {n} files checked, {status}")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
