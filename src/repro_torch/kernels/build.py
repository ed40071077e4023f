"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each source is compiled by its own ``nvcc`` process (all started together)
into a shared library with a plain C interface for ``sm_90a``, then loaded
with ``ctypes``.  The build runs at first use, from the sources in the
checkout alone, into ``build/repro_torch_kernels/<hash>/`` at the root of
the checkout (git-ignored), keyed by a hash of the sources, the headers
they share (``csrc/*.cuh``) and the flags, so a changed kernel is rebuilt
and an unchanged one is loaded as is.  Nothing is built when this module
is imported.  :data:`BUILDS` counts the times the libraries were built or
loaded (once per process), which ``analysis/retrace.py`` reads as the
port's counterpart of a retrace.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_ROOT = ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signature of every exported kernel launcher: (source, argtypes)
SIGNATURES = {
    "ct_paged_attention_fused": (
        "ct_paged_attention", [P] * 12 + [I] * 10 + [F, P]),
    "ct_paged_attention_batched": (
        "ct_paged_attention", [P] * 13 + [I] * 9 + [F, P]),
    "flash_prefill_stats": ("flash_prefill", [P] * 6 + [I] * 7 + [F, P]),
    "group_quant": ("group_quant", [P] * 3 + [I] * 4 + [P]),
    "group_quant_commit": ("group_quant", [P] * 7 + [I] * 3 + [P]),
    "mamba_scan": ("mamba_scan", [P] * 6 + [I] * 4 + [P]),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILDS = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source in parallel (if not already built) and load
    the libraries; returns {source stem: CDLL}."""
    global BUILDS
    if _LIBS:
        return _LIBS
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        so = out_dir / f"lib{src.stem}.so"
        if so.exists():
            continue
        tmp = tempfile.NamedTemporaryFile(dir=out_dir, suffix=".so",
                                          delete=False).name
        log = open(out_dir / f"{src.stem}.log", "w")
        procs.append((src, so, tmp, log, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, so, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src.name}:\n{(out_dir / f'{src.stem}.log').read_text()}")
            os.unlink(tmp)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    libs = {src.stem: ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
            for src in sources}
    for fn, (stem, argtypes) in SIGNATURES.items():
        f = getattr(libs[stem], fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS.update(libs)
    BUILDS += 1
    return _LIBS


def kernel(name: str):
    """The ctypes function of one kernel launcher (building on first use)."""
    stem = SIGNATURES[name][0]
    return getattr(build_all()[stem], name)


def build_logs() -> Dict[str, str]:
    """``nvcc -Xptxas -v`` output of the current build, per source."""
    out_dir = BUILD_ROOT / _digest()
    return {p.stem: p.read_text() for p in sorted(out_dir.glob("*.log"))}
