"""The command refuses to run without the card it needs, and without the
program beside it, printing no result."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen2-7b.reason",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120, env=env)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(ROOT)
    assert r.returncode == 2 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys; sys.path.insert(0, 'bench'); import run; "
            "sys.exit(run.main(['--workload', 'qwen2-7b.reason', '--seed', "
            "'1', '--seconds', '1', '--trace', '0'], device='cpu'))")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())
    assert "repro_torch" in r.stderr
