"""The JAX engine's records of the flash and the pressure trace, carried to
the card as numpy archives (``tests/golden/torch_flash_trace.npz``,
``tests/golden/torch_pressure_trace.npz``), and the port's replay of them
(``repro_torch.serving.trace_record``).

A record is the live JAX ``reference`` engine's run: its parameters, tokens
and logits per request, the engine counters and the pool audit.  The flash
record has the settings of ``tests/test_torch_engine.py::jax_run``
(prompts of 140 and 24 tokens from ``np.random.default_rng(1)``, 8 new
tokens, 3 slots, an unpressured pool); the pressure record those of
``tests/test_torch_pressure.py::jax_run`` (five prompts, three sharing a
16-token prefix, 24 new tokens, a 14-block pool, the prefix cache on).
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the card's kernel
and reference backends to them, where there is no JAX.  The golden
``serving_trace.json`` is not such a record (it dates from an older tree:
its flash tokens and its pressure tokens no longer match the reference,
its pressure counters still do).

A test here re-runs the JAX engine on each trace and asserts that the
archive equals the fresh record, so a file cannot go stale silently.  To
write both anew (after a change to the reference engine or to these
settings):

    PYTHONPATH=src python tests/test_torch_trace_fixture.py
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import ServeConfig as JSC  # noqa: E402
from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.serving.engine import ThinKVEngine as JaxEngine  # noqa: E402
from repro_torch.serving import trace_record as TR  # noqa: E402
import test_torch_pressure as PT  # noqa: E402
from test_torch_engine import (COUNTERS, LENS, MAX_NEW,  # noqa: E402
                               PRIORITIES, SLOTS, TK, prompts)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FIXTURE = os.path.join(GOLDEN, "torch_flash_trace.npz")
PRESSURE_FIXTURE = os.path.join(GOLDEN, "torch_pressure_trace.npz")
SETTINGS = {"model": "r1-llama-8b", "num_heads": 8, "num_kv_heads": 8,
            "thinkv": TK, "slots": SLOTS, "max_new": MAX_NEW,
            "priorities": list(PRIORITIES)}
PRESSURE_SETTINGS = {"model": "r1-llama-8b", "num_heads": 8,
                     "num_kv_heads": 8, "thinkv": TK, "slots": PT.SLOTS,
                     "max_new": PT.MAX_NEW,
                     "priorities": list(PT.PRIORITIES),
                     "pool_blocks": PT.pool_blocks(), "prefix_cache": True,
                     "prompt_recipe": PT.RECIPE}


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict of arrays -> {``a/b/c``: array} (the archive's
    ``param/`` keys; ``trace_record.load`` nests them again)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_record(settings: dict = SETTINGS, ps=None,
               counters=COUNTERS) -> dict:
    """The JAX reference engine's run of a trace (by default the flash
    trace), as the archive's arrays (see
    ``repro_torch.serving.trace_record``)."""
    mcfg = dataclasses.replace(jax_smoke(settings["model"]),
                               num_heads=settings["num_heads"],
                               num_kv_heads=settings["num_kv_heads"])
    eng = JaxEngine(JSC(model=mcfg, thinkv=JTK(**settings["thinkv"]),
                        max_seqs=settings["slots"]),
                    backend="reference", record_logits=True,
                    pool_blocks=settings.get("pool_blocks"),
                    prefix_cache=settings.get("prefix_cache", False))
    ps = prompts() if ps is None else ps
    eng.submit(ps, max_new_tokens=settings["max_new"],
               priorities=settings["priorities"])
    done = eng.run()
    out = {"settings": np.array(json.dumps(settings)),
           "record": np.array(json.dumps(
               {"counters": {k: int(eng.metrics[k]) for k in counters},
                "audit": eng.audit_pool()}, default=int))}
    out.update({f"prompt_{i}": p for i, p in enumerate(ps)})
    for r in done:
        out[f"tokens_{r.arrival}"] = np.asarray(r.output, np.int64)
        out[f"logits_{r.arrival}"] = np.stack(
            eng.request_logits[r.arrival]).astype(np.float32)
    params = flatten(jax.tree.map(np.asarray, eng.params))
    out.update({TR.PARAM + k: v for k, v in params.items()})
    return out


def jax_pressure_record() -> dict:
    return jax_record(PRESSURE_SETTINGS, PT.prompts(), PT.COUNTERS)


def write_fixture(path: str = FIXTURE) -> None:
    np.savez(path, **jax_record())


def write_pressure_fixture(path: str = PRESSURE_FIXTURE) -> None:
    np.savez(path, **jax_pressure_record())


def assert_archive_equals(path: str, fresh: dict) -> None:
    """Tokens, counters, audit, prompts and parameters exactly; logits to
    1e-6."""
    with np.load(path, allow_pickle=False) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in fresh:
            if k.startswith("logits_"):
                np.testing.assert_allclose(z[k], fresh[k], rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                assert z[k].dtype == fresh[k].dtype, k
                np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)


@pytest.fixture(scope="module")
def stored():
    return TR.load(FIXTURE)


@pytest.fixture(scope="module")
def stored_pressure():
    return TR.load(PRESSURE_FIXTURE)


def test_fixture_equals_the_live_jax_record(stored):
    """Tokens, counters, audit, prompts and parameters exactly; logits to
    1e-6."""
    fresh = jax_record()
    assert_archive_equals(FIXTURE, fresh)
    n_params = sum(v.size for k, v in fresh.items()
                   if k.startswith(TR.PARAM))
    assert n_params == 147_776
    assert stored["settings"]["thinkv"] == json.loads(json.dumps(TK))
    assert [len(p) for p in stored["prompts"]] == list(LENS)
    assert all(len(t) == MAX_NEW for t in stored["tokens"].values())


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_port_replays_the_record_on_the_cpu(stored, backend):
    """``trace_record.replay`` (what the card's test and ``chip_smoke.py``
    run) on the CPU: the record's tokens, logits within 1e-3, counters and
    audit; the plain versions launch nothing."""
    eng, done, launches = TR.replay(stored, backend, "cpu")
    bad, worst = TR.mismatches(stored, eng, done)
    assert not bad, bad
    assert worst <= 1e-3
    assert not any(launches.values())
    assert TR.expected_commits(stored) == (140 + 7) // 8 + (24 + 7) // 8


def test_mismatches_names_what_differs(stored):
    """The comparison the card is held to catches a changed token, logit,
    counter or audit."""
    eng, done, _ = TR.replay(stored, "reference", "cpu")
    rec = dict(stored, tokens={a: list(t) for a, t in
                               stored["tokens"].items()})
    rec["tokens"][0][3] += 1
    rec["logits"] = {a: l + (2e-3 if a == 1 else 0.0)
                     for a, l in stored["logits"].items()}
    rec["counters"] = dict(stored["counters"], ticks=0)
    rec["audit"] = dict(stored["audit"], pool_blocks=-1)
    bad, _ = TR.mismatches(rec, eng, done)
    assert [b.split()[0] for b in bad] == ["tokens", "logits", "counters",
                                           "pool"]


def test_pressure_fixture_equals_the_live_jax_record(stored_pressure):
    """The pressure record: the live engine's run, with the counters the
    port is held to (9 preemptions, 9 resumes, 2 prefix hits, 4 COW
    faults ...) and the settings the replay builds its engine from."""
    assert_archive_equals(PRESSURE_FIXTURE, jax_pressure_record())
    rec = stored_pressure
    assert {k: rec["counters"][k] for k in PT.WANT} == PT.WANT
    assert rec["audit"] == {"claimed": [3, 3], "free": [11, 11],
                            "pool_blocks": 14}
    assert rec["settings"]["pool_blocks"] == 14
    assert rec["settings"]["prefix_cache"] is True
    assert [len(p) for p in rec["prompts"]] == list(PT.LENS)
    for a, b in zip(rec["prompts"], PT.prompts()):
        np.testing.assert_array_equal(a, b)
    assert all(len(t) == PT.MAX_NEW for t in rec["tokens"].values())


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_port_replays_the_pressure_record_on_the_cpu(stored_pressure,
                                                     backend):
    """The pressure record through ``trace_record.replay`` on the CPU: the
    record's tokens, logits within 1e-3, counters and audit; commits
    counted by the engine (prefix hits skip four)."""
    eng, done, launches = TR.replay(stored_pressure, backend, "cpu")
    bad, worst = TR.mismatches(stored_pressure, eng, done)
    assert not bad, bad
    assert worst <= 1e-3
    assert not any(launches.values())
    assert eng.metrics["commits"] == TR.expected_commits(stored_pressure) - 4


if __name__ == "__main__":
    write_fixture()
    write_pressure_fixture()
    for path in (FIXTURE, PRESSURE_FIXTURE):
        print(f"wrote {path}: {os.path.getsize(path)} bytes")
