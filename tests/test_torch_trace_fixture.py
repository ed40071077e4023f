"""The JAX engine's record of the flash trace, carried to the card as a numpy
archive (``tests/golden/torch_flash_trace.npz``), and the port's replay of
it (``repro_torch.serving.trace_record``).

The record is the live JAX ``reference`` engine on the flash trace with the
settings of ``tests/test_torch_engine.py::jax_run`` (prompts of 140 and 24
tokens from ``np.random.default_rng(1)``, 8 new tokens, 3 slots): its
parameters, tokens and logits per request, the engine counters and the
pool audit.  ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the
card's kernel and reference backends to it, where there is no JAX.  The
golden ``serving_trace.json`` is not this record (it dates from an older
tree and no longer matches the reference).

The first test here re-runs the JAX engine and asserts that the archive
equals the fresh record, so the file cannot go stale silently.  To write
it anew (after a change to the reference engine or to these settings):

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
from test_torch_engine import (COUNTERS, LENS, MAX_NEW,  # noqa: E402
                               PRIORITIES, SLOTS, TK, prompts)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                       "torch_flash_trace.npz")
SETTINGS = {"model": "r1-llama-8b", "num_heads": 8, "num_kv_heads": 8,
            "thinkv": TK, "slots": SLOTS, "max_new": MAX_NEW,
            "priorities": list(PRIORITIES)}


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


def jax_record() -> dict:
    """The JAX reference engine's run of the flash trace, as the archive's
    arrays (see ``repro_torch.serving.trace_record``)."""
    mcfg = dataclasses.replace(jax_smoke(SETTINGS["model"]),
                               num_heads=SETTINGS["num_heads"],
                               num_kv_heads=SETTINGS["num_kv_heads"])
    eng = JaxEngine(JSC(model=mcfg, thinkv=JTK(**TK), max_seqs=SLOTS),
                    backend="reference", record_logits=True)
    ps = prompts()
    eng.submit(ps, max_new_tokens=MAX_NEW, priorities=PRIORITIES)
    done = eng.run()
    out = {"settings": np.array(json.dumps(SETTINGS)),
           "record": np.array(json.dumps(
               {"counters": {k: int(eng.metrics[k]) for k in COUNTERS},
                "audit": eng.audit_pool()}, default=int))}
    out.update({f"prompt_{i}": p for i, p in enumerate(ps)})
    for r in done:
        out[f"tokens_{r.arrival}"] = np.asarray(r.output, np.int64)
        out[f"logits_{r.arrival}"] = np.stack(
            eng.request_logits[r.arrival]).astype(np.float32)
    params = flatten(jax.tree.map(np.asarray, eng.params))
    out.update({TR.PARAM + k: v for k, v in params.items()})
    return out


def write_fixture(path: str = FIXTURE) -> None:
    np.savez(path, **jax_record())


@pytest.fixture(scope="module")
def stored():
    return TR.load(FIXTURE)


def test_fixture_equals_the_live_jax_record(stored):
    """Tokens, counters, audit, prompts and parameters exactly; logits to
    1e-6."""
    fresh = jax_record()
    with np.load(FIXTURE, allow_pickle=False) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in fresh:
            if k.startswith("logits_"):
                np.testing.assert_allclose(z[k], fresh[k], rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                assert z[k].dtype == fresh[k].dtype, k
                np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
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


if __name__ == "__main__":
    write_fixture()
    print(f"wrote {FIXTURE}: {os.path.getsize(FIXTURE)} bytes")
