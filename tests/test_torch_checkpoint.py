"""The port's checkpoints and fault tolerance (``repro_torch.checkpoint``,
``repro_torch.ft``, the trainer's auto-resume): the reference's cases of
``tests/test_fault_tolerance.py`` ported (round trip, a staged ``.tmp``
ignored, rotation, resume after an injected failure equal to the
uninterrupted run within 1e-4, the loss falling on a repeated batch, the
straggler monitor), and the on-disk protocol shared with the JAX package:
a tree of f32 and int32 arrays saved by ``repro.checkpoint.checkpointer``
restores through the port, and the reverse."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpointer as CJ  # noqa: E402
from repro_torch.checkpoint import checkpointer as CKPT  # noqa: E402
from repro_torch.config import OptimizerConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.ft.failures import (FailureInjector,  # noqa: E402
                                     InjectedFailure, StragglerMonitor)
from repro_torch.training.trainer import Trainer  # noqa: E402


def _cfg(tmp_path, steps=8, ckpt_every=3):
    m = get_smoke_config("yi-6b")
    return TrainConfig(
        model=m, optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                           decay_steps=steps),
        seq_len=16, global_batch=4, steps=steps,
        checkpoint_dir=str(tmp_path / "ckpt"),
        checkpoint_every=ckpt_every, keep_checkpoints=2)


def _data_fn_factory(cfg):
    def data_fn(start):
        it = lm_batches(cfg.model.vocab_size, cfg.global_batch, cfg.seq_len,
                        seed=7)
        for _ in range(start):
            next(it)
        return it
    return data_fn


def _tree(rng):
    return {"a": torch.from_numpy(rng.standard_normal((4, 8))
                                  .astype(np.float32)),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": [torch.ones(2, dtype=torch.bfloat16) * 1.5,
                        np.float32(2.5)]}}


def test_checkpoint_roundtrip(tmp_path):
    """Tensors (f32, int32, bf16 as its bits) and numpy leaves in nested
    dicts and lists round-trip exactly, with the manifest's extra."""
    tree = _tree(np.random.default_rng(0))
    CKPT.save(tmp_path, 3, tree, extra={"note": "x"})
    assert CKPT.available_steps(tmp_path) == [3]
    out = CKPT.restore(tmp_path, 3, tree)
    assert out["b"]["d"][0].dtype == torch.bfloat16
    for k in ("a", ("b", "c"), ("b", "d", 0)):
        x, y = tree, out
        for key in (k if isinstance(k, tuple) else (k,)):
            x, y = x[key], y[key]
        assert torch.equal(x, y), k
    assert float(out["b"]["d"][1]) == 2.5
    man = CKPT.manifest(tmp_path, 3)
    assert man["extra"]["note"] == "x"
    assert man["leaves"]["b/d/0"] == {"shape": [2], "dtype": "bfloat16"}
    assert man["leaves"]["b/c"]["dtype"] == "int32"


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    tree = {"a": torch.zeros(3)}
    CKPT.save(tmp_path, 1, tree)
    # a crashed save leaves a .tmp dir: must be invisible to readers
    (tmp_path / "step_00000002.tmp").mkdir()
    assert CKPT.latest_step(tmp_path) == 1


def test_rotation_keeps_newest(tmp_path):
    mgr = CKPT.CheckpointManager(tmp_path, keep=2, save_every=1)
    tree = {"a": torch.zeros(2)}
    for s in range(1, 6):
        mgr.maybe_save(s, tree, asynchronous=False)
    assert CKPT.available_steps(tmp_path) == [4, 5]


def test_async_saves_snapshot_before_returning(tmp_path):
    """``save_async`` copies the tree to the host before it returns: a
    tensor changed afterwards is saved as it was; the manager waits for
    its writers before rotating."""
    mgr = CKPT.CheckpointManager(tmp_path, keep=2, save_every=2)
    x = torch.zeros(4)
    for s in range(1, 7):
        mgr.maybe_save(s, {"x": x, "h": torch.ones(2, dtype=torch.bfloat16)},
                       asynchronous=True)
        x += 1
    mgr.wait()
    assert CKPT.available_steps(tmp_path) == [4, 6]
    out = CKPT.restore(tmp_path, 6, {"x": x, "h": torch.zeros(
        2, dtype=torch.bfloat16)})
    assert torch.equal(out["x"], torch.full((4,), 5.0))
    assert torch.equal(out["h"], torch.ones(2, dtype=torch.bfloat16))


def test_restore_checks_leaves_and_casts_to_the_target(tmp_path):
    """A missing leaf and a shape mismatch raise; a leaf restores in its
    target's dtype, on the asked device."""
    CKPT.save(tmp_path, 1, {"w": torch.arange(6.0).reshape(2, 3)})
    with pytest.raises(KeyError, match="missing leaf 'v'"):
        CKPT.restore(tmp_path, 1, {"v": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        CKPT.restore(tmp_path, 1, {"w": torch.zeros(3, 2)})
    out = CKPT.restore(tmp_path, 1, {"w": torch.zeros(2, 3,
                                                      dtype=torch.float64)},
                       device="cpu")
    assert out["w"].dtype == torch.float64
    assert torch.equal(out["w"], torch.arange(6.0).reshape(2, 3).double())


def test_a_jax_checkpoint_restores_through_the_port(tmp_path):
    """A tree of f32 and int32 arrays saved by the JAX package's
    checkpointer restores exactly through the port (and its manifest
    reads the same)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((4, 8)).astype(np.float32)
    tree = {"a": jnp.asarray(a), "b": {"c": jnp.arange(5, dtype=jnp.int32),
                                       "d": [jnp.float32(3.5)]}}
    CJ.save(tmp_path, 7, tree, extra={"loss": 1.25})
    assert CKPT.latest_step(tmp_path) == 7
    target = {"a": torch.zeros(4, 8),
              "b": {"c": torch.zeros(5, dtype=torch.int32),
                    "d": [torch.zeros(())]}}
    out = CKPT.restore(tmp_path, 7, target)
    np.testing.assert_array_equal(out["a"].numpy(), a)
    np.testing.assert_array_equal(out["b"]["c"].numpy(), np.arange(5))
    assert out["b"]["c"].dtype == torch.int32
    assert float(out["b"]["d"][0]) == 3.5
    assert CKPT.manifest(tmp_path, 7)["extra"] == {"loss": 1.25}


def test_a_port_checkpoint_restores_through_jax(tmp_path):
    """The reverse: the port's save of f32 and int32 tensors restores
    exactly through the JAX checkpointer."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    CKPT.save(tmp_path, 2, {"w": torch.from_numpy(a),
                            "n": {"i": torch.arange(4, dtype=torch.int32)}})
    target = {"w": jnp.zeros((3, 5), jnp.float32),
              "n": {"i": jnp.zeros(4, jnp.int32)}}
    assert CJ.latest_step(tmp_path) == 2
    out = CJ.restore(tmp_path, 2, target)
    np.testing.assert_array_equal(np.asarray(out["w"]), a)
    np.testing.assert_array_equal(np.asarray(out["n"]["i"]), np.arange(4))
    assert np.asarray(out["n"]["i"]).dtype == np.int32
    manifest = json.loads((tmp_path / "step_00000002" /
                           "MANIFEST.json").read_text())
    assert manifest["step"] == 2 and sorted(manifest["leaves"]) == \
        ["n/i", "w"]


def test_failure_injection_and_resume_equivalence(tmp_path):
    """Train 8 steps uninterrupted vs fail-at-5 + restart: identical final
    loss trajectory after the shared prefix (auto-resume correctness)."""
    cfg = _cfg(tmp_path, steps=8, ckpt_every=2)
    data_fn = _data_fn_factory(cfg)
    cfg_ref = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "ref"))
    ref = Trainer(cfg_ref, data_fn, device="cpu").run()

    inj = FailureInjector(fail_at_steps=(5,))
    with pytest.raises(InjectedFailure):
        Trainer(cfg, data_fn, failure_injector=inj, device="cpu").run()
    res = Trainer(cfg, data_fn, device="cpu").run()
    assert res.resumed_from == 4          # ckpt_every=2 -> step 4 saved
    assert res.final_step == 8
    assert len(res.losses) == 4
    np.testing.assert_allclose(res.losses[-1], ref.losses[-1], rtol=1e-4)
    np.testing.assert_allclose(res.losses, ref.losses[4:], rtol=1e-4)


def test_loss_decreases(tmp_path):
    cfg = _cfg(tmp_path, steps=12, ckpt_every=100)

    def data_fn(start):
        # single repeated batch -> guaranteed overfit signal
        it = lm_batches(cfg.model.vocab_size, 4, 16, seed=3)
        batch = next(it)
        while True:
            yield batch
    res = Trainer(cfg, lambda s: data_fn(s), device="cpu").run()
    assert res.losses[-1] < res.losses[0], res.losses


def test_checkpoint_holds_the_trainers_state(tmp_path):
    """A trainer's checkpoint holds every parameter and both moments by
    parameter name, in f32, and the loss of its step."""
    cfg = _cfg(tmp_path, steps=2, ckpt_every=2)
    Trainer(cfg, _data_fn_factory(cfg), device="cpu").run()
    man = CKPT.manifest(cfg.checkpoint_dir, 2)
    names = {k.split("/", 1)[1] for k in man["leaves"]
             if k.startswith("params/")}
    for group in ("opt_m", "opt_v"):
        assert {k.split("/", 1)[1] for k in man["leaves"]
                if k.startswith(group + "/")} == names
    assert {"embedding", "lm_head", "wq", "w_down"} <= names
    assert all(v["dtype"] == "float32" for v in man["leaves"].values())
    assert np.isfinite(man["extra"]["loss"])


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(window=16, threshold=2.0)
    for i in range(20):
        mon.end_step(i, elapsed=1.0)
    mon.end_step(20, elapsed=5.0)          # 5x median
    assert len(mon.events) == 1
    ev = mon.events[0]
    assert ev.ratio == pytest.approx(5.0)
    assert mon.summary()["stragglers"] == 1
