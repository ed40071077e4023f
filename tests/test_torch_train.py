"""Single-card training in the port (``repro_torch.models.losses``, the
families' ``loss_fn``, ``training/{optimizer,train_step,trainer}.py``,
``distributed/compression.py``, ``launch/train.py``) against the JAX
package on the CPU, on the smoke form of every family: r1-llama-8b
(dense), mixtral-8x7b (MoE), paligemma-3b (VLM, with image patches),
falcon-mamba-7b (SSM), zamba2-7b (hybrid) and whisper-medium
(encoder-decoder).  The JAX parameters come through ``convert.py``.

Bars:

* the loss within 1e-5 relative of ``jax.value_and_grad``'s; every
  gradient leaf within 1e-4 of that leaf's largest |g|; remat on and off
  bit-identical;
* one AdamW update on the same gradients: parameters, m and v within 1e-6;
  the schedule and the global norm within 1e-6 relative;
* a train step with ``microbatches=2``: the loss within 1e-5 relative,
  the new parameters, m and v within 1e-6;
* error-feedback compression: codes and scales bit-exact, the transported
  gradients and residuals equal;
* an 8-step ``Trainer`` run against the JAX ``Trainer`` from the same
  parameters and batches: losses within 1e-4 relative;
* the CLI: ``python -m repro_torch.launch.train --arch yi-6b --steps 20
  --device cpu`` from the JAX init prints the JAX CLI's first and last
  loss within 1e-4;
* the JAX train record (``tests/golden/torch_train_steps.npz``, see
  ``test_torch_train_record.py``): equal to a fresh run of the JAX train
  step (the records' archive check), and replayed by the port within
  1e-4 relative.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import OptimizerConfig as JOC  # noqa: E402
from repro.config import TrainConfig as JTC  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.synthetic import lm_batches as jax_batches  # noqa: E402
from repro.distributed import compression as CJ  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import losses as LJ  # noqa: E402
from repro.training import optimizer as OJ  # noqa: E402
from repro.training.train_step import make_train_step as jax_step  # noqa
from repro.training.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch.config import OptimizerConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 named_from_numpy, params_from_numpy)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.distributed import compression as CT  # noqa: E402
from repro_torch.models import factory as FT  # noqa: E402
from repro_torch.models import losses as LT  # noqa: E402
from repro_torch.training import optimizer as OT  # noqa: E402
from repro_torch.training.train_step import (make_train_step,  # noqa: E402
                                             value_and_grad)
from repro_torch.training.trainer import Trainer  # noqa: E402
import test_torch_train_record as TRR  # noqa: E402
from test_torch_trace_fixture import assert_archive_equals  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "golden",
                             "torch_train_steps.npz")
ARCHS = ("r1-llama-8b", "mixtral-8x7b", "paligemma-3b", "falcon-mamba-7b",
         "zamba2-7b", "whisper-medium")
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4            # of the leaf's largest |g|
UPDATE_ATOL = 1e-6
TRAINER_RTOL = 1e-4
B, S = 2, 16


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_params(arch: str, seed: int = 0) -> dict:
    return np_tree(jax_build(jax_smoke(arch)).init_params(seed))


def train_batch(cfg, seed: int = 1) -> dict:
    """A teacher-forced batch of ``cfg``'s family (numpy): tokens,
    targets, a loss mask with holes, image patches (VLM) or frames
    (encoder-decoder)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.num_image_tokens:
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_loss(arch: str, params_np: dict, batch: dict, remat: bool):
    cfg = get_smoke_config(arch)
    model = FT.build_model(cfg)
    params = params_from_numpy(params_np, cfg, "cpu").requires_grad_(True)
    return value_and_grad(lambda p, b: model.loss(p, b, cfg, remat=remat),
                          params, torch_batch(batch))


def jax_loss(arch: str, params_np: dict, batch: dict):
    jc = jax_smoke(arch)
    m = jax_build(jc)
    (loss, aux), g = jax.value_and_grad(
        lambda p, b: m.loss(p, b, jc, remat=True), has_aux=True)(
        jax.tree.map(jnp.asarray, params_np),
        jax.tree.map(jnp.asarray, batch))
    return float(loss), np_tree(aux), named_from_numpy(np_tree(g),
                                                       get_smoke_config(arch))


@pytest.fixture(scope="module", params=ARCHS)
def loss_case(request):
    """(arch, JAX params, batch, the JAX loss, aux and gradients)."""
    arch = request.param
    params, batch = jax_params(arch), train_batch(get_smoke_config(arch))
    return (arch, params, batch, *jax_loss(arch, params, batch))


def assert_grads_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(got[k].numpy() - w).max()
        assert err <= GRAD_REL * max(np.abs(w).max(), 1e-30), (k, err)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(loss_case, remat):
    """``build_model(cfg).loss`` and its gradients for every family
    against ``jax.value_and_grad`` of the JAX loss (remat on)."""
    arch, params, batch, jl, jaux, jg = loss_case
    (loss, aux), grads = port_loss(arch, params, batch, remat)
    assert abs(float(loss) - jl) <= LOSS_RTOL * abs(jl)
    assert abs(float(aux["nll"]) - float(jaux["nll"])) <= \
        LOSS_RTOL * abs(float(jaux["nll"]))
    np.testing.assert_allclose(float(aux["moe_aux"]),
                               float(jaux["moe_aux"]), rtol=LOSS_RTOL,
                               atol=1e-7)
    assert_grads_close(grads, jg)


def test_remat_on_and_off_give_the_same_values(loss_case):
    """Checkpointing the layer bodies (and the loss chunks) recomputes the
    same values: loss and every gradient bit-identical."""
    arch, params, batch = loss_case[:3]
    (l0, _), g0 = port_loss(arch, params, batch, False)
    (l1, _), g1 = port_loss(arch, params, batch, True)
    assert float(l0) == float(l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunked_xent_over_several_chunks_matches_jax(monkeypatch, softcap):
    """``chunked_softmax_xent`` with the chunk rule forced to 4 chunks of
    a 24-position sequence (the same ``_MAX_CHUNK_ELEMS`` in both
    packages), with a mask and a softcap: the loss within 1e-6 relative,
    its gradients in h and the head within 1e-6 absolute."""
    monkeypatch.setattr(LJ, "_MAX_CHUNK_ELEMS", 2 * 7 * 40)
    monkeypatch.setattr(LT, "_MAX_CHUNK_ELEMS", 2 * 7 * 40)
    assert LT.chunk_size(2, 24, 40) == 6
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 24, 8)).astype(np.float32)
    w = rng.standard_normal((8, 40)).astype(np.float32)
    tg = rng.integers(0, 40, (2, 24)).astype(np.int32)
    mk = (rng.random((2, 24)) > 0.3).astype(np.float32)
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda a, b: LJ.chunked_softmax_xent(a, b, tg, mk, softcap),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = LT.chunked_softmax_xent(th, tw, torch.from_numpy(tg),
                                 torch.from_numpy(mk), softcap)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=1e-6)


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_adamw_update_matches_jax(scale):
    """Two AdamW updates of r1-llama-8b smoke's weights on the same seeded
    gradients (``scale`` 10 engages the clip, 1e-3 does not): parameters,
    m and v within 1e-6, the step's norm and learning rate within 1e-6
    relative."""
    arch = "r1-llama-8b"
    cfg = get_smoke_config(arch)
    ocfg = dict(lr=1e-2, warmup_steps=1, decay_steps=5)
    params = jax_params(arch)
    rng = np.random.default_rng(3)
    tp = params_from_numpy(params, cfg, "cpu")
    jp = jax.tree.map(jnp.asarray, params)
    tstate, jstate = OT.adamw_init(tp), OJ.adamw_init(jp)
    for _ in range(2):
        g = jax.tree.map(lambda x: (scale * rng.standard_normal(x.shape))
                         .astype(np.float32), params)
        jp, jstate, jm = OJ.adamw_update(JOC(**ocfg), jax.tree.map(
            jnp.asarray, g), jstate, jp)
        tg = {k: torch.from_numpy(np.asarray(v))
              for k, v in named_from_numpy(g, cfg).items()}
        _, tstate, tm = OT.adamw_update(OptimizerConfig(**ocfg), tg, tstate,
                                        tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
        assert int(tstate.step) == int(jstate.step)
        for got, want in ((dict(tp.named_parameters()), np_tree(jp)),
                          (tstate.m, np_tree(jstate.m)),
                          (tstate.v, np_tree(jstate.v))):
            for k, w in named_from_numpy(want, cfg).items():
                np.testing.assert_allclose(got[k].detach().numpy(), w,
                                           rtol=0, atol=UPDATE_ATOL,
                                           err_msg=k)


def test_schedule_and_global_norm_match_jax():
    """``lr_schedule`` over warmup, decay and past it, ``global_norm`` of a
    tree and ``clip_by_global_norm`` (clipping and not), within 1e-6
    relative of the reference's."""
    cfg = dict(lr=3e-4, warmup_steps=10, decay_steps=50)
    for s in range(0, 60, 3):
        np.testing.assert_allclose(
            float(OT.lr_schedule(OptimizerConfig(**cfg), torch.tensor(s))),
            float(OJ.lr_schedule(JOC(**cfg), jnp.int32(s))), rtol=1e-6)
    rng = np.random.default_rng(4)
    tree = {k: rng.standard_normal((7, 5)).astype(np.float32)
            for k in "abc"}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    np.testing.assert_allclose(float(OT.global_norm(tt)),
                               float(OJ.global_norm(tree)), rtol=1e-6)
    for max_norm in (1.0, 100.0):             # clipped, and left as it is
        tc, tn = OT.clip_by_global_norm(tt, max_norm)
        jc, jn = OJ.clip_by_global_norm(tree, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in tree:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["r1-llama-8b", "mixtral-8x7b"])
def test_microbatched_train_step_matches_jax(arch):
    """One train step with ``microbatches=2`` (the splits' gradients summed
    in f32, then halved) against the JAX step's: the loss within 1e-5
    relative; the new parameters, m and v within 1e-6.  Adam's first
    update is lr g / (|g| + eps): at the default eps 1e-8 a gradient
    element at f32 noise level (cancelling sums) moves its parameter by
    up to ±lr whatever its rounding, so this step runs at eps 1e-3."""
    cfg = get_smoke_config(arch)
    ocfg = dict(lr=1e-3, warmup_steps=0, decay_steps=10, eps=1e-3)
    params = jax_params(arch)
    batch = train_batch(cfg, seed=2)
    del batch["loss_mask"]
    jstep = jax.jit(jax_step(jax_build(jax_smoke(arch)).loss, jax_smoke(arch),
                             JOC(**ocfg), microbatches=2))
    jp = jax.tree.map(jnp.asarray, params)
    jp, js, jm = jstep(jp, OJ.adamw_init(jp),
                       jax.tree.map(jnp.asarray, batch))
    tp = params_from_numpy(params, cfg, "cpu").requires_grad_(True)
    step = make_train_step(FT.build_model(cfg).loss, cfg,
                           OptimizerConfig(**ocfg), microbatches=2)
    tp, ts, tm = step(tp, OT.adamw_init(tp), torch_batch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    for got, want in ((dict(tp.named_parameters()), np_tree(jp)),
                      (ts.m, np_tree(js.m)), (ts.v, np_tree(js.v))):
        for k, w in named_from_numpy(want, cfg).items():
            np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                       atol=UPDATE_ATOL, err_msg=k)


def test_ef_transform_is_bit_exact():
    """``int8_quantize`` codes and scales bit-exact over a gradient dict
    with a 0-d leaf; two rounds of ``ef_transform`` (the residual fed
    back): transported gradients and residuals equal to the reference's."""
    rng = np.random.default_rng(6)
    grads = {"a": rng.standard_normal((6, 33)).astype(np.float32),
             "b": (1e-3 * rng.standard_normal((4, 3, 17))).astype(
                 np.float32),
             "c": np.float32(0.7) * np.ones((), np.float32)}
    for k in ("a", "b"):
        jc, js = CJ.int8_quantize(jnp.asarray(grads[k]))
        tc, ts = CT.int8_quantize(torch.from_numpy(grads[k]))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    tg = {k: torch.from_numpy(np.array(v)) for k, v in grads.items()}
    jst, tst = CJ.make_ef_state(jg), CT.make_ef_state(tg)
    for _ in range(2):
        jo, jst = CJ.ef_transform(jg, jst)
        to, tst = CT.ef_transform(tg, tst)
        for k in grads:
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))
            np.testing.assert_array_equal(tst[k].numpy(),
                                          np.asarray(jst[k]))


def _configs(arch, tmp_path, steps=8):
    kw = dict(seq_len=16, global_batch=4, steps=steps, checkpoint_every=4,
              keep_checkpoints=2)
    opt = dict(lr=1e-3, warmup_steps=2, decay_steps=steps)
    return (JTC(model=jax_smoke(arch), optimizer=JOC(**opt),
                checkpoint_dir=str(tmp_path / "jax"), **kw),
            TrainConfig(model=get_smoke_config(arch),
                        optimizer=OptimizerConfig(**opt),
                        checkpoint_dir=str(tmp_path / "port"), **kw))


def _data_fn(batches_fn, cfg):
    def data_fn(start):
        it = batches_fn(cfg.model.vocab_size, cfg.global_batch, cfg.seq_len,
                        seed=7)
        for _ in range(start):
            next(it)
        return it
    return data_fn


def start_from_jax(monkeypatch, arch):
    """Every port ``Trainer`` of the test starts from the JAX trainer's
    initial weights of ``arch`` (``_init_state`` patched)."""
    def init_state(self):
        params = params_from_numpy(jax_params(arch, self.cfg.seed),
                                   self.cfg.model, self.device)
        params.requires_grad_(True)
        return params, OT.adamw_init(params)
    monkeypatch.setattr(Trainer, "_init_state", init_state)


@pytest.mark.parametrize("arch", ["r1-llama-8b", "mixtral-8x7b",
                                  "falcon-mamba-7b"])
def test_trainer_matches_the_jax_trainer(arch, tmp_path, monkeypatch):
    """8 steps of the port's ``Trainer`` against the JAX ``Trainer`` from
    the same weights and batches (checkpoints every 4 steps): losses
    within 1e-4 relative, the same final step and straggler count."""
    jcfg, tcfg = _configs(arch, tmp_path)
    want = JaxTrainer(jcfg, _data_fn(jax_batches, jcfg)).run()
    start_from_jax(monkeypatch, arch)
    got = Trainer(tcfg, _data_fn(lm_batches, tcfg), device="cpu").run()
    np.testing.assert_allclose(got.losses, want.losses, rtol=TRAINER_RTOL)
    assert (got.final_step, got.resumed_from) == (want.final_step, 0)
    assert got.straggler_summary["steps"] == want.straggler_summary["steps"]


def test_train_cli_prints_the_jax_clis_losses(tmp_path, monkeypatch,
                                              capsys):
    """``python -m repro_torch.launch.train --arch yi-6b --steps 20
    --device cpu``, its trainer started from the JAX init, prints the JAX
    CLI's first and last loss within 1e-4."""
    from repro.launch import train as jax_cli
    from repro_torch.launch import train as cli
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "yi-6b", "--steps", "20", "--ckpt-dir",
        str(tmp_path / "jax")])
    jax_cli.main()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    start_from_jax(monkeypatch, "yi-6b")
    cli.main(["--arch", "yi-6b", "--steps", "20", "--device", "cpu",
              "--ckpt-dir", str(tmp_path / "port")])
    got = capsys.readouterr().out.strip().splitlines()[-1]

    def losses(line):
        head = line.split("; stragglers")[0]
        a, b = head.split("loss ")[1].split(" -> ")
        return head.split(";")[0], float(a), float(b)
    (gs, g0, g1), (ws, w0, w1) = losses(got), losses(want)
    assert gs == ws == "finished at step 20 (resumed from 0)"
    np.testing.assert_allclose([g0, g1], [w0, w1], rtol=1e-4)


def test_trainer_on_a_mesh_of_one_rank_is_the_trainer(tmp_path):
    """``Trainer(mesh=)`` is ported (item 16b; ``test_torch_train_mesh``
    holds 2 to 8 ranks): on a one-rank mesh its blocks are the whole
    parameters, and 8 steps give the unsharded trainer's losses exactly;
    a mesh of another shape than ``cfg.mesh`` is refused."""
    from repro_torch.config import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    _, tcfg = _configs("r1-llama-8b", tmp_path)
    want = Trainer(tcfg, _data_fn(lm_batches, tcfg), device="cpu").run()
    mesh = make_mesh(MeshConfig((1, 1), ("data", "model")), 0, "cpu")
    got = Trainer(dataclasses.replace(
        tcfg, checkpoint_dir=str(tmp_path / "mesh"), mesh=MeshConfig(
            (1, 1), ("data", "model"))),
        _data_fn(lm_batches, tcfg), mesh=mesh).run()
    assert got.losses == want.losses
    assert sorted(os.listdir(tmp_path / "mesh")) == \
        sorted(os.listdir(tmp_path / "port"))
    with pytest.raises(ValueError, match="cfg.mesh"):
        Trainer(tcfg, _data_fn(lm_batches, tcfg), mesh=mesh)


def test_training_entry_points_need_a_card_or_the_cpu(tmp_path):
    """Without a card ``init_params``, ``Trainer`` and the CLI raise
    RuntimeError unless ``cpu`` is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.launch import train as cli
    cfg = get_smoke_config("r1-llama-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FT.build_model(cfg).init_params(0)
    _, tcfg = _configs("r1-llama-8b", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tcfg, lambda s: iter(()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--arch", "r1-llama-8b", "--steps", "1"])


# ---------------------------------------------------------------------------
# the JAX train record
# ---------------------------------------------------------------------------

def jax_train_record() -> dict:
    """``TRAIN_STEPS`` steps of the JAX train step (what the JAX trainer
    jits) per record, from ``TRR.numpy_tree``'s weights and ``lm_batches``
    at the record's seed: the record's keys."""
    st = TRR.SETTINGS
    out = {"settings": np.asarray(json.dumps(st))}
    for name, arch in st["archs"].items():
        jc, tc = jax_smoke(arch), get_smoke_config(arch)
        tree = TRR.numpy_tree(tc, st["params_seed"])
        jp = jax.tree.map(jnp.asarray, tree)
        opt = OJ.adamw_init(jp)
        step = jax.jit(jax_step(jax_build(jc).loss, jc,
                                JOC(**st["optimizer"]), remat=True))
        data = jax_batches(jc.vocab_size, st["batch"], st["seq"],
                           seed=st["data_seed"])
        got = {"loss": [], "grad_norm": [], "lr": []}
        for _ in range(st["steps"]):
            jp, opt, m = step(jp, opt, jax.tree.map(jnp.asarray, next(data)))
            for k in got:
                got[k].append(float(m[k]))
        out.update({f"{name}/{k}": np.asarray(v, np.float32)
                    for k, v in got.items()})
        final = named_from_numpy(np_tree(jp), tc)
        out.update({f"{name}/digest/{k}": d for k, d in TRR.digest(
            final, named_from_numpy(tree, tc)).items()})
    return out


def write_train_fixture(path: str = TRAIN_FIXTURE) -> None:
    np.savez(path, **jax_train_record())


def test_train_record_equals_the_live_jax_trainer():
    """The stored record against a fresh run of the JAX train step (the
    records' archive check): the settings exactly, every number within
    its bar; under 1 MB."""
    assert os.path.getsize(TRAIN_FIXTURE) < 1 << 20
    assert_archive_equals(TRAIN_FIXTURE, jax_train_record())


def test_port_replays_the_train_record_on_the_cpu():
    """The port's train step over the record's runs: losses, grad norms,
    learning rates and the digests within 1e-4 relative."""
    rec = TRR.load(TRAIN_FIXTURE)
    assert TRR.mismatches(rec, TRR.replay(rec, "cpu")) == []


def test_two_microbatches_replay_the_dense_record():
    """The dense record replayed in two microbatches of 2 rows each (the
    splits' mean gradient is the batch's): within 1e-4 relative.  The MoE
    record is not: each microbatch routes its own tokens, in other groups
    and at another capacity, so its loss is another function."""
    rec = TRR.load(TRAIN_FIXTURE)
    got = TRR.port_run("dense", rec["settings"], "cpu", microbatches=2)
    want = {k: v for k, v in rec.items() if k.startswith("dense/")}
    assert TRR.mismatches({"settings": None, **want}, got) == []


def test_adamw_state_crosses_from_jax():
    """``adamw_state_from_numpy``: the JAX state's step and moments by the
    port's parameter names, f32, on the asked device."""
    arch = "mixtral-8x7b"
    cfg = get_smoke_config(arch)
    jp = jax.tree.map(jnp.asarray, jax_params(arch))
    st = OJ.adamw_init(jp)
    st = OJ.AdamWState(step=jnp.int32(3),
                       m=jax.tree.map(lambda x: x + 1, st.m),
                       v=jax.tree.map(lambda x: x + 2, st.v))
    ts = adamw_state_from_numpy(np.asarray(st.step), np_tree(st.m),
                                np_tree(st.v), cfg, "cpu")
    assert int(ts.step) == 3 and ts.step.dtype == torch.int32
    names = dict(params_from_numpy(jax_params(arch), cfg,
                                   "cpu").named_parameters())
    assert sorted(ts.m) == sorted(ts.v) == sorted(names)
    for k in names:
        assert ts.m[k].dtype == torch.float32
        assert torch.all(ts.m[k] == 1) and torch.all(ts.v[k] == 2), k


if __name__ == "__main__":
    write_train_fixture()
