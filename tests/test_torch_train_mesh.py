"""Sharded training in the port (``training/train_step.py`` under a mesh,
``Trainer(mesh=)``, the checkpoints' gather and elastic restore, the train
CLI's ``--mesh-shape``) on gloo CPU ranks.

No live sharded JAX train step can be the reference: on this tree's jax
0.9.0 the reference's own sharded step raises (ROADMAP queue 3).  So the
port is held to the live single-device JAX train step of the same
weights and batch, at the reference's bars for a sharded step
(``tests/test_distributed.py:59-92``): the loss within rtol 2e-5, every
parameter within rtol 2e-4 / atol 2e-5.  Both sides run step 1 at the full
learning rate (warmup 1), so AdamW moves each parameter by about 3e-4,
over the bar; as that first update is about ``lr * sign(g)`` and does not
see the gradient's scale, the gradient norm is held too, within rtol
1e-5.  One step of each case runs at 1
rank (in this process), 2 (data 2), 2x2 and 2x4 (data x model) ranks, each
mesh shape one spawn shared by its cases:

* yi-6b and r1-llama-8b's smoke forms (r1 with a loss mask with holes) at
  every shape, and mixtral-8x7b (its experts split over ``model`` at 2x4)
  there too;
* mixtral-8x7b, falcon-mamba-7b, zamba2-7b, paligemma-3b (image patches)
  and whisper-medium (frames) at 2 ranks;
* qwen2-7b (non-zero qkv biases), paligemma-3b (image patches, the
  tied head; 1 kv head), falcon-mamba-7b, zamba2-7b and whisper-medium at
  2x2 and 2x4 (at 2x4 falcon-mamba's ``in_proj`` block holds two x_in
  blocks);
* two microbatches (mixtral: its MoE groups span the ranks' blocks), an
  error-feedback ``grad_transform`` (yi-6b), mixtral with 3 experts
  (they do not divide over ``model``: its experts split over d_ff),
  paligemma with 2 kv heads (its image prefix under the head split),
  zamba2 with one group of B and C (every rank reads it) and whisper with
  a vocabulary of 255 (its embedding stays whole over ``model``, as
  whisper-medium's 51,865 at |model| 2) at 2x2;
* at 2x4 the split mixers' other branches (``VARIANTS``): zamba2 with
  heads of 64 that a block of d_inner cuts (``in_proj`` whole), with
  ``in_proj`` and ``conv_w`` whole, and zamba2 and falcon-mamba with a
  d_inner of 66 that |model| 4 does not divide (the split products'
  outputs gathered, every rank running every channel).

Every family splits its compute over ``model`` (its ``loss_fn`` over a
rank's ``lm.Weights``): at 2x2 the attention heads (2 kv heads over 2
ranks, with their biases), the MLP, the experts, Mamba's d_inner (its
``in_proj`` output and Mamba-2's conv output regrouped over ``model``)
and the vocabulary (the tied head's too) run split, at 2x4, and for
paligemma's 1 kv head at 2x2, the attention gathers its projections (the
kv heads cannot split); no parameter is gathered over ``model`` in
either, and every rank's collective bytes by (kind, axis, what) equal
the dry run's analytic count (``launch.dryrun.train_traffic``) at every
shape.

Every rank holds only its ``param_specs`` blocks of the parameters and of
AdamW's moments between steps: the full-size model the blocks were cut
from holds no storage for a split parameter then.  Also: ``Trainer(mesh=)``
saved at N ranks resumes at M (2->1, 1->2, 2->4) and ends on the
uninterrupted run's losses within 1e-4 relative (the reference's resume
bar); the CLI's ``--mesh-shape 2,2`` prints the one-rank CLI's line;
``shard_of`` / ``unshard`` round-trip exactly over a (pod, data, model)
mesh; the train step's collectives stay inside the train whitelist,
which the serve whitelist refuses.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import OptimizerConfig as JOC  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.distributed import compression as CJ  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training.optimizer import adamw_init as jax_adamw_init  # noqa
from repro.training.train_step import make_train_step as jax_step  # noqa
from repro_torch.analysis import audit_train_step  # noqa: E402
from repro_torch.analysis import contracts as C  # noqa: E402
from repro_torch.config import (MeshConfig, OptimizerConfig,  # noqa: E402
                                TrainConfig)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import named_from_numpy, params_from_numpy  # noqa
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.distributed import compression as CT  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import factory as FT  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402
from repro_torch.training.train_step import (make_train_step,  # noqa: E402
                                             shard_params)
from repro_torch.training.trainer import Trainer  # noqa: E402

LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
GNORM_RTOL = 1e-5
OPT = {"warmup_steps": 1}            # step 1 at the full learning rate
RESUME_RTOL = 1e-4
B, S = 8, 16
# case -> (arch, microbatches, EF grad_transform, loss mask); a case's
# batch seed is its place here
CASES = {"mamba": ("falcon-mamba-7b", 1, False, False),
         "mixtral": ("mixtral-8x7b", 1, False, False),
         "mixtral_mb2": ("mixtral-8x7b", 2, False, False),
         "mixtral_tpf": ("mixtral-8x7b", 1, False, False),
         "pali": ("paligemma-3b", 1, False, False),
         "r1": ("r1-llama-8b", 1, False, True),
         "whisper": ("whisper-medium", 1, False, False),
         "yi": ("yi-6b", 1, False, False),
         "yi_ef": ("yi-6b", 1, True, False),
         "zamba": ("zamba2-7b", 1, False, False),
         "qwen2": ("qwen2-7b", 1, False, False),
         "pali_kv2": ("paligemma-3b", 1, False, False),
         "zamba_g1": ("zamba2-7b", 1, False, False),
         "whisper_v255": ("whisper-medium", 1, False, False),
         "zamba_cut": ("zamba2-7b", 1, False, False),
         "zamba_conv": ("zamba2-7b", 1, False, False),
         "zamba_w": ("zamba2-7b", 1, False, False),
         "mamba_w": ("falcon-mamba-7b", 1, False, False)}
# case -> its change of the smoke config (either package): experts that
# do not divide |model|, kv heads that split over |model| 2, one group of
# B and C that every rank reads, a vocabulary that does not split; and at
# |model| 4 the split mixers' other branches: heads that a block of d_inner
# cuts with ``in_proj`` whole, ``in_proj`` and ``conv_w`` whole, and
# d_inner whole (66 over 4) with ``in_proj`` (and Mamba-2's conv) split
_ssm = lambda c, **kw: dataclasses.replace(  # noqa: E731
    c, ssm=dataclasses.replace(c.ssm, **kw))
VARIANTS = {"mixtral_tpf": lambda c: dataclasses.replace(
                c, moe=dataclasses.replace(c.moe, num_experts=3)),
            "pali_kv2": lambda c: dataclasses.replace(c, num_kv_heads=2),
            "zamba_g1": lambda c: dataclasses.replace(
                c, ssm=dataclasses.replace(c.ssm, ngroups=1)),
            "whisper_v255": lambda c: dataclasses.replace(c, vocab_size=255),
            "zamba_cut": lambda c: _ssm(c, head_dim=64, ngroups=1),
            "zamba_conv": lambda c: _ssm(c, ngroups=1, state_size=17),
            "zamba_w": lambda c: _ssm(dataclasses.replace(c, d_model=66),
                                      expand=1, head_dim=11, ngroups=3,
                                      state_size=15),
            "mamba_w": lambda c: _ssm(dataclasses.replace(c, d_model=66),
                                      expand=1)}
BIAS_SCALE = 0.1                      # qkv biases drawn non-zero
SHAPES = {"1": "data=1,model=1", "2": "data=2,model=1",
          "2x2": "data=2,model=2", "2x4": "data=2,model=4"}
AT = {"1": ("yi", "r1", "mixtral"),
      "2": ("yi", "r1", "mixtral", "mamba", "zamba", "pali", "whisper"),
      "2x2": ("yi", "r1", "mixtral", "mixtral_mb2", "yi_ef",
              "mixtral_tpf", "qwen2", "pali", "pali_kv2", "mamba", "zamba",
              "whisper", "zamba_g1", "whisper_v255"),
      "2x4": ("yi", "r1", "mixtral", "qwen2", "pali", "mamba", "zamba",
              "whisper", "zamba_cut", "zamba_conv", "zamba_w", "mamba_w")}
CELLS = [(shape, case) for shape, cases in AT.items() for case in cases]


def case_batch(cfg, seed: int, mask: bool) -> dict:
    """A global batch of B x S (numpy): tokens, targets, a loss mask with
    holes, image patches (VLM) or frames (encoder-decoder)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if mask:
        batch["loss_mask"] = (rng.random((B, S)) > 0.3).astype(np.float32)
    if cfg.num_image_tokens:
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def variant(cfg, name: str):
    """``cfg`` with case ``name``'s change (either package)."""
    return VARIANTS[name](cfg) if name in VARIANTS else cfg


def jax_case(name: str) -> dict:
    """One live single-device JAX train step of ``name``: its weights and
    batch (numpy) and its loss and new parameters by port name."""
    arch, mb, ef, mask = CASES[name]
    cfg = variant(jax_smoke(arch), name)
    model = jax_build(cfg)
    params = model.init_params(0)
    if cfg.qkv_bias:
        rng = np.random.default_rng(100)
        attn = params["layers"]["attn"]
        for b in ("bq", "bk", "bv"):
            attn[b] = jax.numpy.asarray(
                BIAS_SCALE * rng.standard_normal(attn[b].shape), "float32")
    batch = case_batch(cfg, list(CASES).index(name), mask)
    gt = (lambda g: CJ.ef_transform(g, CJ.make_ef_state(g))[0]) if ef \
        else None
    step = jax.jit(jax_step(model.loss, cfg, JOC(**OPT), remat=True,
                            microbatches=mb, grad_transform=gt))
    new, _, metrics = step(params, jax_adamw_init(params),
                           jax.tree.map(jax.numpy.asarray, batch))
    pcfg = variant(get_smoke_config(arch), name)
    return {"params": jax.tree.map(np.asarray, params), "batch": batch,
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "new": named_from_numpy(jax.tree.map(np.asarray, new), pcfg)}


@pytest.fixture(scope="module")
def jax_steps():
    return {name: jax_case(name) for name in CASES}


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def step_cell(mesh, name: str, ref: dict) -> dict:
    """One sharded step of case ``name`` from the JAX weights on this rank:
    the loss, the gradient norm, the gathered parameters, whether the
    blocks of the parameters and moments are the spec's, and the bytes the
    split parameters of the model the blocks were cut from hold after the
    step."""
    arch, mb, ef, _ = CASES[name]
    cfg = variant(get_smoke_config(arch), name)
    model = FT.build_model(cfg)
    full = params_from_numpy(ref["params"], cfg, "cpu").requires_grad_(True)
    sp = shard_params(full, mesh)
    opt = adamw_init(sp.blocks)
    gt = (lambda g: CT.ef_transform(g, CT.make_ef_state(g))[0]) if ef \
        else None
    step = make_train_step(model.loss, cfg, OptimizerConfig(**OPT),
                           remat=True, microbatches=mb, grad_transform=gt,
                           mesh=mesh, split=model.split)
    SH.reset_collectives()
    sp, opt, metrics = step(sp, opt, _tensors(ref["batch"]))
    traffic = dict(SH.TRAFFIC)
    want = {k: SH.block_shape(p.shape, sp.specs[k], mesh)
            for k, p in full.named_parameters()}
    held = all(tuple(t[k].shape) == want[k] for t in (sp.blocks, opt.m,
                                                       opt.v) for k in want)
    params = {k: SH.unshard(b, sp.specs[k], mesh).detach().numpy()
              for k, b in sp.blocks.items()}      # every rank gathers
    split = [p for k, p in full.named_parameters()
             if sp.blocks[k].shape != p.shape]
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "held_blocks": held,
            "block_elems": sum(b.numel() for b in sp.blocks.values()),
            "split_model_bytes": sum(p.untyped_storage().nbytes()
                                     for p in split),
            "traffic": traffic,
            "params": params if mesh.rank == 0 else None}


def data_fn(start: int):
    it = lm_batches(get_smoke_config("yi-6b").vocab_size, 4, 16, seed=7)
    for _ in range(start):
        next(it)
    return it


def trainer_cfg(ckpt: str, steps: int, mesh=None) -> TrainConfig:
    layout = MeshConfig(mesh.shape, mesh.axis_names) if mesh is not None \
        else MeshConfig()
    return TrainConfig(model=get_smoke_config("yi-6b"), mesh=layout,
                       optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                 decay_steps=6),
                       seq_len=16, global_batch=4, steps=steps,
                       checkpoint_every=3, keep_checkpoints=2,
                       checkpoint_dir=ckpt)


def train(mesh, ckpt: str, steps: int):
    return Trainer(trainer_cfg(ckpt, steps, mesh), data_fn, mesh=mesh).run()


def roundtrip_cell(mesh8) -> bool:
    """Every spec over a (pod, data, model) mesh of the 8 ranks: the
    blocks gather back to the whole tensor, bit for bit."""
    mesh = M.make_mesh(MeshConfig((2, 2, 2), ("pod", "data", "model")),
                       mesh8.rank, "cpu")
    x = torch.arange(8 * 12 * 4, dtype=torch.float32).reshape(8, 12, 4)
    specs = [(("pod", "data"), "model"), ("model", ("pod", "data")),
             (None, ("pod", "data"), "model"), ("data",), ("pod",),
             (None, None, "model"), (("pod", "data"), None, None)]
    return all(torch.equal(SH.unshard(SH.shard_of(x, sp, mesh).clone(), sp,
                                      mesh), x) for sp in specs)


def mesh_rank(mesh, shape: str, refs: dict, dirs: dict) -> dict:
    """Everything one spawn of ``shape`` runs on this rank."""
    out = {"cells": {name: step_cell(mesh, name, refs[name])
                     for name in AT[shape]}}
    if shape == "2":
        out["resume_1_to_2"] = train(mesh, dirs["from1"], 6).losses
        out["saved_2"] = train(mesh, dirs["to1"], 3).losses
        out["saved_2b"] = train(mesh, dirs["to4"], 3).losses
    if shape == "2x2":
        out["resume_2_to_4"] = train(mesh, dirs["to4"], 6).losses
        audit = audit_train_step("yi-6b", "cpu", mesh=mesh)
        out["audit"] = {"ok": audit.ok,
                        "launches": audit.census.launches,
                        "kinds": sorted({(c.name, c.dtype, c.reduces)
                                         for c in audit.census.collectives}),
                        "axes": sorted({(c.name, c.dtype, c.reduces, c.axis)
                                        for c in audit.census.collectives}),
                        "serve_violations": len(
                            C.serve_collective_rule().check(
                                "train_step", audit.census.collectives))}
    if shape == "2x4":
        out["roundtrip"] = roundtrip_cell(mesh)
    return out


@pytest.fixture(scope="module")
def runs(jax_steps, tmp_path_factory):
    """{shape: every rank's results}, the trainer runs in the order the
    elastic cases need: the uninterrupted run and a 1-rank save here, the
    2-rank spawn resuming it and saving twice, the 2x2 spawn resuming one,
    then a 1-rank resume of the other here."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    dirs = {k: str(tmp / k) for k in ("ref", "from1", "to1", "to4")}
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = M.make_mesh(MeshConfig((1, 1), ("data", "model")), 0, "cpu")
        out = {"1": [mesh_rank(one, "1", jax_steps, dirs)],
               "uninterrupted": Trainer(trainer_cfg(dirs["ref"], 6),
                                        data_fn, device="cpu").run().losses,
               "saved_1": train(one, dirs["from1"], 3).losses}
        for shape in ("2", "2x2", "2x4"):
            out[shape] = M.run_ranks(mesh_rank, SHAPES[shape], "cpu", shape,
                                     jax_steps, dirs, timeout=300, threads=1)
        out["resume_2_to_1"] = train(one, dirs["to1"], 6).losses
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("shape,case", CELLS,
                         ids=[f"{s}-{c}" for s, c in CELLS])
def test_sharded_step_matches_the_live_jax_step(jax_steps, runs, shape,
                                                case):
    """The loss and gradient norm on every rank and rank 0's gathered
    parameters against the single-device JAX step, at the reference's
    bars."""
    want = jax_steps[case]
    got = runs[shape]
    for r in got:
        np.testing.assert_allclose(r["cells"][case]["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["cells"][case]["grad_norm"],
                                   want["grad_norm"], rtol=GNORM_RTOL)
    params = got[0]["cells"][case]["params"]
    assert sorted(params) == sorted(want["new"])
    for k, w in want["new"].items():
        np.testing.assert_allclose(params[k], np.asarray(w, np.float32),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{shape} {case} {k}")


@pytest.mark.parametrize("shape", [s for s in AT if s != "1"])
def test_every_rank_holds_only_its_blocks(runs, shape):
    """Parameters, m and v are the spec's blocks on every rank, the
    model's split parameters hold no storage between steps, and the ranks
    hold fewer elements than the whole model where the mesh splits a
    dim."""
    for name in AT[shape]:
        cells = [r["cells"][name] for r in runs[shape]]
        assert all(c["held_blocks"] for c in cells), name
        assert all(c["split_model_bytes"] == 0 for c in cells), name
        whole = sum(np.asarray(p).size
                    for p in runs[shape][0]["cells"][name]["params"].values())
        assert all(c["block_elems"] < whole for c in cells), name


@pytest.mark.parametrize("what,saved,n", [
    ("resume_1_to_2", "saved_1", 2), ("resume_2_to_1", "saved_2", 1),
    ("resume_2_to_4", "saved_2b", 4)])
def test_trainer_resumes_across_rank_counts(runs, what, saved, n):
    """A run saved at step 3 on one rank count resumes on another and
    ends on the uninterrupted run's losses."""
    ref = runs["uninterrupted"]
    first = runs[saved] if saved == "saved_1" else runs["2"][0][saved]
    np.testing.assert_allclose(first, ref[:3], rtol=RESUME_RTOL)
    got = runs[what] if n == 1 else \
        runs["2" if n == 2 else "2x2"][0][what]
    assert len(got) == 3
    np.testing.assert_allclose(got, ref[3:], rtol=RESUME_RTOL)


def test_train_step_collectives_stay_in_the_train_whitelist(runs):
    """The 2x2 train step's census: no kernel, every collective inside
    the train whitelist (float sums included), which the serve whitelist
    refuses."""
    for r in runs["2x2"]:
        a = r["audit"]
        assert a["ok"], a
        assert not a["launches"]
        assert ("all_reduce", "float32", True) in a["kinds"]
        assert ("all_gather", "float32", False) in a["kinds"]
        assert a["serve_violations"] > 0
        # the split's float sums over model, the dp gradient's
        # reduce-scatter, and no parameter gathered over model
        assert ("all_reduce", "float32", True, "model") in a["axes"]
        assert ("reduce_scatter", "float32", True, "dp") in a["axes"]
        assert ("all_gather", "float32", False, "model") not in a["axes"]


def test_train_rule_allows_float_sums_over_dp_and_model_only():
    """The train rule's float reductions: over the dp axes and over
    ``model``, nowhere else; the serve rule allows none."""
    from repro_torch.analysis.census import CollectiveUse
    rule, serve = C.train_collective_rule(), C.serve_collective_rule()
    for axis in ("dp", "model"):
        for kind in ("all_reduce", "reduce_scatter"):
            use = CollectiveUse(kind, "float32", True, "", axis)
            assert rule.check("train_step", [use]) == []
            assert serve.check("train_step", [use])
    assert rule.check("train_step", [CollectiveUse(
        "all_reduce", "float32", True, "", "pod")])


@pytest.mark.parametrize("shape", ["2x2", "2x4"])
def test_no_parameter_is_gathered_over_model(runs, shape):
    """At 2x2 and 2x4 the split families gather no parameter over
    ``model`` (the per-layer gathers run over dp only), and their sums
    over ``model`` are counted."""
    for r in runs[shape]:
        for name in AT[shape]:
            t = r["cells"][name]["traffic"]
            assert not any(k[1] == "model" and k[2] == "param" for k in t), \
                (name, t)
            assert t.get(("all_reduce", "model", "act"), 0) > 0, name
            assert t.get(("all_gather", "dp", "param"), 0) > 0, name


@pytest.mark.parametrize("shape,case", [c for c in CELLS if c[0] != "1"],
                         ids=[f"{s}-{c}" for s, c in CELLS if s != "1"])
def test_dry_run_counts_the_step_traffic(runs, shape, case):
    """Every rank's collective bytes in the step, by (kind, axis, what),
    equal the dry run's analytic count for the same cell."""
    from repro_torch.launch.dryrun import train_traffic
    arch, mb, ef, mask = CASES[case]
    cfg = variant(get_smoke_config(arch), case)
    sizes = [int(x.split("=")[1]) for x in SHAPES[shape].split(",")]
    want = train_traffic(cfg, MeshConfig(tuple(sizes), ("data", "model")),
                         B, S, microbatches=mb, loss_mask=mask,
                         grad_transform=ef)
    for r in runs[shape]:
        assert r["cells"][case]["traffic"] == want, (case, r["cells"][case][
            "traffic"], want)


def test_blocks_round_trip_over_a_pod_mesh(runs):
    assert all(r["roundtrip"] for r in runs["2x4"])


def test_cli_mesh_shape_prints_the_one_rank_line(tmp_path, capsys):
    """``--mesh-shape 2,2`` (axes data, model) trains on 4 gloo ranks and
    prints the one-rank CLI's line, losses within 1e-4 relative."""
    def line(extra, ckpt):
        cli.main(["--arch", "yi-6b", "--steps", "8", "--ckpt-every", "4",
                  "--device", "cpu", "--ckpt-dir", str(tmp_path / ckpt),
                  *extra])
        head = capsys.readouterr().out.strip().splitlines()[-1] \
            .split("; stragglers")[0]
        a, b = head.split("loss ")[1].split(" -> ")
        return head.split(";")[0], float(a), float(b)
    (ws, w0, w1), (gs, g0, g1) = line([], "one"), \
        line(["--mesh-shape", "2,2"], "mesh")
    assert gs == ws == "finished at step 8 (resumed from 0)"
    np.testing.assert_allclose([g0, g1], [w0, w1], rtol=RESUME_RTOL)
    assert sorted(os.listdir(tmp_path / "mesh")) == \
        sorted(os.listdir(tmp_path / "one"))


def test_production_mesh_needs_its_rank_count():
    """``make_production_mesh`` refuses a group of another size, naming
    the size it needs; ``mesh_config`` is the reference's layout."""
    from repro.launch.mesh import mesh_config as jax_mesh_config
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=str(n)):
            M.make_production_mesh(multi_pod=multi, device="cpu")
        want = jax_mesh_config(multi_pod=multi)
        got = M.mesh_config(multi_pod=multi)
        assert (got.shape, got.axis_names) == (want.shape, want.axis_names)
        assert (got.multi_pod, got.num_devices, got.dp_degree) == \
            (want.multi_pod, want.num_devices, want.dp_degree)


def test_train_config_carries_the_reference_mesh():
    from repro.config import TrainConfig as JTC
    cfg = get_smoke_config("yi-6b")
    got = TrainConfig(model=cfg).mesh
    want = JTC(model=jax_smoke("yi-6b")).mesh
    assert (got.shape, got.axis_names) == (want.shape, want.axis_names)
    assert dataclasses.replace(TrainConfig(model=cfg), mesh=MeshConfig(
        (2, 4), ("data", "model"))).mesh.axis_size("model") == 4


def test_serving_still_refuses_a_data_axis():
    with pytest.raises(ValueError, match="model"):
        M.serve_ranks("data=2,model=2")
    assert M.parse_mesh_spec("data=2,model=4").num_devices == 8


def test_a_sharded_step_needs_the_split():
    """Every family's model bundle carries ``lm.Weights`` as its split;
    there is no whole-gather path: a mesh without ``split`` raises."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    assert all(FT.build_model(get_smoke_config(a)).split is lm.Weights
               for a in ARCHS)
    cfg = get_smoke_config("falcon-mamba-7b")
    one = M.make_mesh(MeshConfig((1, 1), ("data", "model")), 0, "cpu")
    with pytest.raises(ValueError, match="split"):
        make_train_step(FT.build_model(cfg).loss, cfg, OptimizerConfig(),
                        mesh=one)
