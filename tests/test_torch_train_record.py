"""Replay a recorded run of the JAX trainer and hold the port's train step
to it.

The record (``tests/golden/torch_train_steps.npz``, written and held to
the live JAX trainer by ``tests/test_torch_train.py``) holds
``TRAIN_STEPS`` steps of the JAX train step (remat on, AdamW with a
warmup of 2 and a cosine decay over the run) on the smoke forms of
r1-llama-8b (``dense``) and mixtral-8x7b (``moe``), each from weights
drawn by :func:`numpy_tree` and ``lm_batches`` batches:

* ``settings``: JSON (the arch of each record, the optimizer, batch,
  sequence, steps, the weight and data seeds);
* ``<name>/loss``, ``<name>/grad_norm``, ``<name>/lr``: one per step (the
  grad norm before clipping, the learning rate of the step);
* ``<name>/digest/<param>``: per parameter (the port's names) the norm of
  its final value and the norm of its change over the run, both
  computed in f64 from the f32 weights.

Nothing here imports JAX, so ``chip_smoke.py`` (which puts ``tests/`` on
its path) and the card tests replay it with numpy and torch only.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Union

import numpy as np
import pytest
import torch

from repro_torch.config import OptimizerConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (param_paths, param_shapes,
                                 params_from_numpy)
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import factory
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import batch_to
from test_torch_steps_record import _draw

TRAIN_RECORDS = {"dense": "r1-llama-8b", "moe": "mixtral-8x7b"}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 16
SETTINGS = {"archs": TRAIN_RECORDS, "steps": TRAIN_STEPS,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "params_seed": 0,
            "data_seed": 7,
            "optimizer": {"lr": 1e-3, "warmup_steps": 2,
                          "decay_steps": TRAIN_STEPS}}
#: the record's per-step numbers and digests, held relative
TRAIN_RTOL = 1e-4

Device = Optional[Union[str, torch.device]]


def optimizer_config(settings: dict) -> OptimizerConfig:
    return OptimizerConfig(**settings["optimizer"])


def numpy_tree(cfg, seed: int) -> dict:
    """Weights for ``cfg`` from ``np.random.default_rng(seed)`` as the
    reference's parameter tree (f32 numpy leaves), drawn in the order of
    the port's parameter names (``test_torch_steps_record._draw``'s
    distributions)."""
    shapes = param_shapes(cfg)
    rng = np.random.default_rng(seed)
    tree: dict = {}
    paths = param_paths(cfg)
    for name in sorted(paths):
        path = paths[name]
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _draw(rng, path[-1], shapes[name])
    return tree


def batches(settings: dict, vocab: int):
    return lm_batches(vocab, settings["batch"], settings["seq"],
                      seed=settings["data_seed"])


def digest(final: Dict[str, np.ndarray], init: Dict[str, np.ndarray]
           ) -> Dict[str, np.ndarray]:
    """Per parameter: [|final|, |final - init|] (f64 norms, stored f32)."""
    out = {}
    for k, x in final.items():
        f, i = np.asarray(x, np.float64), np.asarray(init[k], np.float64)
        out[k] = np.array([np.linalg.norm(f), np.linalg.norm(f - i)],
                          np.float32)
    return out


def port_run(name: str, settings: dict = SETTINGS, device: Device = "cpu",
             microbatches: int = 1) -> dict:
    """The port's train step over the record's run: (record keys ->
    arrays), as the JAX writer produces them."""
    cfg = get_smoke_config(settings["archs"][name])
    tree = numpy_tree(cfg, settings["params_seed"])
    params = params_from_numpy(tree, cfg, device).requires_grad_(True)
    init = {k: p.detach().cpu().numpy().copy()
            for k, p in params.named_parameters()}
    opt = adamw_init(params)
    step = make_train_step(factory.build_model(cfg).loss, cfg,
                           optimizer_config(settings), remat=True,
                           microbatches=microbatches)
    data = batches(settings, cfg.vocab_size)
    got: Dict[str, List[float]] = {"loss": [], "grad_norm": [], "lr": []}
    for _ in range(settings["steps"]):
        params, opt, m = step(params, opt, batch_to(next(data), params
                                                     .embedding.device))
        for k in got:
            got[k].append(float(m[k]))
    out = {f"{name}/{k}": np.asarray(v, np.float32) for k, v in got.items()}
    final = {k: p.detach().cpu().numpy() for k, p in params.named_parameters()}
    out.update({f"{name}/digest/{k}": d
                for k, d in digest(final, init).items()})
    return out


def load(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        rec = {k: z[k] for k in z.files}
    rec["settings"] = json.loads(str(rec["settings"]))
    return rec


def mismatches(rec: dict, got: dict, rtol: float = TRAIN_RTOL) -> List[str]:
    """Every record key whose replayed value is not within ``rtol``
    (relative) of the record's, with its worst relative error."""
    bad = []
    for k, want in rec.items():
        if k == "settings":
            continue
        if k not in got:
            bad.append(f"{k}: not replayed")
            continue
        err = np.abs(got[k].astype(np.float64) - want) / np.maximum(
            np.abs(want.astype(np.float64)), 1e-30)
        if not err.max() <= rtol:
            bad.append(f"{k}: relative error {err.max():.3g}")
    return bad


def replay(rec: dict, device: Device = "cpu") -> dict:
    """Every record of the archive through the port's train step on
    ``device``: (record keys -> replayed arrays)."""
    out = {}
    for name in rec["settings"]["archs"]:
        out.update(port_run(name, rec["settings"], device))
    return out


@pytest.mark.parametrize("name", sorted(TRAIN_RECORDS))
def test_numpy_tree_has_every_parameter(name):
    """The drawn tree holds every port parameter at its shape, at its key
    path, from the seed alone."""
    cfg = get_smoke_config(TRAIN_RECORDS[name])
    a, b = numpy_tree(cfg, 0), numpy_tree(cfg, 0)
    model = params_from_numpy(a, cfg, "cpu")
    for k, p in model.named_parameters():
        node_a, node_b = a, b
        for key in param_paths(cfg)[k]:
            node_a, node_b = node_a[key], node_b[key]
        assert node_a.shape == tuple(p.shape), k
        np.testing.assert_array_equal(node_a, node_b)
