"""Atomic checkpoints with rotation and async saves (ports
``repro/checkpoint/checkpointer.py``: ``save``, ``save_async``,
``available_steps``, ``latest_step``, ``restore``, ``manifest``,
``CheckpointManager``).

The on-disk protocol is the reference's, so either package reads what
the other wrote:

    <dir>/step_000123/
        MANIFEST.json     # leaf shapes and dtypes, step, time, extra
        arrays.npz        # one entry per leaf, keyed by its tree path
    <dir>/step_000123.tmp/ ...   # staging; atomic rename on completion

A tree is nested dicts, lists and tuples of tensors or numpy arrays; a
leaf's key joins its path with "/" (dict keys, sequence indices), as the
reference's ``_leaf_key`` does.  bf16 leaves are stored as their uint16
bits (numpy has no bf16) under the manifest dtype ``bfloat16``.
``restore`` takes a target device.

Under a mesh (``shardings``: a tree of ``sharding.Sharding`` matching the
tree, each leaf a rank's block) ``save`` gathers every leaf to its
logical form, rank 0 writes it in the same format, and every rank waits
on a barrier; ``restore`` gives each rank its block of every stored leaf,
so a run saved at N ranks resumes at M (the elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.distributed import sharding as SH

MANIFEST = "MANIFEST.json"
_BF16 = "bfloat16"


def _flatten(tree: Any, prefix: str = "") -> List[tuple]:
    """[(key, leaf)] in the reference's order (dict keys sorted, as
    ``jax.tree_util`` flattens them)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _unflatten(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves, f"{prefix}{k}/")
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_unflatten(x, leaves, f"{prefix}{i}/")
               for i, x in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return leaves[prefix[:-1]]


def _to_numpy(leaf) -> tuple:
    """(numpy array as stored, the manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), _BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == _BF16:                  # an ml_dtypes array
        return arr.view(np.uint16), _BF16
    return arr, str(arr.dtype)


def _mesh_of(shardings: Any):
    return _flatten(shardings)[0][1].mesh


def _writes(shardings: Any) -> bool:
    """Does this rank write (rank 0 of a mesh, or no mesh)?"""
    return shardings is None or _mesh_of(shardings).rank == 0


def save(directory: Union[str, os.PathLike], step: int, tree: Any,
         extra: Optional[Dict] = None, shardings: Any = None) -> Path:
    """Atomically save a tree; returns the final checkpoint path.  With
    ``shardings`` every rank calls it: the leaves are gathered, rank 0
    writes, and every rank returns after a barrier."""
    if shardings is not None:
        sh = dict(_flatten(shardings))
        tree = _unflatten(tree, {k: SH.unshard(x, sh[k].spec, sh[k].mesh)
                                 for k, x in _flatten(tree)})
        path = _write(directory, step, tree, extra) if _writes(shardings) \
            else Path(directory) / f"step_{step:08d}"
        SH.barrier(_mesh_of(shardings))
        return path
    return _write(directory, step, tree, extra)


def _write(directory, step: int, tree: Any, extra: Optional[Dict]) -> Path:
    base = Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, meta = {}, {}
    for key, leaf in _flatten(tree):
        arr, dtype = _to_numpy(leaf)
        leaves[key] = arr
        meta[key] = {"shape": list(arr.shape), "dtype": dtype}
    np.savez(tmp / "arrays.npz", **leaves)
    manifest_ = {"step": step, "time": time.time(), "leaves": meta,
                 "extra": extra or {}}
    (tmp / MANIFEST).write_text(json.dumps(manifest_, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    return final


def save_async(directory, step: int, tree: Any,
               extra: Optional[Dict] = None) -> threading.Thread:
    """Snapshot the tree to host memory now, write it on a daemon thread
    (the caller goes on computing)."""
    host = {k: x.detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.array(x)
            for k, x in _flatten(tree)}
    t = threading.Thread(target=save, args=(directory, step,
                                            _unflatten(tree, host)),
                         kwargs={"extra": extra}, daemon=True)
    t.start()
    return t


def available_steps(directory) -> List[int]:
    base = Path(directory)
    if not base.exists():
        return []
    steps = []
    for p in sorted(base.glob("step_*")):
        if p.suffix == ".tmp" or not (p / MANIFEST).exists():
            continue
        try:
            steps.append(int(p.name.split("_")[1]))
        except ValueError:
            continue
    return sorted(steps)


def latest_step(directory) -> Optional[int]:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def _leaf_from(arr: np.ndarray, dtype: str, target, device) -> Any:
    """The stored array as the target leaf's kind, dtype and device."""
    if dtype == _BF16 or arr.dtype.kind == "V":
        t = torch.from_numpy(np.array(arr.view(np.uint16))) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(target, torch.Tensor):
        dev = target.device if device is None else torch.device(device)
        return t.to(device=dev, dtype=target.dtype)
    tgt = np.asarray(target)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().astype(tgt.dtype)


def restore(directory, step: int, target_tree: Any,
            device: Optional[Union[str, torch.device]] = None,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``target_tree``: each leaf in its
    target's dtype, as a tensor on ``device`` (the target's own device by
    default) where the target leaf is a tensor, else as a numpy array.
    With ``shardings`` (a matching tree of ``sharding.Sharding``) each
    target leaf is this rank's block, and each stored leaf is cut to it."""
    path = Path(directory) / f"step_{step:08d}"
    meta = json.loads((path / MANIFEST).read_text())["leaves"]
    sh = dict(_flatten(shardings)) if shardings is not None else {}
    out = {}
    with np.load(path / "arrays.npz") as data:
        for key, leaf in _flatten(target_tree):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            shape = tuple(arr.shape)
            if key in sh:
                shape = SH.block_shape(shape, sh[key].spec, sh[key].mesh)
            if shape != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs target {tuple(leaf.shape)}")
            t = _leaf_from(arr, meta.get(key, {}).get("dtype", ""), leaf,
                           "cpu" if key in sh else device)
            if key in sh:
                dev = leaf.device if device is None else torch.device(device)
                t = SH.shard_of(t, sh[key].spec, sh[key].mesh).to(
                    dev, copy=True).contiguous()
            out[key] = t
    return _unflatten(target_tree, out)


def manifest(directory, step: int) -> Dict:
    path = Path(directory) / f"step_{step:08d}" / MANIFEST
    return json.loads(path.read_text())


class CheckpointManager:
    """Rotation + auto-resume + async handles."""

    def __init__(self, directory, keep: int = 3, save_every: int = 50):
        self.dir = Path(directory)
        self.keep = keep
        self.save_every = save_every
        self._pending: List[threading.Thread] = []

    def maybe_save(self, step: int, tree, extra=None, *,
                   asynchronous: bool = True, shardings=None) -> bool:
        """Save every ``save_every`` steps and rotate.  With ``shardings``
        every rank calls it and the save is synchronous (see ``save``)."""
        if step % self.save_every != 0:
            return False
        if shardings is not None:
            save(self.dir, step, tree, extra, shardings=shardings)
            if _writes(shardings):
                self._rotate()
            return True
        if asynchronous:
            self._pending.append(save_async(self.dir, step, tree, extra))
        else:
            save(self.dir, step, tree, extra)
        self._rotate()
        return True

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()

    def _rotate(self):
        self.wait()
        steps = available_steps(self.dir)
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def resume(self, target_tree, device=None, shardings=None):
        """(step, tree) from the newest valid checkpoint, or (0, target)."""
        s = latest_step(self.dir)
        if s is None:
            return 0, target_tree
        return s, restore(self.dir, s, target_tree, device, shardings)
