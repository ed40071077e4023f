"""Tensor-parallel serving over kv heads: the serve half of
``repro/distributed/sharding.py`` (its lines 215-290).

The serving engine shards the KV-HEAD axis of its paged planes
``[L, NP, BS, H, ...]`` (axis 3) and of its TBQ buffers ``[R, L, G, H, D]``
(axis 3; one request's ``[L, G, H, D]``: axis 2) over the mesh's ``model``
axis.  Attention is parallel over heads, so a rank's per-head work is a
slice of the one-rank run's, and only the attention OUTPUT rejoins the
whole residual stream (an all-gather: pure data movement).  Everything
head-agnostic stays whole and identical on every rank: the weights, block
tables, refcounts, slot and segment metadata, the scheduler and the prefix
cache, so every admission, preemption and COW decision is the same on
every rank.

The complete cross-rank communication of the engine is the two helpers
below, and they are the only places the port calls a ``torch.distributed``
collective (``tests/test_torch_imports.py`` holds this for the package and
``chip_smoke.py``; ``launch/mesh.py`` only sets the group up):

* :func:`gather_heads` — the tiled all-gather of a head axis, exact at any
  dtype;
* :func:`any_shard` — the OR of per-rank boolean masks, as an int32 sum
  (integer sums are exact in any order).

No float reduction crosses ranks: a float sum depends on its order, which
would break the bit-identity across rank counts that the engine is held
to.  Each helper counts its calls into :data:`COLLECTIVES` by
``(kind, dtype)``, the way ``kernels/ops.py`` counts ``LAUNCHES``.

The train half (parameter specs, FSDP axes, batch specs, ``constrain``)
belongs to ROADMAP queue 1 item 16b.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

SERVE_HEAD_AXIS = "model"          # mesh axis the kv-head dim shards over
PLANE_HEAD_DIM = 3                 # [L, NP, BS, H, ...]
BUF_HEAD_DIM = 2                   # one request's TBQ buffer [L, G, H, D]

# The engine's collective contract (the reference's names: its integer
# ``psum`` is an ``all_reduce`` here).  ``analysis.contracts`` turns it into
# the CollectiveRule every engine entry point is audited against.
SERVE_MOVEMENT_COLLECTIVES = ("all_gather",)
SERVE_INTEGER_REDUCTIONS = ("all_reduce",)
SERVE_FLOAT_REDUCTIONS: tuple = ()

COLLECTIVES: Dict[Tuple[str, str], int] = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()


def _count(kind: str, dtype: torch.dtype) -> None:
    key = (kind, str(dtype).replace("torch.", ""))
    COLLECTIVES[key] = COLLECTIVES.get(key, 0) + 1


def head_shardable(num_kv_heads: int, n: int) -> bool:
    """Can the serving engine shard ``num_kv_heads`` over ``n`` ranks?"""
    return num_kv_heads % n == 0 and num_kv_heads >= n


def serve_collective_whitelist() -> dict:
    """{"movement", "integer_reductions", "float_reductions"}: the
    collectives the serving engine's entry points may run."""
    return {"movement": SERVE_MOVEMENT_COLLECTIVES,
            "integer_reductions": SERVE_INTEGER_REDUCTIONS,
            "float_reductions": SERVE_FLOAT_REDUCTIONS}


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def gather_heads(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's slice of a head axis, concatenated in rank order along
    ``dim`` (a no-op without a mesh or on one rank, so the one-rank path
    runs no collective)."""
    if not _sharded(mesh):
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    _count("all_gather", x.dtype)
    return torch.cat(parts, dim)


def any_shard(mask: torch.Tensor, mesh) -> torch.Tensor:
    """The OR over ranks of a boolean mask: an int32 sum, then ``> 0``."""
    if not _sharded(mesh):
        return mask
    n = mask.to(torch.int32)
    dist.all_reduce(n, op=dist.ReduceOp.SUM, group=mesh.group)
    _count("all_reduce", n.dtype)
    return n > 0

