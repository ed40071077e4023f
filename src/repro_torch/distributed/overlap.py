"""Compute/communication overlap patterns (ports
``repro/distributed/overlap.py``: ``chunked_all_to_all``,
``overlapped_moe_ffn``).

``chunked_all_to_all`` decomposes one all-to-all into ring steps so that
compute on slab i can overlap the transfer of slab i+1 (the classic MoE
dispatch overlap).  ``overlapped_moe_ffn`` wires an all-to-all around an
expert FFN applied chunk by chunk.  Both run over the ranks of a mesh
axis and take and return this rank's blocks, as the reference's
``shard_map`` hands its local function the blocks under ``P(axis)``.
The sends and receives are ``sharding.permute``'s and the all-to-all
``sharding.all_to_all``'s; gloo runs each to completion before the next
compute, so on the port they overlap nothing.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import sharding as SH


def chunked_all_to_all(x: torch.Tensor, mesh, axis: str, num_chunks: int,
                       compute: Callable[[torch.Tensor], torch.Tensor]
                       ) -> torch.Tensor:
    """x [E_local_groups, n, d] on each rank of ``axis`` -> [size, ...]:
    step s holds ``compute`` of the slab ``idx`` of the x of rank
    ``idx - s``, the slabs rotating one rank on per step.  ``num_chunks``
    is unused, as in the reference."""
    size = SH.axes_size(mesh, axis)
    idx = SH.block_index(mesh, axis)
    slabs = torch.stack(torch.chunk(x, size, 0), 0)  # [size, E/size, n, d]
    out = [compute(slabs[idx])]
    rotating = slabs
    for _ in range(1, size):
        rotating = SH.permute(rotating, mesh, axis, 1)
        out.append(compute(rotating[idx]))
    return torch.stack(out, 0)


def overlapped_moe_ffn(x: torch.Tensor, w_up: torch.Tensor,
                       w_down: torch.Tensor, mesh, axis: str = "model",
                       chunks: int = 4) -> torch.Tensor:
    """Expert-parallel FFN with chunked dispatch: this rank's tokens x
    [n, d] go out round-robin to the |axis| experts (demo routing: slab
    j of every rank to expert j), each rank applies its local expert
    (``w_up`` [d, f], ``w_down`` [f, d]: ``relu(x @ w_up) @ w_down``) in
    chunks of rows, and the results come back; returns [n, d]."""
    size = SH.axes_size(mesh, axis)
    n = x.shape[0]
    per = n // size
    xs = x.reshape(size, per, -1)
    recv = SH.all_to_all(xs, mesh, axis)       # tokens to their expert
    csz = max(per // chunks, 1)
    ys = [torch.relu(recv[:, c:c + csz] @ w_up) @ w_down
          for c in range(0, per, csz)]
    back = SH.all_to_all(torch.cat(ys, 1), mesh, axis)
    return back.reshape(n, -1)
