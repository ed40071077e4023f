"""GPipe-style pipeline parallelism over a mesh axis (ports
``repro/training/pipeline.py``: ``pipeline_apply``).

The circular-pipeline formulation: every stage computes every tick on a
different microbatch, and bubbles are the usual (S-1)/(M+S-1) fraction.
Each rank of the axis is one stage.  A tick's hand-off (the reference's
``ppermute`` to the next stage) is a send to rank i+1 and a receive from
rank i-1 (``sharding.permute``); at the end the last stage's buffer of
finished microbatches is broadcast to every stage (the reference's psum
of that buffer masked to the last stage).  The transformation is generic
over ``stage_fn(stage_params, h) -> h``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import sharding as SH


def pipeline_apply(stage_fn: Callable, stage_params, h0: torch.Tensor,
                   mesh, *, num_microbatches: int, axis: str = "pod"
                   ) -> torch.Tensor:
    """Run ``h -> stage_fn^S(h)`` with the S stages on the ranks of
    ``axis``.

    Args:
      stage_params: this rank's block of the stage parameters, whose
        leading axis is [S] sharded over ``axis`` (a tensor or a name ->
        tensor mapping, each leaf [1, ...]).
      h0: [M, mb, ...] microbatched activations, whole on every rank.
    Returns [M, mb, ...] outputs after all S stages, on every rank.
    """
    m = num_microbatches
    if h0.shape[0] != m:
        raise ValueError(f"h0 holds {h0.shape[0]} microbatches, not {m}")
    size = SH.axes_size(mesh, axis)
    stage = SH.block_index(mesh, axis)
    params_me = stage_params[0] if isinstance(stage_params, torch.Tensor) \
        else {k: x[0] for k, x in stage_params.items()}
    buf = torch.zeros_like(h0)             # outputs per microbatch
    carry = torch.zeros_like(h0[0])        # inbound activation
    for t in range(m + size - 1):
        mb_idx = t - stage                 # microbatch this stage sees
        active = 0 <= mb_idx < m
        # stage 0 ingests fresh microbatches; others use carried input
        inp = h0[min(max(t, 0), m - 1)] if stage == 0 else carry
        out = stage_fn(params_me, inp) if active else carry
        if stage == size - 1 and active:
            buf[mb_idx] = out
        carry = SH.permute(out, mesh, axis, 1)
    return SH.broadcast(buf, mesh, axis, size - 1)
