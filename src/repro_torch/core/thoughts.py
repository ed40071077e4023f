"""Thought decomposition via attention sparsity (ports
``repro/core/thoughts.py``: ``row_sparsity``, ``gqa_group_sparsity``,
``classify`` and ``sparsity_from_qk``).

Sparsity of an attention row is the fraction of normalized weights below
1% of the row maximum; for GQA the scores are max-pooled over the query
heads of a kv group and renormalized first (paper App. C.2).  Mean
sparsity over the calibrated layers maps to a thought type (T > R > E in
sparsity).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.config import ThoughtType

SPARSITY_REL_THRESHOLD = 0.01


def row_sparsity(probs: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """probs [..., n] normalized weights; valid [..., n] -> [...] in [0, 1]."""
    if valid is None:
        valid = torch.ones_like(probs, dtype=torch.bool)
    rmax = torch.where(valid, probs, -torch.inf).amax(dim=-1, keepdim=True)
    small = (probs < SPARSITY_REL_THRESHOLD * rmax) & valid
    denom = valid.sum(dim=-1).clamp_min(1)
    return small.sum(dim=-1) / denom


def _pooled_sparsity(pooled: torch.Tensor,
                     valid: Optional[torch.Tensor]) -> torch.Tensor:
    """pooled [kv_heads, n] scores -> mean sparsity of their softmax rows,
    masked by valid [n] or [kv_heads, n]."""
    if valid is not None:
        valid = valid.expand_as(pooled)
        pooled = torch.where(valid, pooled, -torch.inf)
    return row_sparsity(torch.softmax(pooled, dim=-1), valid).mean()


def gqa_group_sparsity(scores: torch.Tensor, group_size: int,
                       valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Paper App. C.2: max-pool the scores [num_q_heads, n] (pre-softmax,
    one decode query) over the ``group_size`` query heads of each kv head,
    renormalize with a softmax, measure; the mean over the groups."""
    h, n = scores.shape
    if h % group_size:
        raise ValueError(f"{h} q heads are not a multiple of the group "
                         f"size {group_size}")
    pooled = scores.reshape(h // group_size, group_size, n).amax(dim=1)
    return _pooled_sparsity(pooled, None if valid is None else valid[None])


def sparsity_from_qk(q: torch.Tensor, k: torch.Tensor, valid: torch.Tensor,
                     gqa_group: int = 1) -> torch.Tensor:
    """Decode-time sparsity of one layer from the query q [num_q_heads, D]
    and the (dequantized, compressed) keys k [n, kv_heads, D]; valid is
    [n, kv_heads] or [n].  The scores over the <= budget cached keys are
    recomputed for the calibrated layers only.  The group is read from the
    shapes, as in the reference; ``gqa_group``, its static argument, must
    be 1 (the default) or agree with them."""
    hq, d = q.shape
    n, hkv, _ = k.shape
    if gqa_group not in (1, hq // hkv):
        raise ValueError(f"gqa_group {gqa_group} disagrees with {hq} q heads "
                         f"over {hkv} kv heads")
    if valid.dim() == 1:
        valid = valid[:, None].expand(n, hkv)
    scores = torch.einsum("ngd,knd->ngk", q.reshape(hkv, hq // hkv, d),
                          k) / math.sqrt(float(d))
    return _pooled_sparsity(scores.amax(dim=1), valid.T)


def classify(sparsity: torch.Tensor,
             thresholds: Tuple[float, float]) -> torch.Tensor:
    """Mean sparsity -> ThoughtType (int32): below t1 EXECUTION, below t2
    REASONING, else TRANSITION."""
    t1, t2 = thresholds
    return torch.where(
        sparsity < t1, int(ThoughtType.EXECUTION),
        torch.where(sparsity < t2, int(ThoughtType.REASONING),
                    int(ThoughtType.TRANSITION))).to(torch.int32)
