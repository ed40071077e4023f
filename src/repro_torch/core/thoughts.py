"""Thought decomposition via attention sparsity (ports
``repro/core/thoughts.py``: ``row_sparsity`` and ``classify``).

Sparsity of an attention row is the fraction of normalized weights below
1% of the row maximum; mean sparsity over the calibrated layers maps to a
thought type (T > R > E in sparsity).
"""
from __future__ import annotations

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


def classify(sparsity: torch.Tensor,
             thresholds: Tuple[float, float]) -> torch.Tensor:
    """Mean sparsity -> ThoughtType (int32): below t1 EXECUTION, below t2
    REASONING, else TRANSITION."""
    t1, t2 = thresholds
    return torch.where(
        sparsity < t1, int(ThoughtType.EXECUTION),
        torch.where(sparsity < t2, int(ThoughtType.REASONING),
                    int(ThoughtType.TRANSITION))).to(torch.int32)
