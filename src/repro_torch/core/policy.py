"""Retention policy (ports ``repro/core/policy.py``: ``ThinKVPolicy`` and
``get_policy``).

The paper's policy: importance rho(T)=0 < rho(E)=1 < rho(R)=2, precision
psi from ``ThinKVConfig.precision`` (T, E, R), progressive retention
schedule with a floor, and k-means medoid selection for TBE.  The ``rkv``
and ``uniform`` policies are not ported yet (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ThinKVConfig
from repro_torch.core.kmeans import kmeans_select


def _validate_common(cfg: ThinKVConfig) -> None:
    if any(b not in (2, 4, 8) for b in cfg.precision):
        raise ValueError(f"unsupported precisions {cfg.precision}")
    sched = cfg.retention_schedule
    if len(sched) == 0:
        raise ValueError("retention schedule must be non-empty")
    if list(sched) != sorted(sched, reverse=True):
        raise ValueError("retention schedule must be descending")
    if cfg.min_retention < 1:
        raise ValueError("min retention must be >= 1")
    if max(sched) < cfg.min_retention:
        raise ValueError(f"retention schedule {sched} is entirely below "
                         f"min_retention={cfg.min_retention}")
    if cfg.group_size > cfg.refresh_interval:
        raise ValueError("group must fit within a refresh interval")


class ThinKVPolicy:
    """Thought-importance precision + TBE k-means (the paper's policy)."""

    name = "thinkv"

    def rho(self, thought: torch.Tensor) -> torch.Tensor:
        return thought

    def psi_bits(self, thought: torch.Tensor, cfg: ThinKVConfig
                 ) -> torch.Tensor:
        prec = torch.tensor(cfg.precision, dtype=torch.int32,
                            device=thought.device)
        return prec[thought.long()]

    def precision_levels(self, cfg: ThinKVConfig) -> Tuple[int, ...]:
        return tuple(sorted(set(cfg.precision)))

    def retention_at(self, level: torch.Tensor, cfg: ThinKVConfig
                     ) -> torch.Tensor:
        sched = torch.tensor(cfg.retention_schedule, dtype=torch.int64,
                             device=level.device)
        idx = level.long().clamp(0, len(cfg.retention_schedule) - 1)
        return sched[idx].clamp_min(cfg.min_retention)

    def select_tokens(self, keys, valid, keep, cfg: ThinKVConfig):
        return kmeans_select(keys, valid, keep,
                             k_max=max(cfg.retention_schedule),
                             iters=cfg.kmeans_iters)

    def validate(self, cfg: ThinKVConfig) -> None:
        _validate_common(cfg)
        pt, pe, pr = cfg.precision
        if not pt <= pe <= pr:
            raise ValueError(f"psi must be monotone in rho: precision "
                             f"(T,E,R)={cfg.precision}")


DEFAULT_POLICY = ThinKVPolicy()


def get_policy(policy=None) -> ThinKVPolicy:
    """Resolve a policy name or instance; only ``thinkv`` is ported."""
    if policy is None or policy == "thinkv":
        return DEFAULT_POLICY
    if isinstance(policy, ThinKVPolicy):
        return policy
    raise NotImplementedError(
        f"retention policy {policy!r} is not ported yet (ROADMAP queue 1 "
        f"item 12); the port serves 'thinkv'")
