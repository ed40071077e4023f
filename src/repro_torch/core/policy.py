"""Retention policies (ports ``repro/core/policy.py``): importance rho,
precision psi, progressive retention and the TBE token selection, as a
pluggable strategy that ``core/ct_cache.py`` and the engine call.

* ``thinkv`` (:class:`ThinKVPolicy`, the default): the paper's policy —
  rho(T)=0 < rho(E)=1 < rho(R)=2, psi from ``ThinKVConfig.precision``
  (T, E, R), k-means medoid selection;
* ``rkv`` (:class:`RKVPolicy`): the same precision, but an anneal keeps
  the most diverse keys (greedy farthest-point selection);
* ``uniform`` (:class:`UniformPolicy`): every thought at 4 bits, rho 0
  everywhere (eviction is oldest-first), anneals keep the newest tokens.

The module-level ``rho`` / ``psi_bits`` / ``retention_at`` / ``validate``
delegate to :data:`DEFAULT_POLICY`, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ThinKVConfig
from repro_torch.core.kmeans import kmeans_select, redundancy_select
from repro_torch.spans import readback


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


class RetentionPolicy:
    """The strategy interface.  ``select_tokens(keys [B, n, d], valid
    [B, n], keep [B], cfg)`` returns a keep mask [B, n] with exactly
    ``min(keep, n_valid)`` True rows (batched over layers, where the
    reference calls it per layer)."""

    name = "abstract"

    def rho(self, thought: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def psi_bits(self, thought: torch.Tensor, cfg: ThinKVConfig
                 ) -> torch.Tensor:
        raise NotImplementedError

    def precision_levels(self, cfg: ThinKVConfig) -> Tuple[int, ...]:
        raise NotImplementedError

    def retention_at(self, level: torch.Tensor, cfg: ThinKVConfig
                     ) -> torch.Tensor:
        """R_n of the n-th eviction of a segment (clamped at min retention;
        levels past the schedule's end hold its last entry)."""
        with readback():
            sched = torch.tensor(cfg.retention_schedule, dtype=torch.int64,
                                 device=level.device)
        idx = level.long().clamp(0, len(cfg.retention_schedule) - 1)
        return sched[idx].clamp_min(cfg.min_retention)

    def select_tokens(self, keys, valid, keep, cfg: ThinKVConfig):
        raise NotImplementedError

    def validate(self, cfg: ThinKVConfig) -> None:
        _validate_common(cfg)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


class ThinKVPolicy(RetentionPolicy):
    """Thought-importance precision + TBE k-means (the paper's policy)."""

    name = "thinkv"

    def rho(self, thought):
        return thought

    def psi_bits(self, thought, cfg):
        with readback():
            prec = torch.tensor(cfg.precision, dtype=torch.int32,
                                device=thought.device)
        with readback():
            return prec[thought.long()]

    def precision_levels(self, cfg):
        return tuple(sorted(set(cfg.precision)))

    def select_tokens(self, keys, valid, keep, cfg):
        return kmeans_select(keys, valid, keep,
                             k_max=max(cfg.retention_schedule),
                             iters=cfg.kmeans_iters)

    def validate(self, cfg):
        _validate_common(cfg)
        pt, pe, pr = cfg.precision
        if not pt <= pe <= pr:
            raise ValueError(f"psi must be monotone in rho: precision "
                             f"(T,E,R)={cfg.precision}")


class RKVPolicy(ThinKVPolicy):
    """R-KV-style redundancy-aware retention: ThinKV's precision, but an
    anneal keeps the most diverse keys (farthest-point selection)."""

    name = "rkv"

    def select_tokens(self, keys, valid, keep, cfg):
        return redundancy_select(keys, valid, keep,
                                 k_max=max(cfg.retention_schedule))


class UniformPolicy(RetentionPolicy):
    """The uniform-precision control arm: every thought at 4 bits, rho 0
    everywhere (budget eviction is oldest-first), anneals keep the newest
    ``keep`` valid rows."""

    name = "uniform"
    bits = 4

    def rho(self, thought):
        return torch.zeros_like(thought)

    def psi_bits(self, thought, cfg):
        return torch.full(thought.shape, self.bits, dtype=torch.int32,
                          device=thought.device)

    def precision_levels(self, cfg):
        return (self.bits,)

    def select_tokens(self, keys, valid, keep, cfg):
        vi = valid.to(torch.int64)
        keep = torch.minimum(keep.to(torch.int64).clamp_min(1), vi.sum(-1))
        # rank 1 is the newest valid row (slot order is append order
        # within a segment)
        newest_rank = vi.flip(-1).cumsum(-1).flip(-1)
        return valid & (newest_rank <= keep[:, None])


DEFAULT_POLICY = ThinKVPolicy()

POLICIES = {p.name: p for p in (DEFAULT_POLICY, RKVPolicy(),
                                UniformPolicy())}


def get_policy(policy=None) -> RetentionPolicy:
    """Resolve a policy name, or pass a policy instance through."""
    if policy is None:
        return DEFAULT_POLICY
    if isinstance(policy, RetentionPolicy):
        return policy
    try:
        return POLICIES[policy]
    except KeyError:
        raise ValueError(f"unknown retention policy {policy!r}; "
                         f"registered: {sorted(POLICIES)}") from None


def rho(thought: torch.Tensor) -> torch.Tensor:
    """Importance score under the default policy (T=0 < E=1 < R=2)."""
    return DEFAULT_POLICY.rho(thought)


def psi_bits(thought: torch.Tensor, cfg: ThinKVConfig) -> torch.Tensor:
    """Precision (bits) of a thought type under the default policy."""
    return DEFAULT_POLICY.psi_bits(thought, cfg)


def retention_at(level: torch.Tensor, cfg: ThinKVConfig) -> torch.Tensor:
    """R_n of the n-th eviction of a segment (clamped at min retention)."""
    return DEFAULT_POLICY.retention_at(level, cfg)


def validate(cfg: ThinKVConfig) -> None:
    DEFAULT_POLICY.validate(cfg)


def default_thresholds() -> Tuple[float, float]:
    return ThinKVConfig().sparsity_thresholds
