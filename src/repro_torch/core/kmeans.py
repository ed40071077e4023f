"""Token selection for TBE (ports ``repro/core/kmeans.py``:
``kmeans_select`` and ``redundancy_select``), batched over a leading axis
(the reference ``vmap``s them over layers).

Deterministic: position-stratified init and a fixed number of Lloyd
iterations.  Every scatter is written so that its result cannot depend on
the order of duplicate indices (scatters with duplicates are
non-deterministic on CUDA); argmin takes the first index on ties, as the
reference's does.
"""
from __future__ import annotations

import torch

BIG = 1e30


def _sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[B, n, d] x [B, k, d] -> squared distances [B, n, k]."""
    return ((x * x).sum(-1)[..., None] - 2.0 * (x @ c.transpose(1, 2))
            + (c * c).sum(-1)[:, None, :])


def kmeans_select(x: torch.Tensor, valid: torch.Tensor, keep: torch.Tensor,
                  k_max: int = 64, iters: int = 8) -> torch.Tensor:
    """Select ``keep`` representative rows out of the valid rows of ``x``.

    x [B, n, d]; valid [B, n] bool; keep [B] int (<= k_max).  Returns the
    keep mask [B, n] bool with exactly ``min(keep, n_valid)`` True rows
    (the medoid of every cluster, padded with the lowest-index valid rows
    on medoid collisions).
    """
    b, n, _ = x.shape
    dev = x.device
    x = x.float()
    vi = valid.to(torch.int64)
    n_valid = vi.sum(-1)                                        # [B]
    keep = torch.minimum(keep.to(torch.int64).clamp_min(1),
                         n_valid.clamp_max(k_max))
    rank = vi.cumsum(-1) - 1                                    # [B, n]
    j = torch.arange(k_max, device=dev)
    tgt_rank = (j[None] * n_valid[:, None]) // keep.clamp_min(1)[:, None]
    # rank -> row index of the valid rows (invalid rows write a dropped
    # column: the reference writes them to rank n-1, which only inactive
    # centroids can read)
    rows = torch.arange(n, device=dev).expand(b, n)
    row_of_rank = torch.zeros((b, n + 1), dtype=torch.int64, device=dev)
    row_of_rank.scatter_(1, torch.where(valid, rank, n), rows)
    init_rows = row_of_rank[:, :n].gather(1, tgt_rank.clamp(0, n - 1))
    c = x.gather(1, init_rows[..., None].expand(-1, -1, x.shape[-1]))
    active = j[None] < keep[:, None]                            # [B, k_max]
    mask = valid[:, :, None] & active[:, None, :]
    vf = valid.float()[..., None]

    for _ in range(iters):
        d2 = torch.where(mask, _sqdist(x, c), BIG)
        assign = d2.argmin(-1)                                  # [B, n]
        onehot = torch.nn.functional.one_hot(assign, k_max).float() * vf
        counts = onehot.sum(1)                                  # [B, k_max]
        sums = onehot.transpose(1, 2) @ x
        c = torch.where(counts[..., None] > 0,
                        sums / counts.clamp_min(1)[..., None], c)

    d2 = torch.where(mask, _sqdist(x, c), BIG)
    assign = d2.argmin(-1)
    in_cluster = (assign[..., None] == j) & valid[..., None]     # [B, n, k]
    medoid = torch.where(in_cluster, d2, BIG).argmin(1)         # [B, k_max]
    has_member = in_cluster.any(1) & active
    fallback = torch.where(valid[..., None], d2, BIG).argmin(1)
    medoid = torch.where(has_member, medoid, fallback)

    hits = torch.zeros((b, n), dtype=torch.int64, device=dev)
    hits.scatter_add_(1, medoid, active.to(torch.int64))
    keep_mask = hits > 0
    # exactly min(keep, n_valid) kept even under medoid collisions: pad
    # with the lowest-index valid rows not yet kept
    deficit = keep - keep_mask.sum(-1)
    idx = torch.arange(n, device=dev)
    pad_order = torch.where(valid & ~keep_mask, idx, n + 1)
    pad_rank = torch.argsort(pad_order, dim=-1, stable=True)
    take = idx[None] < deficit[:, None]
    padded = torch.zeros_like(keep_mask).scatter_(1, pad_rank, take)
    return (keep_mask | padded) & valid


def redundancy_select(x: torch.Tensor, valid: torch.Tensor,
                      keep: torch.Tensor, k_max: int = 64) -> torch.Tensor:
    """Greedy farthest-point (max-min-distance) selection, the retention
    core of the R-KV policy (ports ``repro/core/kmeans.py::
    redundancy_select``, batched over a leading axis): keep the ``keep``
    most mutually diverse rows, so near-duplicates go first.

    x [B, n, d]; valid [B, n] bool; keep [B] int.  The seed is the newest
    (last) valid row; ``k_max - 1`` growth steps follow, each adding the
    unselected valid row farthest from the selected set (ties to the
    lowest index, as ``torch.argmax`` breaks them).  Distances are
    ``((x - x[pick]) ** 2).sum(-1)`` in f32, the reference's form, so
    near-ties fall the same way.  Returns the keep mask [B, n] with
    exactly ``min(keep, n_valid, k_max)`` True rows.
    """
    b, n, _ = x.shape
    dev = x.device
    x = x.float()
    n_valid = valid.to(torch.int64).sum(-1)
    keep = torch.minimum(keep.to(torch.int64).clamp_min(1),
                         n_valid.clamp_max(k_max))
    idx = torch.arange(n, device=dev)
    rows = torch.arange(b, device=dev)
    seed = torch.where(valid, idx, -1).argmax(-1)                # [B]

    def dist(pick):
        return ((x - x[rows, pick][:, None]) ** 2).sum(-1)       # [B, n]
    mask = valid & (idx == seed[:, None])
    # invalid rows sit below every real candidate: argmax never picks them
    dmin = torch.where(valid, dist(seed), -1.0)
    for j in range(1, max(k_max, 1)):
        pick = torch.where(valid & ~mask, dmin, -1.0).argmax(-1)
        grow = (j < keep)[:, None]
        mask = mask | (grow & (idx == pick[:, None]))
        dmin = torch.where(grow, torch.minimum(dmin, dist(pick)), dmin)
    return mask & valid
