"""Continuous Thinking (CT) paged KV cache (ports ``repro/core/ct_cache.py``:
the parts the serving engine runs on its shared, oversubscribed pool, and
the single-request API of the ThinKV controller ``core/thinkv.step_token``:
``append_token``, ``commit_and_evict_if_full``, ``dequant_layer``,
``valid_counts``).

Data model, as in the reference:

* :class:`PoolView` holds the quantized planes in paged layout
  ``[L, num_blocks, BS, H, ...]``: one uint8 code per lane even at 4 bits,
  E4M3-valued scales in bf16 planes, byte-identical to the reference;
* :class:`CTCache` holds one request's metadata (flat ``[L, NS]`` slot
  planes, segment bookkeeping) and the bf16 TBQ buffer;
* :class:`GlobalPool` is the engine's shared physical pool plus a per-layer
  block refcount; per-request block tables ``[L, NB]`` map logical blocks
  to physical ones (-1 = unmapped).

Differences of form (not of function) from the reference:

* the functions here UPDATE IN PLACE — the cache's tensors (often views of
  the engine's batched per-slot state), the pool planes and refcounts, and
  the block table — where the reference returns new arrays; the pool is
  the largest state on the card and is never copied;
* ``vmap`` over layers is a leading batch axis; ``lax.cond`` on device
  values is host control flow: whether a commit or refresh is due comes
  from the engine's host mirrors of ``num_tokens`` / ``buf_len``, and a
  refresh reads the slot's segment table back once (to skip segments TBE
  would not touch);
* the commit's quantization is one K4 launch on the card
  (``kernels.ops.tbq_commit_quant``) that reads the bf16 buffers and the
  thought's bit width on the device, bit-exact to ``quantize_group`` at
  every level followed by the reference's selection.

The shared-pool operations of the oversubscribed pool are here too: the
COW step (``changed_slots``, ``sync_block_tables`` with a dirty mask,
``cow_blocks``), references (``incref_blocks``, ``release_blocks``) and the
spill pair (``claim_blocks``, ``extract_request``, ``restore_request``).
Physical ids are the reference's: claims take the lowest free id.

Under tensor-parallel serving (``mesh``, ``distributed/sharding.py``) the
planes and buffers hold a rank's share of the kv heads, and the two
computations that cross heads gather first, as the reference's do
(its lines 340-401 and 956-967): the keys an anneal or a budget eviction
selects from are gathered to the full head set, so every rank makes the
one-rank decision, and the COW dirty mask is ORed over ranks.  Nothing
else here reads across heads.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ThinKVConfig, ThoughtType
from repro_torch.core import quantization as Q
from repro_torch.core.policy import get_policy
from repro_torch.core.thoughts import classify
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.spans import readback, span, traced

SCALE_DTYPE = torch.bfloat16
FREE, VALID, EVICTED = 0, 1, 2
UNMAPPED = -1
SEGMENT_CAP = 128          # max tokens of one segment an anneal considers


class CacheDims(NamedTuple):
    """Static geometry of a CT cache."""

    L: int          # attention layers
    NB: int         # logical blocks per layer per request
    BS: int         # block size (tokens)
    H: int          # kv heads
    D: int          # head dim
    G: int          # quantization group size (== tokens per commit)
    S: int          # max segments
    nibble: bool    # 4-bit plane: one code per uint8 lane, accounted 4 bits

    @property
    def NS(self) -> int:
        return self.NB * self.BS

    @property
    def scale_groups(self) -> int:
        return self.D // Q.GROUP


def make_dims(cfg: ThinKVConfig, num_layers: int, kv_heads: int,
              head_dim: int, slack: float = 2.0) -> CacheDims:
    nb = max(int(cfg.token_budget * slack) // cfg.block_size, 4)
    return CacheDims(L=num_layers, NB=nb, BS=cfg.block_size, H=kv_heads,
                     D=head_dim, G=cfg.group_size, S=cfg.max_segments,
                     nibble=max(cfg.precision) <= 4)


class PoolView(NamedTuple):
    k_codes: torch.Tensor     # [L, nb, BS, H, D] uint8
    v_codes: torch.Tensor
    k_scales: torch.Tensor    # [L, nb, BS, H, D // GROUP] bf16 (e4m3 values)
    v_scales: torch.Tensor


def init_pool_view(dims: CacheDims, num_blocks: int,
                   device: torch.device) -> PoolView:
    shp = (dims.L, num_blocks, dims.BS, dims.H)
    z = lambda last, dt: torch.zeros(shp + (last,), dtype=dt, device=device)
    return PoolView(z(dims.D, torch.uint8), z(dims.D, torch.uint8),
                    z(dims.scale_groups, SCALE_DTYPE),
                    z(dims.scale_groups, SCALE_DTYPE))


def view_flat(view: PoolView) -> Tuple[torch.Tensor, ...]:
    """Paged planes -> flat [L, NS, ...] (a view, no copy)."""
    return tuple(a.reshape(a.shape[0], a.shape[1] * a.shape[2],
                           *a.shape[3:]) for a in view)


def view_paged(dims: CacheDims, *flat: torch.Tensor) -> PoolView:
    """Flat planes [L, NS, ...] -> paged [L, NS // BS, BS, ...], the inverse
    of :func:`view_flat` (a view, no copy)."""
    return PoolView(*(a.reshape(a.shape[0], -1, dims.BS, *a.shape[2:])
                      for a in flat))


@dataclasses.dataclass
class CTCache:
    """One request's metadata + TBQ buffer (or every slot's, with a leading
    slot axis: :meth:`slot` then returns views of one row)."""

    slot_state: torch.Tensor      # [L, NS] uint8: 0 free, 1 valid, 2 evicted
    slot_seg: torch.Tensor        # [L, NS] int32
    slot_pos: torch.Tensor        # [L, NS] int32
    slot_bits: torch.Tensor       # [L, NS] uint8
    block_type: torch.Tensor      # [L, NB] int8 (-1: unclaimed)
    seg_type: torch.Tensor        # [S] int32 (-1: unused)
    seg_level: torch.Tensor       # [L, S] int32
    buf_k: torch.Tensor           # [L, G, H, D] bf16
    buf_v: torch.Tensor
    buf_len: torch.Tensor         # [] int32
    cur_seg: torch.Tensor
    cur_thought: torch.Tensor
    prev_thought: torch.Tensor
    num_tokens: torch.Tensor

    FIELDS = ("slot_state", "slot_seg", "slot_pos", "slot_bits",
              "block_type", "seg_type", "seg_level", "buf_k", "buf_v",
              "buf_len", "cur_seg", "cur_thought", "prev_thought",
              "num_tokens")

    def slot(self, r: int) -> "CTCache":
        return CTCache(**{f: getattr(self, f)[r] for f in self.FIELDS})

    def copy_(self, other: "CTCache") -> "CTCache":
        for f in self.FIELDS:
            getattr(self, f).copy_(getattr(other, f))
        return self


def init_cache(dims: CacheDims, device: torch.device,
               batch: Optional[int] = None) -> CTCache:
    """Empty metadata; segment 0 opens as REASONING (prefill tokens are
    R-type).  ``batch`` adds a leading slot axis."""
    L, NS, H, D, G, S = dims.L, dims.NS, dims.H, dims.D, dims.G, dims.S
    lead = () if batch is None else (batch,)

    def full(shape, val, dt):
        return torch.full(lead + shape, val, dtype=dt, device=device)

    seg_type = full((S,), -1, torch.int32)
    seg_type[..., 0] = int(ThoughtType.REASONING)
    r = int(ThoughtType.REASONING)
    return CTCache(
        slot_state=full((L, NS), FREE, torch.uint8),
        slot_seg=full((L, NS), -1, torch.int32),
        slot_pos=full((L, NS), -1, torch.int32),
        slot_bits=full((L, NS), 4, torch.uint8),
        block_type=full((L, dims.NB), -1, torch.int8),
        seg_type=seg_type,
        seg_level=full((L, S), 0, torch.int32),
        buf_k=full((L, G, H, D), 0, torch.bfloat16),
        buf_v=full((L, G, H, D), 0, torch.bfloat16),
        buf_len=full((), 0, torch.int32),
        cur_seg=full((), 0, torch.int32),
        cur_thought=full((), r, torch.int32),
        prev_thought=full((), r, torch.int32),
        num_tokens=full((), 0, torch.int32),
    )


# ---------------------------------------------------------------------------
# Commit: quantize a full buffer group and place it
# ---------------------------------------------------------------------------

def _quantize_group_by_thought(cfg: ThinKVConfig, k: torch.Tensor,
                               v: torch.Tensor, thought: torch.Tensor,
                               policy=None):
    """Quantize the bf16 [L, G, H, D] K/V buffers at psi(thought) bits in
    one K4 launch.  The bit width is a device value, resolved on the device
    against the policy's precision levels as the reference's selection
    over every level resolves it (no read-back)."""
    policy = get_policy(policy)
    bits = policy.psi_bits(thought, cfg)
    kc, ks, vc, vs = ops.tbq_commit_quant(k, v, bits,
                                          policy.precision_levels(cfg))
    return kc, ks, vc, vs, bits


def _alloc_slots(dims: CacheDims, slot_state: torch.Tensor,
                 block_type: torch.Tensor, thought: torch.Tensor):
    """Pick G logical slots per layer for a group of thought type t.

    Priority: 4 evicted slot in a same-type block, 3 free slot in a
    same-type partially filled block, 2 slot of a fully free block,
    1 evicted slot of another type's block; ties by ascending address.
    slot_state [L, NS], block_type [L, NB] -> (idx [L, G], ok [L, G]).
    """
    NS, BS = dims.NS, dims.BS
    btype = block_type.repeat_interleave(BS, dim=1)
    same = btype == thought.to(block_type.dtype)
    block_free = (slot_state.reshape(-1, dims.NB, BS) == FREE).all(-1) \
        .repeat_interleave(BS, dim=1)
    free, evicted = slot_state == FREE, slot_state == EVICTED
    score = torch.zeros(slot_state.shape, dtype=torch.int64,
                        device=slot_state.device)
    score = torch.where(block_free, 2, score)
    score = torch.where(free & same & ~block_free, 3, score)
    score = torch.where(evicted & same, 4, score)
    score = torch.where(evicted & ~same, 1, score)
    lin = torch.arange(NS, device=slot_state.device)
    _, idx = torch.topk(score * NS - lin, dims.G, dim=1)
    return idx, score.gather(1, idx) > 0


@traced("commit")
def commit_group(cfg: ThinKVConfig, dims: CacheDims, cache: CTCache,
                 view: PoolView, policy=None) -> None:
    """Quantize the full buffer and write it into the request's view,
    reusing evicted slots in place (cache and view updated in place)."""
    t = cache.cur_thought
    dev = t.device
    L, G = dims.L, dims.G
    positions = cache.num_tokens - G + torch.arange(G, dtype=torch.int32,
                                                    device=dev)
    kc, ks, vc, vs, bits = _quantize_group_by_thought(
        cfg, cache.buf_k, cache.buf_v, t, policy)
    idx, ok = _alloc_slots(dims, cache.slot_state, cache.block_type, t)
    lrow = torch.arange(L, device=dev)[:, None].expand(L, G)
    with readback():
        li, si = lrow[ok], idx[ok]
    for plane, val in zip(view_flat(view), (kc, vc, ks, vs)):
        with readback():
            plane[li, si] = val[ok]
    with readback():
        cache.slot_state[li, si] = VALID
    cache.slot_seg[li, si] = cache.cur_seg
    with readback():
        cache.slot_pos[li, si] = positions.expand(L, G)[ok]
    cache.slot_bits[li, si] = bits.to(torch.uint8)
    bidx = idx // dims.BS
    claim = ok & (cache.block_type.gather(1, bidx) == -1)
    with readback():
        cache.block_type[lrow[claim], bidx[claim]] = t.to(torch.int8)
    cache.buf_len.fill_(0)


# ---------------------------------------------------------------------------
# TBE: segment annealing + budget eviction
# ---------------------------------------------------------------------------

@traced("anneal")
def _anneal_segment(cfg: ThinKVConfig, dims: CacheDims, cache: CTCache,
                    k_codes: torch.Tensor, k_scales: torch.Tensor,
                    seg: torch.Tensor, enable: torch.Tensor,
                    policy=None, mesh=None) -> None:
    """Anneal segment ``seg[l]`` one retention level in every layer l where
    ``enable[l]``.  k_codes/k_scales are the flat [L, NS, H, ...] planes
    (a rank's heads under ``mesh``: the selection keys are gathered to the
    full head set first)."""
    policy = get_policy(policy)
    L, NS = dims.L, dims.NS
    dev = seg.device
    seg = seg.long()
    match = (cache.slot_seg == seg[:, None]) & (cache.slot_state == VALID)
    order = torch.where(match, torch.arange(NS, device=dev), NS + 1)
    idx = torch.argsort(order, dim=1, stable=True)[:, :SEGMENT_CAP]
    valid = match.gather(1, idx)
    level = cache.seg_level.gather(1, seg[:, None])[:, 0]
    target = policy.retention_at(level, cfg)
    count = valid.sum(-1)
    do = enable & (count > 0)
    lrow = torch.arange(L, device=dev)[:, None]
    bits = cache.slot_bits.gather(1, idx).to(torch.int32)
    keys = Q.dequantize_by_bitcode(k_codes[lrow, idx],
                                   k_scales[lrow, idx].float(),
                                   bits[..., None, None])
    keys = SH.gather_heads(keys, mesh, 2)
    keep = policy.select_tokens(keys.reshape(L, idx.shape[1], -1), valid,
                                target, cfg)
    evict = valid & ~keep & (do & (count > target))[:, None]
    state = cache.slot_state.gather(1, idx)
    cache.slot_state.scatter_(1, idx, torch.where(evict, EVICTED, state))
    new_level = torch.where(
        do, (level + 1).clamp_max(len(cfg.retention_schedule)), level)
    cache.seg_level.scatter_(1, seg[:, None], new_level[:, None])


def _free_empty_blocks(dims: CacheDims, cache: CTCache) -> None:
    """Blocks with no VALID slot return to the free pool (their EVICTED
    slots become FREE) — no data moves."""
    by_block = cache.slot_state.view(dims.L, dims.NB, dims.BS)
    empty = ~(by_block == VALID).any(-1)
    by_block.masked_fill_(empty[..., None], FREE)
    cache.block_type.masked_fill_(empty, -1)


def tbe_anneal_all(cfg: ThinKVConfig, dims: CacheDims, cache: CTCache,
                   view: PoolView, before_seg: int, seg_type: List[int],
                   policy=None, mesh=None) -> None:
    """A transition segment ended: anneal every earlier used segment one
    retention level in every layer (``seg_type`` is the host copy)."""
    k_codes, _, k_scales, _ = view_flat(view)
    dev = cache.slot_state.device
    on = torch.ones(dims.L, dtype=torch.bool, device=dev)
    for seg in range(min(before_seg, dims.S)):
        if seg_type[seg] >= 0:
            _anneal_segment(cfg, dims, cache, k_codes, k_scales,
                            torch.full((dims.L,), seg, device=dev), on,
                            policy, mesh)
    _free_empty_blocks(dims, cache)


@traced("evict")
def budget_evict(cfg: ThinKVConfig, dims: CacheDims, cache: CTCache,
                 view: PoolView, max_rounds: int = 4, policy=None,
                 mesh=None, num_tokens: Optional[int] = None) -> None:
    """Above budget: anneal each layer's least important, oldest segment one
    level per round.  Layers within budget are masked, not branched on, so
    no flag is read back from the card.  ``num_tokens``, the caller's host
    count of the request's tokens, bounds every layer's VALID slots: at or
    under the budget no round can anneal, and the rounds are skipped (the
    reference's ``lax.cond`` pays for a round only over budget)."""
    policy = get_policy(policy)
    k_codes, _, k_scales, _ = view_flat(view)
    S = dims.S
    dev = cache.slot_state.device
    seg_ids = torch.arange(S, device=dev)
    if num_tokens is not None and num_tokens <= cfg.token_budget:
        max_rounds = 0
    for _ in range(max_rounds):
        valid = cache.slot_state == VALID
        over = valid.sum(-1) > cfg.token_budget
        seg_of_slot = torch.where(valid, cache.slot_seg.long(), S)
        counts = torch.zeros((dims.L, S + 1), dtype=torch.int64, device=dev)
        counts.scatter_add_(1, seg_of_slot, torch.ones_like(seg_of_slot))
        shrinkable = (counts[:, :S] > cfg.min_retention) & \
            (cache.seg_type >= 0) & (seg_ids < cache.cur_seg)
        key = policy.rho(cache.seg_type).long() * S + seg_ids
        key = torch.where(shrinkable, key, 2 ** 30)
        _anneal_segment(cfg, dims, cache, k_codes, k_scales,
                        key.argmin(-1), over & shrinkable.any(-1), policy,
                        mesh)
    _free_empty_blocks(dims, cache)


def refresh(cfg: ThinKVConfig, dims: CacheDims, cache: CTCache,
            view: PoolView, sparsity: torch.Tensor, policy=None,
            mesh=None, num_tokens: Optional[int] = None) -> None:
    """Every tau tokens: classify the sparsity into a thought type, close the
    current segment (TBE if it was a transition), then enforce the budget
    (``num_tokens`` as in :func:`budget_evict`)."""
    new_thought = classify(sparsity, cfg.sparsity_thresholds)
    with readback():
        host = torch.cat([cache.cur_seg[None], cache.seg_type]).tolist()
    ended_seg, seg_type = host[0], host[1:]
    if seg_type[ended_seg] == int(ThoughtType.TRANSITION):
        tbe_anneal_all(cfg, dims, cache, view, ended_seg, seg_type, policy,
                       mesh)
    nxt = min(ended_seg + 1, dims.S - 1)
    cache.cur_seg.fill_(nxt)
    cache.seg_type[nxt] = new_thought
    cache.prev_thought.copy_(cache.cur_thought)
    cache.cur_thought.copy_(new_thought)
    budget_evict(cfg, dims, cache, view, policy=policy, mesh=mesh,
                 num_tokens=num_tokens)


# ---------------------------------------------------------------------------
# Single-request write side (the controller, ``core/thinkv.step_token``)
# ---------------------------------------------------------------------------

def commit_and_evict_if_full(cfg: ThinKVConfig, dims: CacheDims,
                             cache: CTCache, view: PoolView,
                             policy=None) -> Tuple[CTCache, PoolView]:
    """When the buffer is full, commit it as a group and enforce the
    per-layer budget (the reference's ``lax.cond`` is a host branch on
    ``buf_len``).  Updates in place; returns (cache, view)."""
    if int(cache.buf_len) >= dims.G:
        commit_group(cfg, dims, cache, view, policy)
        budget_evict(cfg, dims, cache, view, policy=policy)
    return cache, view


def append_token(cfg: ThinKVConfig, dims: CacheDims, cache: CTCache,
                 view: PoolView, k_t: torch.Tensor, v_t: torch.Tensor,
                 policy=None) -> Tuple[CTCache, PoolView]:
    """Append one token's [L, H, D] KV to the bf16 buffer; commit when full.
    Updates in place; returns (cache, view)."""
    i = int(cache.buf_len)
    cache.buf_k[:, i] = k_t.to(torch.bfloat16)
    cache.buf_v[:, i] = v_t.to(torch.bfloat16)
    cache.buf_len.add_(1)
    cache.num_tokens.add_(1)
    return commit_and_evict_if_full(cfg, dims, cache, view, policy)


# ---------------------------------------------------------------------------
# Shared global block pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GlobalPool:
    """Physical planes ``[L, NP, BS, ...]`` + refcount ``[L, NP]`` (free iff
    0) shared by every request slot."""

    view: PoolView
    refcount: torch.Tensor

    @property
    def free(self) -> torch.Tensor:
        return self.refcount == 0


def init_global_pool(dims: CacheDims, num_blocks: int,
                     device: torch.device) -> GlobalPool:
    return GlobalPool(init_pool_view(dims, num_blocks, device),
                      torch.zeros((dims.L, num_blocks), dtype=torch.int32,
                                  device=device))


def init_block_table(dims: CacheDims, device: torch.device,
                     batch: Optional[int] = None) -> torch.Tensor:
    lead = () if batch is None else (batch,)
    return torch.full(lead + (dims.L, dims.NB), UNMAPPED, dtype=torch.int32,
                      device=device)


def stacked_slot_plane(dims: CacheDims, plane: torch.Tensor) -> torch.Tensor:
    """Engine metadata [R, L, NS] -> the fused kernel's [L, R, NB, BS]."""
    r = plane.shape[0]
    return plane.transpose(0, 1).reshape(dims.L, r, dims.NB, dims.BS) \
        .contiguous()


def stacked_buffers(buf: torch.Tensor) -> torch.Tensor:
    """TBQ buffers [R, L, G, H, D] -> the fused kernel's [L, R, G, H, D]."""
    return buf.transpose(0, 1).contiguous()


def _layer_rows(table: torch.Tensor) -> torch.Tensor:
    return torch.arange(table.shape[0], device=table.device)[:, None] \
        .expand_as(table)


def gather_view(pool_view: PoolView, table: torch.Tensor) -> PoolView:
    """A request's paged view through its [L, NB] table (a copy).  Unmapped
    entries gather physical block 0; their slots are FREE."""
    rows, safe = _layer_rows(table), table.clamp_min(0).long()
    return PoolView(*(p[rows, safe] for p in pool_view))


def scatter_view(pool_view: PoolView, table: torch.Tensor,
                 view: PoolView) -> None:
    """Write a request's view back through its table (unmapped dropped)."""
    mapped = table >= 0
    with readback():
        rows, phys = _layer_rows(table)[mapped], table[mapped].long()
    for p, v in zip(pool_view, view):
        with readback():
            p[rows, phys] = v[mapped]


def _add_refs(refcount: torch.Tensor, table: torch.Tensor,
              mask: torch.Tensor, delta: int) -> None:
    with readback():
        rows = _layer_rows(table)[mask]
    with readback():
        refcount.index_put_((rows, table[mask].long()),
                            torch.full_like(rows, delta,
                                            dtype=refcount.dtype),
                            accumulate=True)


def _rank_alloc(refcount: torch.Tensor, need: torch.Tensor):
    """Give the i-th True entry of ``need`` [L, NB] the i-th free physical
    id of its layer (ascending); returns (cand, got)."""
    np_blocks = refcount.shape[1]
    free = refcount == 0
    order = torch.where(free, torch.arange(np_blocks, device=need.device),
                        np_blocks + 1)
    free_sorted = torch.argsort(order, dim=1, stable=True)
    rank = need.long().cumsum(-1) - 1
    cand = free_sorted.gather(1, rank.clamp(0, np_blocks - 1))
    got = need & (rank < free.sum(-1, keepdim=True))
    return cand.to(torch.int32), got


def changed_slots(view_old: PoolView, view_new: PoolView) -> torch.Tensor:
    """Per-slot content-change mask ``[L, NS]`` between two per-request
    views (the COW dirty detector): a slot is dirty iff any of its four
    planes differ.  bf16 scales are compared by their bits."""
    def per(a, b):
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        L, nb, bs = a.shape[:3]
        return (a != b).reshape(L, nb * bs, -1).any(-1)
    out = per(view_old[0], view_new[0])
    for a, b in zip(view_old[1:], view_new[1:]):
        out |= per(a, b)
    return out


def sync_block_tables(dims: CacheDims, pool: GlobalPool, table: torch.Tensor,
                      cache: CTCache, view: PoolView,
                      dirty_slots: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reconcile a request's logical blocks with the pool after a CT update:
    decref released blocks (free at refcount 0), COW-fault every SHARED
    block (refcount > 1) whose content the update changed, map newly
    claimed logical blocks and COW copies to free physical ids (lowest
    first), scatter the view back, and revert what the pool could not back.

    ``dirty_slots`` is :func:`changed_slots`' ``[L, NS]`` mask (None: no
    block can be shared, COW cannot trigger).  A COW fault decrefs the
    shared source and claims a fresh block, into which the scatter writes
    the request's whole block; the source's planes are never written.  A
    COW claim that fails re-attaches the source, masks its scatter and
    reverts only the dirty slots to FREE; a fresh claim that fails reverts
    its whole block.  Returns ``(alloc_failed, cow)``, both ``[L, NB]``
    masks; table, pool and cache change in place."""
    new_bt = cache.block_type
    freed = (new_bt == -1) & (table >= 0)
    _add_refs(pool.refcount, table, freed, -1)
    table.masked_fill_(freed, UNMAPPED)
    if dirty_slots is None:
        cow = torch.zeros_like(freed)
    else:
        dirty = dirty_slots.reshape(table.shape[0], dims.NB, dims.BS).any(-1)
        rc_at = pool.refcount.gather(1, table.clamp_min(0).long())
        cow = (table >= 0) & dirty & (rc_at > 1)
        old_phys = torch.where(cow, table, UNMAPPED)
        _add_refs(pool.refcount, table, cow, -1)
        table.masked_fill_(cow, UNMAPPED)
    need = (new_bt >= 0) & (table < 0)
    cand, got = _rank_alloc(pool.refcount, need)
    table.copy_(torch.where(got, cand, table))
    _add_refs(pool.refcount, table, got, 1)
    failed = need & ~got
    failed_cow = cow & ~got
    if dirty_slots is not None:
        table.copy_(torch.where(failed_cow, old_phys, table))
        _add_refs(pool.refcount, table, failed_cow, 1)
        failed_slots = (failed & ~failed_cow).repeat_interleave(dims.BS, 1) \
            | (failed_cow.repeat_interleave(dims.BS, 1) & dirty_slots)
    else:
        failed_slots = failed.repeat_interleave(dims.BS, 1)
    cache.slot_state.masked_fill_(failed_slots, FREE)
    cache.block_type.masked_fill_(failed & ~failed_cow, -1)
    scatter_view(pool.view, table.masked_fill(failed_cow, UNMAPPED), view)
    return failed, cow & got


def release_blocks(pool: GlobalPool, table: torch.Tensor) -> None:
    """Drop one reference on every mapped block of ``table`` (a retiring or
    spilling request, an evicted prefix-cache entry); a block returns to
    the free list at refcount 0."""
    _add_refs(pool.refcount, table, table >= 0, -1)


def incref_blocks(pool: GlobalPool, table: torch.Tensor) -> None:
    """Add one reference to every mapped block of ``table``: a new holder
    (a prefix-cache hit or registration) pins the blocks' content, so any
    later writer COW-faults instead of writing them in place."""
    _add_refs(pool.refcount, table, table >= 0, 1)


def cow_blocks(dims: CacheDims, pool: GlobalPool, table: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Explicit COW fault for the masked, mapped, SHARED logical blocks:
    claim a fresh block each, copy the planes, swap the table entries and
    decref the sources.  Blocks this table owns alone (refcount 1) are
    skipped, so a source's count stays >= 1 and no source is reclaimed
    within the call.  A failed claim re-attaches the old mapping.  Returns
    ``ok`` (a bool tensor); pool and table change in place."""
    view = gather_view(pool.view, table)
    rc_at = pool.refcount.gather(1, table.clamp_min(0).long())
    sel = mask & (table >= 0) & (rc_at > 1)
    old_phys = torch.where(sel, table, UNMAPPED)
    _add_refs(pool.refcount, table, sel, -1)
    cand, got = _rank_alloc(pool.refcount, sel)
    table.copy_(torch.where(got, cand, table))
    _add_refs(pool.refcount, table, got, 1)
    failed = sel & ~got
    table.copy_(torch.where(failed, old_phys, table))
    _add_refs(pool.refcount, table, failed, 1)
    scatter_view(pool.view, torch.where(got, table, UNMAPPED), view)
    return ~failed.any()


# ---------------------------------------------------------------------------
# Preemption: spill a request's physical blocks to the host, restore later
# ---------------------------------------------------------------------------

def claim_blocks(pool: GlobalPool, mapped: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map every True entry of ``mapped`` [L, NB] to a fresh physical block
    (lowest free id first, per layer); returns ``(table, ok)``, ``ok``
    False when some layer's free list could not back the whole mapping.
    The refcounts change in place."""
    cand, got = _rank_alloc(pool.refcount, mapped)
    table = torch.where(got, cand, UNMAPPED).to(torch.int32)
    _add_refs(pool.refcount, table, got, 1)
    return table, ~(mapped & ~got).any()


def extract_request(pool: GlobalPool, table: torch.Tensor
                    ) -> Tuple[PoolView, torch.Tensor]:
    """A request's physical blocks for a host spill: its paged view
    gathered through the table (a copy) and the ``[L, NB]`` mapped mask.
    Unmapped blocks gather block 0; restore never scatters them."""
    return gather_view(pool.view, table), table >= 0


def restore_request(pool: GlobalPool, mapped: torch.Tensor, view: PoolView
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Claim fresh physical blocks for a spilled request's mapped logical
    blocks and scatter its planes back through the new table; reads go
    through the table in logical order, so the result is bit-exact.
    Returns ``(table, ok)``."""
    table, ok = claim_blocks(pool, mapped)
    scatter_view(pool.view, table, view)
    return table, ok


def check_pool_invariants(pool: GlobalPool, tables, extra_tables=()) -> dict:
    """Host audit of the refcount invariants: every physical block's
    refcount equals the references the holders make to it, none is
    negative, and claimed + free == pool blocks.  Raises AssertionError."""
    with readback():
        rc = pool.refcount.cpu().numpy()
    with readback():
        tb = np.asarray(tables.cpu() if torch.is_tensor(tables) else tables)
    if tb.ndim == 2:
        tb = tb[None]
    holders = [tb] + [np.asarray(t)[None] if np.asarray(t).ndim == 2
                      else np.asarray(t) for t in extra_tables]
    L, NP = rc.shape
    assert (rc >= 0).all(), f"negative refcount (double-free): {rc.min()}"
    claimed = []
    for l in range(L):
        refs = np.zeros(NP, np.int64)
        for h in holders:
            mapped = h[:, l][h[:, l] >= 0]
            np.add.at(refs, mapped, 1)
        bad = np.nonzero(refs != rc[l])[0]
        assert bad.size == 0, \
            (f"layer {l}: refcount mismatch at physical blocks "
             f"{bad.tolist()[:8]}: counted {refs[bad][:8].tolist()} refs, "
             f"pool says {rc[l][bad][:8].tolist()}")
        n_claimed, n_free = int((rc[l] > 0).sum()), int((rc[l] == 0).sum())
        assert n_claimed + n_free == NP
        claimed.append(n_claimed)
    return {"claimed": claimed, "free": (rc == 0).sum(axis=1).tolist(),
            "pool_blocks": NP}


def engine_advance(cfg: ThinKVConfig, dims: CacheDims, pool: GlobalPool,
                   table: torch.Tensor, cache: CTCache,
                   sparsity: torch.Tensor, *, num_tokens: int, buf_len: int,
                   n_new: int = 1, track_cow: bool = False, policy=None,
                   mesh=None
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                              int, int]:
    """``n_new`` tokens were written into the slot's buffer: commit (with
    budget eviction) when the buffer is full, refresh every tau tokens,
    and reconcile the block table — the pool is touched only then.

    ``num_tokens`` / ``buf_len`` are the engine's host mirrors of the
    slot's counters before the write.  With ``track_cow`` (on whenever a
    block can be shared) the pre-commit view is kept and compared with the
    post-commit one, and every shared block the commit changed COW-faults
    (:func:`sync_block_tables`).  Returns (whether a commit claim failed,
    the commit's COW-fault count — tensors the caller reads once, None when
    nothing was due —, new num_tokens, new buf_len).  Under ``mesh`` the
    planes hold a rank's heads: a slot dirty in any rank's heads COW-faults
    on every rank (the mask is ORed over ranks).
    """
    policy = get_policy(policy)
    cache.buf_len.add_(n_new)
    cache.num_tokens.add_(n_new)
    num_tokens, buf_len = num_tokens + n_new, buf_len + n_new
    at_commit = buf_len >= dims.G
    at_refresh = num_tokens % cfg.refresh_interval == 0
    if not (at_commit or at_refresh):
        return None, None, num_tokens, buf_len
    with span("maintain"):
        view = gather_view(pool.view, table)
        view0 = PoolView(*(p.clone() for p in view)) if track_cow else None
        if at_commit:
            commit_group(cfg, dims, cache, view, policy)
            budget_evict(cfg, dims, cache, view, policy=policy, mesh=mesh,
                         num_tokens=num_tokens)
            buf_len = 0
        if at_refresh:
            with span("refresh"):
                refresh(cfg, dims, cache, view, sparsity, policy, mesh,
                        num_tokens)
        with span("tables"):
            dirty = SH.any_shard(changed_slots(view0, view), mesh) \
                if track_cow else None
            failed, cow = sync_block_tables(dims, pool, table, cache, view,
                                            dirty_slots=dirty)
    return failed.any(), cow.sum(), num_tokens, buf_len


# ---------------------------------------------------------------------------
# Read side: dequantize, counts, footprint accounting
# ---------------------------------------------------------------------------

def dequant_layer(dims: CacheDims, cache: CTCache, view: PoolView,
                  layer: int) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain read of one layer of a single request's paged view:
    (k, v [NS, H, D] f32, valid [NS] bool)."""
    k_codes, v_codes, k_scales, v_scales = view_flat(view)
    bits = cache.slot_bits[layer].to(torch.int32)[:, None, None]
    k = Q.dequantize_by_bitcode(k_codes[layer], k_scales[layer].float(),
                                bits)
    v = Q.dequantize_by_bitcode(v_codes[layer], v_scales[layer].float(),
                                bits)
    return k, v, cache.slot_state[layer] == VALID


def valid_counts(cache: CTCache) -> torch.Tensor:
    """VALID slots per layer, [L] int64 (the reference's is int32)."""
    return (cache.slot_state == VALID).sum(-1)


def memory_stats(dims: CacheDims, cache: CTCache) -> dict:
    """Physical footprint and pressure of one request's cache (the
    reference's signature has an unused ``cfg`` first; the port drops
    it)."""
    used_blocks = (cache.block_type >= 0).sum(-1)
    valid = cache.slot_state == VALID
    n_valid = valid_counts(cache)
    eff_bits = torch.where(valid, cache.slot_bits.float(), 0.0)
    avg_bits = eff_bits.sum() / valid.float().sum().clamp_min(1.0)
    bytes_per_slot = (2 * dims.H * dims.D // (2 if dims.nibble else 1)
                      + 2 * dims.H * dims.scale_groups)
    return {"valid_tokens": n_valid, "used_blocks": used_blocks,
            "physical_bytes": used_blocks * dims.BS * bytes_per_slot,
            "avg_bits": avg_bits, "pressure": used_blocks / dims.NB}


def metadata_bytes(dims: CacheDims) -> int:
    """Bytes of one request's metadata (every CTCache field but the
    buffer)."""
    per_layer = dims.NS * (1 + 4 + 4 + 1) + dims.NB + 4 * dims.S
    return dims.L * per_layer + 4 * dims.S + 5 * 4


def buffer_bytes(dims: CacheDims) -> int:
    return dims.L * 2 * 2 * dims.G * dims.H * dims.D
