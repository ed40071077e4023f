"""Copy-on-write prefix cache over the shared :class:`GlobalPool` (ports
``repro/serving/prefix_cache.py``).

A host-side token-chain index over fully committed prefill states.  The key
is the int32 bytes of the first ``n`` prompt tokens, registered at
commit-aligned chunk boundaries (``n % g == 0``, empty TBQ buffer) and once
at the end of the prompt (a ``full_only`` entry when the buffer is partial:
usable only by a prompt of exactly that length).  The value is the block
table at that boundary, a snapshot of the request's ``CTCache`` and the
boundary's last-token logits.

Registration increfs every mapped block (the cache holds references like a
request does); a hit increfs them again for the admitted request, which
restores the snapshot and prefills only the tail.  Entries leave in LRU
order under pool pressure, before any request is preempted.

Differences of form from the reference: the pool's refcounts change in
place (the reference returns a new pool); the snapshot and the logits are
independent clones on the engine's device (no host round trip at each
boundary), the table a host numpy copy (the engine's host accounting reads
it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import ct_cache as CC


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix: everything needed to resume prefill after it."""

    key: bytes                 # prompt[:length] as int32 bytes
    length: int                # tokens covered (commit boundary)
    table: np.ndarray          # [L, NB] int32 physical mapping (-1 unmapped)
    cache: CC.CTCache          # snapshot (independent clones)
    logits: torch.Tensor       # last covered token's logits [V]
    full_only: bool            # partial TBQ buffer: exact match only
    last_used: int = 0         # LRU stamp

    @property
    def blocks_per_layer(self) -> np.ndarray:
        return (self.table >= 0).sum(axis=1).astype(np.int64)


class PrefixCache:
    """Host-side LRU index of shareable prefill prefixes; the engine owns
    the pool whose refcounts its operations change."""

    def __init__(self, dims: CC.CacheDims, capacity: int = 64):
        self.dims = dims
        self.capacity = max(int(capacity), 1)
        self.entries: Dict[bytes, PrefixEntry] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _touch(self, entry: PrefixEntry) -> None:
        self._clock += 1
        entry.last_used = self._clock

    @staticmethod
    def _key(prompt: np.ndarray, n: int) -> bytes:
        return np.ascontiguousarray(prompt[:n], np.int32).tobytes()

    def lookup(self, prompt: np.ndarray, record: bool = True
               ) -> Optional[PrefixEntry]:
        """Longest registered prefix of ``prompt`` (None on a miss).
        ``full_only`` entries match only a prompt of their exact length.  A
        hit always freshens the entry's LRU stamp, a probe with
        ``record=False`` too (it only stays out of the hit/miss counts)."""
        best = None
        for n in sorted({e.length for e in self.entries.values()},
                        reverse=True):
            if n > len(prompt):
                continue
            e = self.entries.get(self._key(prompt, n))
            if e is None or (e.full_only and n != len(prompt)):
                continue
            best = e
            break
        if best is not None:
            self._touch(best)
        if record:
            if best is None:
                self.misses += 1
            else:
                self.hits += 1
        return best

    def register(self, pool: CC.GlobalPool, prompt: np.ndarray, n: int,
                 table: torch.Tensor, cache: CC.CTCache,
                 logits: torch.Tensor, full_only: bool) -> None:
        """Index the committed prefill state at boundary ``n`` and incref
        its mapped blocks (a boundary already registered is only
        freshened)."""
        key = self._key(prompt, n)
        if key in self.entries:
            self._touch(self.entries[key])
            return
        while self.entries and len(self.entries) >= self.capacity:
            self.evict_lru(pool)
        entry = PrefixEntry(
            key=key, length=int(n), table=table.cpu().numpy().copy(),
            cache=CC.CTCache(**{f: getattr(cache, f).clone()
                                for f in CC.CTCache.FIELDS}),
            logits=logits.clone(), full_only=bool(full_only))
        self._touch(entry)
        self.entries[key] = entry
        CC.incref_blocks(pool, table)

    def evict_entry(self, pool: CC.GlobalPool, entry: PrefixEntry) -> None:
        """Drop ``entry``, decrefing its blocks (blocks a request still
        maps stay live)."""
        del self.entries[entry.key]
        self.evictions += 1
        CC.release_blocks(pool, torch.as_tensor(
            entry.table, device=pool.refcount.device))

    def evict_lru(self, pool: CC.GlobalPool) -> Optional[PrefixEntry]:
        """Drop the least recently used entry; returns it (None if empty)."""
        if not self.entries:
            return None
        entry = min(self.entries.values(), key=lambda e: e.last_used)
        self.evict_entry(pool, entry)
        return entry

    def lru_entries(self) -> List[PrefixEntry]:
        """Entries in LRU-first order (the decay scan order)."""
        return sorted(self.entries.values(), key=lambda e: e.last_used)

    def drop_all(self, pool: CC.GlobalPool) -> None:
        while self.entries:
            self.evict_lru(pool)

    def cached_tables(self) -> List[np.ndarray]:
        """One ``[L, NB]`` table per entry (each holds one reference per
        mapped block), for the pool audit."""
        return [e.table for e in self.entries.values()]

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {"entries": len(self.entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0}
