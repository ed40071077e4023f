"""Preemption-aware continuous-batching request scheduler (a copy of
``repro/serving/scheduler.py``, which is numpy-only; the port keeps its own).

Request lifecycle: WAITING -> RUNNING -> FINISHED, with RUNNING ->
PREEMPTED -> RUNNING cycles and a terminal CANCELLED state.  The queue is
ordered by (priority desc, arrival asc); ``admit`` takes a per-request
capacity gate; ``select_victim`` picks the lowest-priority, largest,
youngest running request.  The engine pauses victims through it when its
oversubscribed pool is short (``ThinKVEngine._preempt``).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional

import numpy as np


class RequestState(enum.Enum):
    WAITING = "waiting"        # queued, never ran
    RUNNING = "running"        # occupies a slot
    PREEMPTED = "preempted"    # paused; blocks spilled to host, re-queued
    FINISHED = "finished"      # retired (EOS or max tokens)
    CANCELLED = "cancelled"    # removed mid-flight (client disconnect)


# eq=False: identity equality only — the generated __eq__ would compare
# the ndarray prompt (ambiguous-truth ValueError inside queue.remove
# whenever two queued requests share a uid)
@dataclasses.dataclass(eq=False)
class Request:
    uid: int
    prompt: np.ndarray                   # int32 tokens
    max_new_tokens: int = 256
    eos_token: Optional[int] = None
    priority: int = 0                    # higher = served first, evicted last
    arrival: int = -1                    # FIFO stamp; set by Scheduler.submit
    state: RequestState = RequestState.WAITING
    preemptions: int = 0                 # times this request was paused
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    stats: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Slot:
    idx: int
    request: Optional[Request] = None
    tokens_out: int = 0

    @property
    def free(self) -> bool:
        return self.request is None


def _queue_key(req: Request):
    return (-req.priority, req.arrival)


class Scheduler:
    def __init__(self, num_slots: int):
        self.slots = [Slot(i) for i in range(num_slots)]
        self.queue: List[Request] = []   # WAITING + PREEMPTED, sorted
        self.finished: List[Request] = []
        self._arrivals = 0
        self._stamps: set = set()        # every arrival stamp ever issued

    def submit(self, req: Request) -> None:
        """Queue a new request, guaranteeing a UNIQUE arrival stamp.

        The arrival stamp doubles as the engine's bookkeeping key
        (``_queued_at`` / ``_spilled`` / ``request_logits``), so a
        collision would silently cross-wire spill state and queue-wait
        metrics between requests.  Auto-assigned stamps skip past any
        caller-provided ones, and a caller-provided stamp that was
        already issued is rejected loudly."""
        if req.arrival < 0:
            req.arrival = self._arrivals
        elif req.arrival in self._stamps:
            raise ValueError(
                f"duplicate arrival stamp {req.arrival}: stamps key the "
                f"engine's per-request bookkeeping and must be unique — "
                f"leave Request.arrival at -1 to auto-assign")
        self._stamps.add(req.arrival)
        self._arrivals = max(self._arrivals, req.arrival + 1)
        self.queue.append(req)
        self.queue.sort(key=_queue_key)

    def stamp(self, req: Request) -> None:
        """Assign a unique arrival stamp WITHOUT queueing the request.

        Fork children (``samples_per_slot``) never pass through the
        queue — they are placed straight into a slot by :meth:`place`
        once their parent's state exists to fork from — but they still
        need a stamp: it keys the engine's per-request bookkeeping and
        seeds the request's private sampling stream.  Stamping at
        SUBMISSION time (not at fork time) keeps the stamp order — and
        therefore every child's sampled tokens — independent of when
        the fork actually lands."""
        assert req.arrival < 0, "request already stamped"
        req.arrival = self._arrivals
        self._stamps.add(req.arrival)
        self._arrivals += 1

    def place(self, req: Request, slot: Slot, tokens_out: int = 0) -> None:
        """Put a stamped request straight into a FREE slot (fork
        children: the engine has already forked the parent's device
        state into the slot, so the request starts mid-decode with
        ``tokens_out`` tokens already accounted)."""
        assert slot.free, f"slot {slot.idx} is occupied"
        assert req.arrival >= 0, "place() needs a stamped request"
        req.state = RequestState.RUNNING
        slot.request = req
        slot.tokens_out = tokens_out

    def enqueue_stamped(self, req: Request) -> None:
        """Queue a request that was stamped via :meth:`stamp` but never
        placed — the fork FALLBACK: the parent finished (or was
        cancelled) before a slot freed up, so the child re-derives its
        sequence from a fresh prefill of the shared prompt instead of a
        COW fork.  Keeps the original stamp (it already keys the
        request's stream seed and bookkeeping)."""
        assert req.arrival >= 0 and req.arrival in self._stamps, \
            "enqueue_stamped needs a stamp()-issued request"
        req.state = RequestState.WAITING
        self.queue.append(req)
        self.queue.sort(key=_queue_key)

    def admit(self, can_admit: Optional[Callable[[Request], bool]] = None
              ) -> List[Slot]:
        """Move queued requests into free slots; returns newly filled.

        Requests are considered in ``(priority desc, arrival asc)`` order.
        ``can_admit`` is an optional PER-REQUEST capacity gate (the engine
        passes its watermark check, sized to the request's budget-derived
        block estimate — or its spilled mapping, for a PREEMPTED request).
        A refusal skips only that request, so smaller requests queued
        behind a too-big head are still admitted this sweep.
        """
        newly = []
        free_slots = (s for s in self.slots if s.free)
        slot = next(free_slots, None)
        for req in list(self.queue):
            if slot is None:
                break
            if can_admit is not None and not can_admit(req):
                continue
            self.queue.remove(req)
            req.state = RequestState.RUNNING
            slot.request = req
            slot.tokens_out = 0
            newly.append(slot)
            slot = next(free_slots, None)
        return newly

    def preempt(self, slot: Slot) -> Request:
        """Pause a RUNNING request and re-queue it as PREEMPTED.

        The engine must have spilled the request's device state first; the
        original arrival stamp puts it ahead of later same-priority work.
        """
        req = slot.request
        req.state = RequestState.PREEMPTED
        req.preemptions += 1
        slot.request = None
        slot.tokens_out = 0
        self.queue.append(req)
        self.queue.sort(key=_queue_key)
        return req

    def select_victim(self, blocks_held: Callable[[int], int],
                      exclude: tuple = ()) -> Optional[Slot]:
        """Preemption victim among occupied slots (None if none eligible):
        lowest priority first, then most physical blocks held (frees the
        most), then youngest arrival."""
        cands = [s for s in self.slots
                 if not s.free and s.idx not in exclude]
        if not cands:
            return None
        return min(cands, key=lambda s: (s.request.priority,
                                         -blocks_held(s.idx),
                                         -s.request.arrival))

    def active_slots(self) -> List[Slot]:
        return [s for s in self.slots if not s.free]

    def retire(self, slot: Slot) -> Request:
        req = slot.request
        req.done = True
        req.state = RequestState.FINISHED
        self.finished.append(req)
        slot.request = None
        slot.tokens_out = 0
        return req

    def cancel(self, req: Request) -> bool:
        """Drop a QUEUED (WAITING or PREEMPTED) request without running
        it; returns False when the request is not in the queue.  The
        engine owns the matching pool teardown (dropping a spill's
        retained references); a RUNNING request is cancelled via
        ``vacate`` on its slot instead."""
        try:
            self.queue.remove(req)
        except ValueError:
            return False
        req.state = RequestState.CANCELLED
        req.done = True
        return True

    def vacate(self, slot: Slot) -> Request:
        """Clear a slot for a mid-flight cancellation: the request is
        neither retired (it did not finish) nor re-queued (it will never
        resume).  The engine must release the slot's pool blocks."""
        req = slot.request
        req.state = RequestState.CANCELLED
        req.done = True
        slot.request = None
        slot.tokens_out = 0
        return req

    @property
    def pending(self) -> int:
        return len(self.queue)

    def busy(self) -> bool:
        return bool(self.queue) or any(not s.free for s in self.slots)
