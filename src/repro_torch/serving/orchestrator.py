"""Asyncio continuous-batching orchestrator over the engine's API seam
(ports ``repro/serving/orchestrator.py``).

The :class:`ThinKVEngine` is device-facing only (prefill / insert /
generate / consume / free_resource / drop_spill); this module owns the host
loop: one asyncio task drives the engine while per-request consumers stream
tokens.

Overlap, as in the reference: ``generate`` dispatches tick N and returns a
result holding device tensors; the loop parks in ``await
run_in_executor(res.block)`` while their host copies land, and consumers
woken by tick N-1's tokens run inside that window; a waiting request's
prefill runs after one yield, so running requests' consumers drain first.
Every submit / prefill / resume / dispatch / consume / deliver / cancel /
finish lands in ``events`` with its tick and a sequence number, and
``prefill_overlaps_decode()`` / ``stream_overlaps_dispatch()`` read the two
overlap claims from that log.

Decision order: the loop replays the reference's (admission sweeps,
headroom checks, the livelock valve), so a streamed run gives the tokens,
per-request logits, audits and counters of the synchronous run on the same
arrival pattern, and per-request logits are schedule-invariant across
arrival patterns (resume is bit-exact, shared blocks are immutable).  A
pack of several ticks (``ticks_per_dispatch`` > 1) is drained trip by
trip, so fan-out and retirement happen as for separate ticks.

Forks (``samples_per_slot`` = n): ``n - 1`` child streams share the
request's prompt and limits; they are stamped at submission, in order
(the stamp seeds each child's sampling stream), and never pass through the
queue: once the parent has started decoding and a slot is free, the
engine forks the parent's cache into it (``fork_slot``) and the child
inherits the tokens emitted so far.  Pending forks land before every
admission sweep and after it; a child whose parent ended first falls back
to a prefill of the prompt through the queue (``fork_fallback``).

Cancellation: ``TokenStream.cancel()`` stops the stream at once and tears
the request down at the loop's next boundary — a running slot is freed, a
queued or preempted request leaves the queue and ``drop_spill`` releases
the shared references its spill kept — and ``audit_pool`` runs after
every teardown.

Drift: with an engine built with ``drift_probe=True``, a finished
request's stats gain ``drift`` (``engine.measure_drift``) and the log a
``"drift"`` event.

Pacing: ``schedule_arrival(after_tick=...)`` injects requests in tick space
(reproducible); ``submit`` may be called from any task (wall-clock
arrivals).  An idle loop waits on an arrival event.

Builds: with an ``analysis.RetraceGuard`` installed on the engine, every
kernel library its entry points build or load lands in the log as a
``"retrace"`` event (``_drain_retrace_events``), after each consume and at
the end; steady-state serving logs none.

Under tensor-parallel serving each rank runs its own orchestrator over its
own engine, unchanged: every host decision is the same on every rank.
"""
from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.scheduler import Request, RequestState

_END = object()        # stream sentinel: no further tokens


class TokenStream:
    """Per-request handle: ``async for token in stream`` and ``cancel``.
    After :meth:`cancel` iteration stops at once and for good; tokens
    already queued are dropped."""

    def __init__(self, orch: "Orchestrator", request: Request):
        self._orch = orch
        self.request = request
        self._queue: asyncio.Queue = asyncio.Queue()
        self._done = asyncio.Event()
        self.cancelled = False
        self.forks: List["TokenStream"] = []    # samples_per_slot children

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        if self.cancelled:
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is _END or self.cancelled:
            raise StopAsyncIteration
        tick, tok = item
        self._orch._log("deliver", arrival=self.request.arrival, tick=tick)
        return tok

    def cancel(self) -> None:
        """Never yield another token; release the request's pool and queue
        resources at the serve loop's next boundary (audited)."""
        if self.request.done or self.cancelled:
            return
        self.cancelled = True
        self._orch._cancel_pending.append(self.request)
        self._queue.put_nowait(_END)      # wake a parked __anext__
        self._orch._arrival_event.set()   # wake an idle serve loop

    async def result(self) -> Request:
        """Wait for the terminal state (FINISHED or CANCELLED)."""
        await self._done.wait()
        return self.request

    @property
    def metrics(self) -> Optional[Dict]:
        """TTFT / TPOT / queue-wait of this request (None before its first
        token)."""
        return self._orch.request_summary().get(self.request.arrival)


class Orchestrator:
    """Continuous-batching serve loop over one :class:`ThinKVEngine`.

    One orchestrator drives one serve episode.  Requests already in the
    engine's scheduler (``engine.submit``, or left by an earlier episode)
    are adopted, without token streams."""

    def __init__(self, engine, audit_on_cancel: bool = True):
        self.engine = engine
        self.audit_on_cancel = audit_on_cancel
        self.streams: Dict[int, TokenStream] = {}     # arrival -> stream
        self._stream_of: Dict[int, TokenStream] = {}  # id(req) -> stream
        self.events: List[Dict] = []                  # the metrics log
        self.request_metrics: Dict[int, Dict] = {}    # arrival -> timings
        self._cancel_pending: List[Request] = []
        self._pending_forks: List[tuple] = []  # (parent_req, child_stream)
        self._tick_arrivals: List[tuple] = []  # (after_tick, seq, stream)
        self._arrival_event = asyncio.Event()
        self._closed = False
        self._seq = 0
        self._t0 = None

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def _make_request(self, prompt, max_new_tokens, eos_token, priority,
                      uid) -> TokenStream:
        req = Request(uid=self._seq if uid is None else uid,
                      prompt=np.asarray(prompt, np.int64),
                      max_new_tokens=max_new_tokens, eos_token=eos_token,
                      priority=priority)
        self._seq += 1
        stream = TokenStream(self, req)
        self._stream_of[id(req)] = stream
        return stream

    def _attach_forks(self, stream: TokenStream,
                      samples_per_slot: int) -> None:
        """``samples_per_slot - 1`` child streams with the parent's prompt,
        limits and priority (forked in by :meth:`_try_forks`)."""
        req = stream.request
        for _ in range(max(0, int(samples_per_slot) - 1)):
            stream.forks.append(self._make_request(
                req.prompt, req.max_new_tokens, req.eos_token,
                req.priority, None))

    def _submit_now(self, stream: TokenStream) -> None:
        eng = self.engine
        req = stream.request
        eng.scheduler.submit(req)
        eng._queued_at[req.arrival] = eng.metrics["ticks"]
        self.streams[req.arrival] = stream
        self.request_metrics[req.arrival] = self._fresh_metrics()
        self._log("submit", arrival=req.arrival)
        # stamp the children now, in order: the stamp seeds a child's
        # sampling stream, which must not depend on when a slot frees
        for child in stream.forks:
            creq = child.request
            eng.scheduler.stamp(creq)
            eng._queued_at[creq.arrival] = eng.metrics["ticks"]
            self.streams[creq.arrival] = child
            self.request_metrics[creq.arrival] = self._fresh_metrics()
            self._log("submit", arrival=creq.arrival, fork_of=req.arrival)
            self._pending_forks.append((req, child))
        self._arrival_event.set()

    def _fresh_metrics(self) -> Dict:
        return {
            "submit_wall": time.perf_counter(),
            "submit_tick": int(self.engine.metrics["ticks"]),
            "admit_wall": None, "admit_tick": None,
            "first_token_wall": None, "first_token_tick": None,
            "last_token_wall": None, "tokens": 0, "token_ticks": []}

    def submit(self, prompt, max_new_tokens: int = 256,
               eos_token: Optional[int] = None, priority: int = 0,
               uid: Optional[int] = None,
               samples_per_slot: int = 1) -> TokenStream:
        """Submit one request now; returns its :class:`TokenStream`.
        Callable before ``serve`` starts or from a task while it runs.
        ``samples_per_slot`` n attaches n - 1 forked children
        (``stream.forks``)."""
        stream = self._make_request(prompt, max_new_tokens, eos_token,
                                    priority, uid)
        self._attach_forks(stream, samples_per_slot)
        self._submit_now(stream)
        return stream

    def schedule_arrival(self, after_tick: int, prompt,
                         max_new_tokens: int = 256,
                         eos_token: Optional[int] = None,
                         priority: int = 0,
                         uid: Optional[int] = None,
                         samples_per_slot: int = 1) -> TokenStream:
        """Deterministic open-loop arrival: the serve loop submits the
        request once ``after_tick`` engine ticks have completed.  The
        stream is live at once; it yields nothing until the request
        lands."""
        stream = self._make_request(prompt, max_new_tokens, eos_token,
                                    priority, uid)
        self._attach_forks(stream, samples_per_slot)
        self._tick_arrivals.append((int(after_tick), len(self._tick_arrivals),
                                    stream))
        self._tick_arrivals.sort(key=lambda t: (t[0], t[1]))
        return stream

    def close(self) -> None:
        """No further external ``submit``: ``serve`` returns once the queue
        drains (scheduled tick arrivals still land)."""
        self._closed = True
        self._arrival_event.set()

    # ------------------------------------------------------------------
    # the serve loop
    # ------------------------------------------------------------------

    def run_sync(self, max_ticks: int = 10_000) -> List[Request]:
        """Synchronous episode: serve everything already submitted.  From
        inside a running event loop the episode runs on a private loop in a
        worker thread (the engine is not thread-safe: never two loops)."""
        self.close()
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return asyncio.run(self.serve(max_ticks=max_ticks))
        import concurrent.futures
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            return ex.submit(
                asyncio.run, self.serve(max_ticks=max_ticks)).result()

    async def serve(self, max_ticks: int = 10_000) -> List[Request]:
        """Drive the engine until the queue drains (after :meth:`close`) or
        ``max_ticks`` loop iterations ran; returns the finished requests.
        One admission sweep up front, then per iteration: arrivals,
        cancellations, headroom and tick dispatch, the overlapped
        consume, token fan-out, an admission sweep."""
        eng = self.engine
        sch = eng.scheduler
        self._t0 = time.perf_counter()
        self._adopt_existing()
        self._inject_due_arrivals()
        self._process_cancellations()
        await self._admit_and_prefill()
        iters = 0
        while iters < max_ticks:
            self._inject_due_arrivals()
            self._process_cancellations()
            if not sch.busy():
                if self._pending_forks:
                    # idle with only fork children left: their parents
                    # ended, so their fallback prefills land now
                    self._try_forks()
                    if sch.busy():
                        continue
                if self._tick_arrivals:
                    # ticks cannot advance: land the earliest batch now
                    self._inject_due_arrivals(force_next=True)
                    continue
                if self._closed:
                    break
                await self._wait_for_arrival()
                continue
            iters += 1
            if not any(not s.free for s in sch.slots):
                await self._admit_and_prefill()
                if sch.queue and not any(not s.free for s in sch.slots):
                    # last resort: unpin spills' retained shared
                    # references (cache entries and spills co-holding
                    # blocks deadlock decay against preemption)
                    if eng._demote_spilled_shared():
                        await self._admit_and_prefill()
                if sch.queue and not any(not s.free for s in sch.slots):
                    # nothing runs, so the pool can never change and the
                    # watermark refuses every queued request for good
                    raise RuntimeError(
                        f"admission livelock: {len(sch.queue)} queued "
                        f"request(s), nothing running or preemptible, and "
                        f"the global pool ({eng.num_pool_blocks} blocks) "
                        f"is below the smallest request's watermark "
                        f"estimate — the pool cannot serve even one "
                        f"request")
                continue
            res = eng.generate()
            if res is None:
                continue         # headroom preempted everything this round
            self._log("dispatch", tick=res.tick)
            # park off-thread while the host copies land; consumers woken
            # by the previous iteration's tokens run now
            await asyncio.get_running_loop().run_in_executor(None, res.block)
            eng.consume(res)
            self._log("consume", tick=res.tick)
            self._drain_retrace_events()
            toks, logits = res.tokens_host, res.logits_host
            if res.packed:
                # trip by trip: finished slots leave active_slots() for
                # the later trips, as between separate ticks
                valid = res.valid_host
                for t in range(res.trips_host):
                    for slot in sch.active_slots():
                        if valid[t][slot.idx]:
                            self._record_logits(slot.request,
                                                logits[t][slot.idx])
                            self._finish_token(slot, int(toks[t][slot.idx]),
                                               res.base_tick + t + 1)
            else:
                for slot in sch.active_slots():
                    self._record_logits(slot.request, logits[slot.idx])
                    self._finish_token(slot, int(toks[slot.idx]), res.tick)
            await self._admit_and_prefill()
        self._drain_retrace_events()   # events from trailing prefills
        if eng.device.type == "cuda":
            await asyncio.get_running_loop().run_in_executor(
                None, torch.cuda.synchronize, eng.device)
        eng.metrics["wall_s"] = time.perf_counter() - self._t0
        return sch.finished

    async def _wait_for_arrival(self) -> None:
        self._arrival_event.clear()
        # re-check under the cleared flag: a submit or cancel between the
        # busy check and the clear would otherwise be missed
        if self.engine.scheduler.busy() or self._cancel_pending \
                or self._closed:
            return
        await self._arrival_event.wait()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _try_forks(self) -> None:
        """Land pending fork children: a child whose parent is decoding (in
        a slot, at least one token written) takes a free slot through
        ``fork_slot`` and inherits the parent's tokens so far, delivered
        through its stream at the fork's tick; a child whose parent
        finished or was cancelled falls back to the queue (a prefill of
        the shared prompt); the others wait."""
        eng = self.engine
        sch = eng.scheduler
        if not self._pending_forks:
            return
        still = []
        for parent_req, child_stream in self._pending_forks:
            child = child_stream.request
            if child_stream.cancelled or child.done:
                continue
            if parent_req.state in (RequestState.FINISHED,
                                    RequestState.CANCELLED):
                sch.enqueue_stamped(child)
                self._log("fork_fallback", arrival=child.arrival)
                continue
            pslot = next((s for s in sch.slots
                          if s.request is parent_req), None)
            if pslot is None or eng._slot_ntok[pslot.idx] == 0:
                still.append((parent_req, child_stream))
                continue        # parent queued, preempted or not started
            slot = next((s for s in sch.slots if s.free), None)
            if slot is None:
                still.append((parent_req, child_stream))
                continue
            eng.fork_slot(pslot.idx, slot.idx, child.arrival)
            sch.place(child, slot, tokens_out=pslot.tokens_out)
            child.output = list(parent_req.output)
            now = time.perf_counter()
            tick = eng.metrics["ticks"]
            rm = self.request_metrics.get(child.arrival)
            for tok in child.output:
                if rm is not None:
                    rm["tokens"] += 1
                    rm["token_ticks"].append(tick)
                    rm["last_token_wall"] = now
                    if rm["first_token_wall"] is None:
                        rm["first_token_wall"] = now
                        rm["first_token_tick"] = tick
                if not child_stream.cancelled:
                    child_stream._queue.put_nowait((tick, tok))
            eng.metrics["admissions"] += 1
            eng.metrics["queue_wait_ticks"] += \
                eng.metrics["ticks"] - eng._queued_at.pop(
                    child.arrival, eng.metrics["ticks"])
            self._mark_admitted(child)
            self._log("fork", arrival=child.arrival,
                      parent=parent_req.arrival,
                      at_tokens=int(pslot.tokens_out))
        self._pending_forks = still

    async def _admit_and_prefill(self) -> None:
        eng = self.engine
        sch = eng.scheduler
        self._try_forks()
        while True:
            if not sch.queue or all(not s.free for s in sch.slots):
                break       # the gate reads device state: skip it when
                            # nothing could be admitted
            newly = sch.admit(eng._admission_gate())
            if not newly:
                break
            for slot in newly:
                req = slot.request
                if req is None:
                    continue    # vacated mid-sweep
                eng.metrics["admissions"] += 1
                eng.metrics["queue_wait_ticks"] += \
                    eng.metrics["ticks"] - eng._queued_at.pop(
                        req.arrival, eng.metrics["ticks"])
                self._mark_admitted(req)
                st = eng._spilled.pop(req.arrival, None)
                if st is not None:
                    self._log("resume", arrival=req.arrival)
                    if not eng._resume(slot, st):
                        # an earlier admission this sweep overclaimed past
                        # its estimate: re-spill, re-queue, and let the
                        # next sweep's gate see the true counts
                        eng._spilled[req.arrival] = st
                        sch.preempt(slot)
                        eng._queued_at[req.arrival] = eng.metrics["ticks"]
                    continue
                # yield once so running requests' consumers drain while
                # this prefill runs (prefill overlaps decode)
                await asyncio.sleep(0)
                self._log("prefill", arrival=req.arrival,
                          decoding=sum(1 for s in sch.active_slots()
                                       if s is not slot
                                       and s.tokens_out > 0))
                prefix = eng.prefill(req.prompt, slot.idx,
                                     arrival=req.arrival)
                eng.insert(prefix, slot.idx)
                self._record_logits(req, prefix.logits)
                self._finish_token(slot, prefix.first_token,
                                   int(eng.metrics["ticks"]))
        self._try_forks()

    def _adopt_existing(self) -> None:
        """Requests submitted straight to the engine, or left mid-flight by
        an earlier episode, get metrics entries (no streams)."""
        eng = self.engine
        now = time.perf_counter()
        reqs = list(eng.scheduler.queue) + \
            [s.request for s in eng.scheduler.active_slots()]
        for req in reqs:
            self.request_metrics.setdefault(req.arrival, {
                "submit_wall": now,
                "submit_tick": int(eng.metrics["ticks"]),
                "admit_wall": None, "admit_tick": None,
                "first_token_wall": None, "first_token_tick": None,
                "last_token_wall": None, "tokens": 0, "token_ticks": []})

    def _inject_due_arrivals(self, force_next: bool = False) -> None:
        eng = self.engine
        due = [t for t in self._tick_arrivals
               if t[0] <= eng.metrics["ticks"]]
        if not due and force_next and self._tick_arrivals:
            due = [self._tick_arrivals[0]]
        for entry in due:
            self._tick_arrivals.remove(entry)
            stream = entry[2]
            if stream.cancelled:
                continue        # cancelled before it ever arrived
            self._submit_now(stream)

    # ------------------------------------------------------------------
    # per-token bookkeeping + streaming fan-out
    # ------------------------------------------------------------------

    def _finish_token(self, slot, tok: int, tick: int) -> bool:
        """Book one generated token (feed, stream, timings); retire the
        request when it is done.  Returns done."""
        eng = self.engine
        req = slot.request
        req.output.append(tok)
        slot.tokens_out += 1
        eng._feed[slot.idx] = tok
        now = time.perf_counter()
        rm = self.request_metrics.get(req.arrival)
        if rm is not None:
            rm["tokens"] += 1
            rm["token_ticks"].append(tick)
            rm["last_token_wall"] = now
            if rm["first_token_wall"] is None:
                rm["first_token_wall"] = now
                rm["first_token_tick"] = tick
        stream = self.streams.get(req.arrival)
        if stream is not None and not stream.cancelled:
            stream._queue.put_nowait((tick, tok))
        done = slot.tokens_out >= req.max_new_tokens or \
            (req.eos_token is not None and tok == req.eos_token)
        if done:
            req.stats = eng.slot_stats(slot.idx)
            req.stats["preemptions"] = req.preemptions
            if eng.drift_probe:
                # quality telemetry: the finished request's recorded
                # logits against the uncompressed dense replay
                drift = eng.measure_drift(
                    req.prompt, req.output,
                    eng.request_logits.get(req.arrival, []))
                req.stats["drift"] = drift
                self._log("drift", arrival=req.arrival, tick=tick, **drift)
            eng.scheduler.retire(slot)
            eng.free_resource(slot.idx)
            self._log("finish", arrival=req.arrival, tick=tick)
            if stream is not None:
                stream._queue.put_nowait(_END)
                stream._done.set()
        return done

    def _record_logits(self, req, logits) -> None:
        if self.engine.record_logits:
            self.engine.request_logits.setdefault(
                req.arrival, []).append(np.asarray(logits))

    def _mark_admitted(self, req) -> None:
        rm = self.request_metrics.get(req.arrival)
        if rm is not None and rm["admit_wall"] is None:
            rm["admit_wall"] = time.perf_counter()
            rm["admit_tick"] = int(self.engine.metrics["ticks"])

    # ------------------------------------------------------------------
    # cancellation teardown (audited)
    # ------------------------------------------------------------------

    def cancel_request(self, req: Request) -> None:
        """Queue ``req`` for teardown at the next loop boundary (the
        streamless spelling of :meth:`TokenStream.cancel`)."""
        stream = self.streams.get(req.arrival)
        if stream is not None:
            stream.cancel()
            return
        if not req.done:
            self._cancel_pending.append(req)
            self._arrival_event.set()

    def _process_cancellations(self) -> None:
        eng = self.engine
        sch = eng.scheduler
        pending, self._cancel_pending = self._cancel_pending, []
        for req in pending:
            if req.done or req.state is RequestState.FINISHED:
                continue
            self._log("cancel", arrival=req.arrival)
            if req.state is RequestState.RUNNING:
                slot = next(s for s in sch.slots if s.request is req)
                sch.vacate(slot)
                eng.free_resource(slot.idx)    # slot reusable next sweep
            else:          # WAITING or PREEMPTED (or never arrived)
                sch.cancel(req)
                eng.drop_spill(req.arrival)    # retained shared refs
                req.state = RequestState.CANCELLED
                req.done = True
            eng._queued_at.pop(req.arrival, None)
            eng.metrics["cancellations"] += 1
            stream = self._stream_of.get(id(req))
            if stream is not None:
                stream.cancelled = True
                stream._queue.put_nowait(_END)
                stream._done.set()
            if self.audit_on_cancel:
                eng.audit_pool()     # raises on a leak or double-free

    # ------------------------------------------------------------------
    # metrics log + derived summaries
    # ------------------------------------------------------------------

    def _log(self, kind: str, **kw) -> None:
        self.events.append({
            "seq": len(self.events), "kind": kind,
            "tick": kw.pop("tick", int(self.engine.metrics["ticks"])),
            "wall": time.perf_counter() - (self._t0 or time.perf_counter()),
            **kw})

    def _drain_retrace_events(self) -> None:
        """Fold ``analysis.RetraceGuard`` events into the metrics log as
        ``kind="retrace"`` (a kernel library built or loaded by an entry
        point); steady-state serving must log none after warmup."""
        guard = getattr(self.engine, "_retrace_guard", None)
        if guard is None:
            return
        for ev in guard.drain_new_events():
            self._log("retrace", entry=ev.entry,
                      call_index=ev.call_index, steady=ev.steady)

    def request_summary(self) -> Dict[int, Dict]:
        """Per-request {ttft_s, ttft_ticks, tpot_s, queue_wait_*, tokens}
        by arrival stamp (requests with a first token only)."""
        out = {}
        for arrival, rm in self.request_metrics.items():
            if rm["first_token_wall"] is None:
                continue
            n = rm["tokens"]
            span = rm["last_token_wall"] - rm["first_token_wall"]
            out[arrival] = {
                "ttft_s": rm["first_token_wall"] - rm["submit_wall"],
                "ttft_ticks": rm["first_token_tick"] - rm["submit_tick"],
                "tpot_s": span / (n - 1) if n > 1 else 0.0,
                "queue_wait_s": (rm["admit_wall"] - rm["submit_wall"])
                if rm["admit_wall"] is not None else None,
                "queue_wait_ticks": (rm["admit_tick"] - rm["submit_tick"])
                if rm["admit_tick"] is not None else None,
                "tokens": n,
            }
        return out

    def percentiles(self, keys=("ttft_s", "tpot_s", "queue_wait_ticks"),
                    qs=(50, 99)) -> Dict[str, Dict[str, float]]:
        """p50/p99 over completed requests for the given summary keys."""
        summaries = list(self.request_summary().values())
        out = {}
        for key in keys:
            vals = [s[key] for s in summaries if s.get(key) is not None]
            if vals:
                out[key] = {f"p{q}": float(np.percentile(vals, q))
                            for q in qs}
        return out

    def prefill_overlaps_decode(self) -> bool:
        """True iff some request's prefill event lies strictly inside
        another request's decode window (it generated tokens at or before
        the prefill's tick and after it)."""
        for ev in self.events:
            if ev["kind"] != "prefill":
                continue
            for arrival, rm in self.request_metrics.items():
                if arrival == ev.get("arrival"):
                    continue
                ticks = rm["token_ticks"]
                if any(t <= ev["tick"] for t in ticks) and \
                        any(t > ev["tick"] for t in ticks):
                    return True
        return False

    def stream_overlaps_dispatch(self) -> bool:
        """True iff some tick-N token was delivered after tick N+1 was
        dispatched and before it was consumed (the log is totally ordered
        by ``seq``)."""
        windows = {}           # tick -> (dispatch_seq, consume_seq)
        for ev in self.events:
            if ev["kind"] == "dispatch":
                windows[ev["tick"]] = [ev["seq"], None]
            elif ev["kind"] == "consume" and ev["tick"] in windows:
                windows[ev["tick"]][1] = ev["seq"]
        for ev in self.events:
            if ev["kind"] != "deliver":
                continue
            nxt = windows.get(ev["tick"] + 1)
            if nxt and nxt[1] is not None and nxt[0] < ev["seq"] < nxt[1]:
                return True
        return False
