"""One run of a cell: the measured program serves the cell's traffic, the
window is timed from the clients' side, and the run's records are kept for
the metrics and the correctness check.

The program is ``repro_torch``'s serving engine (``ThinKVEngine``) driven
by its orchestrator (``Orchestrator.serve``), at the mix's sampling
(greedy unless the mix sets ``temperature``).  The benchmark wraps
two of the engine's entry points on the instance, from its own files:
``generate`` (one decode tick) and ``prefill``.  The wrappers stamp each
tick and prefill on the host, open the window, take the program's
counters at its two ends, start and stop the profiled slice of a
``--trace 1`` run, and note which request each slot holds on each tick
together with the token it feeds and its position (the schedule a
mixture-of-experts reference needs, since such an engine routes a tick's
slots together); where the mix asks (``snapshot_prefill``), the prefill
wrapper also copies each request's prefilled cache for the check.
The mix's kind (``bench/traffic/<kind>.py``) sends the requests, each
through :meth:`Run.send`, an asyncio task that stamps every token as it
reads it from its ``TokenStream``.

Set-up is everything from the process's start to the window: the weights
drawn on the card, the engine built, the kernels loaded from their build
directory, the cell's traffic started and ``warmup_ticks`` engine ticks
run (so every shape of the cell has run once before the window opens).
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchlib import model, profile, roofline, traffic

COUNTERS = ("ticks", "tokens", "prefill_tokens", "prefill_s", "commits")
SLICE_START_AFTER = 4       # ticks into the window before the slice starts
SLICE_MAX_FACTOR = 16       # the slice ends by this many times its ticks
IDLE_GRACE_S = 2.0          # past the window's end, for an idle engine


@dataclasses.dataclass
class Served:
    """One request as its client saw it."""

    client: int
    prompt: np.ndarray
    max_new: int
    arrival: int = -1
    t_send: float = 0.0
    stamps: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False


def snapshot(eng, i: int) -> dict:
    """A copy of slot ``i``'s cache as its prefill left it, in the
    reference's names: the pool planes read through the slot's block table
    into logical order, the slot's metadata, buffer and counters.  The
    check starts the reference's decode from it (``check.py``)."""
    table = eng.tables[i].long().clamp_min(0)                  # [L, NB]
    rows = torch.arange(table.shape[0], device=table.device)[:, None]

    def logical(plane):
        p = plane[rows, table]                     # [L, NB, BS, H, ...]
        return p.reshape(p.shape[0], -1, *p.shape[3:])
    pv, c = eng.pool.view, eng.caches.slot(i)
    return {"k_codes": logical(pv.k_codes), "v_codes": logical(pv.v_codes),
            "k_scales": logical(pv.k_scales),
            "v_scales": logical(pv.v_scales),
            "state": c.slot_state.clone(), "seg": c.slot_seg.clone(),
            "bits": c.slot_bits.clone(),
            "block_type": c.block_type.clone(),
            "seg_type": c.seg_type.clone(),
            "seg_level": c.seg_level.clone(),
            "buf_k": c.buf_k.clone(), "buf_v": c.buf_v.clone(),
            "buf_len": int(c.buf_len), "num_tokens": int(c.num_tokens),
            "cur_seg": int(c.cur_seg), "cur_thought": int(c.cur_thought)}


class Run:
    """Serve ``mix`` on the configuration ``cfg`` for ``seconds`` of
    window, the requests sent by the mix's ``kind`` module.  ``faults``,
    for the harness's own tests, is called with the engine before the
    traffic starts."""

    def __init__(self, name: str, cfg: dict, mix: dict, kind, seed: int,
                 seconds: float, trace: bool, device, t_start: float,
                 faults=None):
        self.name, self.cfg, self.mix, self.kind = name, cfg, mix, kind
        self.seed, self.seconds, self.trace = seed, float(seconds), trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.faults = faults
        self.arch = model.arch(cfg)
        self.tk = cfg["thinkv"]
        self.moe = "experts" in self.arch
        self.served: List[Served] = []
        self.live: Dict[int, object] = {}
        self.tick_t: List[float] = []
        self.prefills: List[tuple] = []      # (t0, t1, prompt_len, arrival)
        self.schedule: List[tuple] = []      # (arrivals, feed, positions)
        self.snapshots: Dict[int, dict] = {}  # arrival -> prefilled cache
        self.ws = self.we = None
        self.c0 = self.c1 = None
        self.slice = None
        self.slice_rec = None
        self.stop = False
        self.kv_mib = None
        self.memory_peak = None
        self.cancelled = set()

    # -- the program --------------------------------------------------------

    def build(self) -> None:
        from repro_torch.serving.engine import ThinKVEngine
        from repro_torch.serving.orchestrator import Orchestrator
        scfg, kw = model.port_config(self.cfg, self.name,
                                     *traffic.sampling(self.mix), self.seed)
        lm = model.port_params(scfg, self.arch, self.seed, self.device)
        self.eng = ThinKVEngine(scfg, params=lm, backend=kw["backend"],
                                prefill_chunk=kw["prefill_chunk"],
                                policy=kw["policy"], device=self.device)
        if self.faults is not None:
            self.faults(self.eng)
        self.orch = Orchestrator(self.eng)
        self._wrap()

    def _counters(self) -> dict:
        return {k: float(self.eng.metrics[k]) for k in COUNTERS}

    def _wrap(self) -> None:
        eng = self.eng
        generate, prefill = eng.generate, eng.prefill

        def tick():
            now = time.perf_counter()
            done = int(eng.metrics["ticks"])
            self.tick_t.append(now)
            if self.moe:
                self.schedule.append((
                    [-1 if s.free else s.request.arrival
                     for s in eng.scheduler.slots],
                    eng._feed.copy(), eng._slot_ntok.copy()))
            if self.ws is None and done >= self.mix["warmup_ticks"]:
                self.ws, self.c0 = now, self._counters()
                self.window_open.set()
            elif self.ws is not None and self.c1 is None and \
                    now >= self.ws + self.seconds:
                self.c1 = self._counters()
            if self.trace:
                self._slice_control(done)
            return generate()

        def pre(prompt, slot_idx, arrival=None):
            t0 = time.perf_counter()
            out = prefill(prompt, slot_idx, arrival=arrival)
            self.prefills.append((t0, time.perf_counter(), len(prompt),
                                  arrival))
            if self.mix.get("snapshot_prefill"):
                self.snapshots[arrival] = snapshot(self.eng, slot_idx)
            return out

        eng.generate, eng.prefill = tick, pre

    def _slice_control(self, done: int) -> None:
        mix = self.mix
        if self.slice is None and self.ws is not None and \
                done >= mix["warmup_ticks"] + SLICE_START_AFTER:
            self.slice = profile.Slice(self.device)
            self.slice_tick0, self.slice_c0 = done, self._counters()
            self.slice.start()
            self.slice_t0 = self.slice.t0
        elif self.slice is not None and self.slice_rec is None:
            ticks = done - self.slice_tick0
            inside = sum(1 for p in self.prefills if p[0] >= self.slice_t0)
            if (ticks >= mix["trace_ticks"] and
                    inside >= mix["trace_min_prefills"]) or \
                    ticks >= SLICE_MAX_FACTOR * mix["trace_ticks"]:
                self._end_slice(done)

    def _end_slice(self, done: int) -> None:
        rec = self.slice.stop()
        rec.update(ticks=done - self.slice_tick0, t0=self.slice_t0,
                   t1=self.slice_t0 + rec["wall_s"],
                   counters={k: v - self.slice_c0[k]
                             for k, v in self._counters().items()},
                   pool=self._pool_state())
        rec["prefills"] = [p for p in self.prefills
                           if p[0] >= rec["t0"] and p[1] <= rec["t1"]]
        rec["t_stopped"] = time.perf_counter()
        self.slice_rec = rec

    def _pool_state(self) -> dict:
        """What the slice's K1 launches read, from the engine's state at
        the slice's end: pool blocks holding a VALID slot, VALID slots and
        buffer entries (over every layer and slot, and over the active
        slots alone)."""
        eng = self.eng
        d = eng.dims
        valid = eng.caches.slot_state == 1                  # [R, L, NS]
        blocks = valid.reshape(*valid.shape[:2], d.NB, d.BS).any(-1)
        n_buf = eng.caches.buf_len.long() + 1               # [R]
        active = torch.tensor([not s.free for s in eng.scheduler.slots],
                              device=valid.device)
        return {"blocks": int(blocks.sum()), "n_valid": int(valid.sum()),
                "n_buf": int(n_buf.sum()) * d.L,
                "active_valid": int(valid[active].sum()),
                "active_buf": int(n_buf[active].sum()) * d.L,
                "active": int(active.sum())}

    # -- the traffic ----------------------------------------------------------

    async def send(self, r) -> Served:
        """Submit the request ``r`` now and read its stream to its end,
        stamping every token; the kinds' ``drive`` sends through this."""
        rec = Served(r.client, r.prompt, r.max_new)
        rec.t_send = time.perf_counter()
        stream = self.orch.submit(r.prompt, max_new_tokens=r.max_new)
        rec.arrival = stream.request.arrival
        self.served.append(rec)
        self.live[rec.arrival] = stream
        async for tok in stream:
            rec.stamps.append(time.perf_counter())
            rec.tokens.append(int(tok))
        self.live.pop(rec.arrival, None)
        rec.finished = len(rec.tokens) >= r.max_new
        return rec

    async def _episode(self) -> None:
        self.window_open = asyncio.Event()
        plan = self.kind.make(self.mix, self.seed, self.arch["vocab"])
        serve = asyncio.ensure_future(self.orch.serve(max_ticks=10 ** 12))
        clients = asyncio.ensure_future(self.kind.drive(self, plan))
        opened = asyncio.ensure_future(self.window_open.wait())
        await asyncio.wait([opened, serve],
                           return_when=asyncio.FIRST_COMPLETED)
        if serve.done():
            serve.result()
            raise RuntimeError("the engine stopped before the window")
        self.we = self.ws + self.seconds
        while True:
            now = time.perf_counter()
            if serve.done():
                serve.result()
                raise RuntimeError("the engine stopped inside the window")
            # the wrappers take the window's end counters and end the slice
            # at a tick; an engine left idle gets them here
            idle = now >= self.we + IDLE_GRACE_S
            if now >= self.we and (self.c1 is not None or idle) and \
                    (not self.trace or self.slice_rec is not None or idle):
                break
            await asyncio.sleep(max(0.0, min(0.05, self.we - now)) or 0.05)
        if self.c1 is None:
            self.c1 = self._counters()
        if self.trace and self.slice is not None and self.slice_rec is None:
            self._end_slice(int(self.eng.metrics["ticks"]))
        if self.slice_rec is not None:
            self.slice_rec.update(self.slice.events())
        self.stop = True
        self._after_window()
        self.cancelled = set(self.live)
        for stream in list(self.live.values()):
            stream.cancel()
        self.orch.close()
        await serve
        await clients

    def _after_window(self) -> None:
        """The KV footprint of the requests in the slots, read from their
        block tables once the window has closed."""
        eng, d = self.eng, self.eng.dims
        rows = [s.idx for s in eng.scheduler.slots if not s.free]
        if not rows:
            return
        mapped = int((eng.tables[rows] >= 0).sum())
        per_block = roofline.paged_per_block(d.BS, eng.ldims.H, d.D)
        buffers = len(rows) * d.L * 2 * d.G * eng.ldims.H * d.D * 2
        self.kv_mib = (mapped * per_block + buffers) / len(rows) / 2 ** 20

    def execute(self) -> None:
        self.build()
        asyncio.run(self._episode())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))

    def release(self) -> None:
        """Free the program's state (and the snapshots of requests not
        compared) before the reference runs."""
        self.eng = self.orch = self.slice = None
        self.snapshots = {}
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- what the window shows ------------------------------------------------

    def end_to_end(self, skip=None) -> Dict[str, float]:
        """The window's end-to-end numbers.  ``skip``, an interval of host
        time, is left out of the token count, the window's seconds and the
        gaps (those that overlap it), for the statistics of a ``--trace 1``
        run outside its profiled slice."""
        ws, we = self.ws, self.we
        a, b = skip if skip is not None else (float("inf"),) * 2
        lost = max(0.0, min(b, we) - max(a, ws))
        stamps = [t for r in self.served for t in r.stamps
                  if not a <= t <= b]
        gaps = [y - x for r in self.served
                for x, y in zip(r.stamps, r.stamps[1:])
                if ws <= y <= we and (y < a or x > b)]
        out = {"setup_s": ws - self.t_start,
               "output_tok_s": sum(ws <= t <= we for t in stamps) /
               (self.seconds - lost)}
        if gaps:
            out["itl_p95_ms"] = float(np.percentile(gaps, 95)) * 1e3
        sent = [r for r in self.served if ws <= r.t_send <= we]
        if sent:
            out["ttft_p50_s"] = float(np.median(
                [r.stamps[0] - r.t_send if r.stamps and r.stamps[0] <= we
                 else np.inf for r in sent]))
        if self.kv_mib is not None:
            out["kv_mib_per_req"] = self.kv_mib
        return out

    def context(self) -> dict:
        """What the per-layer metric readers read."""
        ws, we = self.ws, self.we
        ticks = [t for t in self.tick_t if ws <= t <= we]
        return {
            "arch": self.arch, "thinkv": self.tk,
            "serving": self.cfg["serving"],
            "window_s": self.seconds,
            "counters": {k: self.c1[k] - self.c0[k] for k in COUNTERS},
            "tick_intervals_s": list(np.diff(ticks)),
            "slice": self.slice_rec,
            "params_in_products": model.params_in_products(self.arch),
            "end_to_end": self.end_to_end(),
            "unprofiled": self.end_to_end(
                None if self.slice_rec is None else
                (self.slice_rec["t0"], self.slice_rec["t_stopped"])),
        }

    def attempted(self) -> int:
        return len(self.served)

    def failed(self) -> int:
        """Requests whose stream ended short of their tokens while the
        window was open (a stream the benchmark cancels at the window's
        close has not failed)."""
        return sum(1 for r in self.served
                   if not r.finished and r.arrival not in self.cancelled)

    def device_info(self) -> dict:
        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(self.device),
                "count": 1, "memory_peak_bytes": self.memory_peak}
