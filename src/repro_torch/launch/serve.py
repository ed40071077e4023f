"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

Ports ``repro/launch/serve.py``: the ThinKV engine serves synthetic prompts
(random tokens from seed 0) and reports throughput and compression in the
reference's line

    served N requests | T tokens in Ws (tok/s) | footprint | bits

The flags and their defaults are the reference's, but ``--temperature``
defaults to 0 (greedy; the reference's is 0.8), plus ``--device`` (the
card unless ``cpu`` is asked for):

* the model and cache: ``--arch --full --requests --slots --prompt-len
  --max-new --budget --tau --group --backend --policy`` (``thinkv``,
  ``rkv`` or ``uniform``); ``--arch`` takes every registered config the
  engine serves: r1-llama-8b, qwen2-7b (qkv bias), yi-6b, yi-9b,
  mistral-large-123b, the MoE configs mixtral-8x7b and
  llama4-scout-17b-a16e, and the VLM paligemma-3b (text prompts, as the
  reference's engine serves it; head_dim 256 on the card's kernels);
  falcon-mamba-7b, zamba2-7b and whisper-medium are refused with a
  ValueError that names ``serving/serve_step.py``, which serves them (the
  reference's engine does not serve them either);
* sampling and dispatch: ``--temperature`` (> 0 samples on per-request
  key streams), ``--top-p`` (< 1 nucleus), ``--ticks-per-dispatch`` (N
  fuses up to N ticks into one dispatch; prints the mega-dispatch line),
  ``--samples-per-slot`` (n COW-forked samples per request; needs
  ``--stream``);
* the pool: ``--pool-blocks`` / ``--pool-frac`` oversubscribe it, so
  requests are preempted and resumed; ``--prefix-cache`` shares prompt
  prefixes copy-on-write (``--shared-prefix-frac`` gives every prompt a
  common head); ``--priorities`` (comma-separated, cycled over the
  requests);
* streaming: ``--stream`` serves through the asyncio orchestrator with
  one consumer per token stream and prints the TTFT / TPOT / queue-wait
  percentiles and the overlap line; ``--arrival-rate R`` makes arrivals
  open-loop (Poisson in tick space, ``default_rng(1)``);
* quality: ``--drift-probe`` (needs ``--stream``) replays each finished
  request through the uncompressed dense forward and prints the drift
  line;
* gates, each exiting non-zero on failure: ``--expect-all`` (every
  request finishes with its tokens), ``--expect-preemptions`` (some
  preemption, every victim resumed), ``--expect-prefix-hits`` (a hit,
  tokens skipped, a clean audit), ``--expect-stream-parity`` (greedy: a
  second engine's synchronous run gives bit-identical per-request logits,
  prefill overlapped decode), ``--expect-drift`` (finite drift for every
  request, one probe and one drift event each), ``--expect-multi-tick``
  (greedy: packs of more than one tick, an early exit, clean audits and
  the tokens of a one-tick-per-dispatch replay, streamed when
  ``--stream``; with forks, fork COW faults, shared refcounts and forks
  equal to their parents).

Tensor-parallel serving: ``--mesh model=N`` spawns N ranks
(``launch.mesh.run_ranks``: one process each, a gloo group, every rank on
the card, or on the CPU with ``--device cpu``), each serving the same
traffic over its share of the kv heads; rank 0 prints the lines above and
a ``mesh:`` line.  ``--heads`` / ``--kv-heads`` override the config's head
counts (to make a smoke config head-shardable); a kv-head count that N
does not divide is refused.  ``--expect-mesh-parity`` (the reference's CI
gate) has the ranks drop their engines, then replays the traffic on an
unsharded engine in rank 0: every request's tokens and per-step logits
must be bit-identical and both pool audits clean, or it exits non-zero.
A rank that fails fails the run.

    python -m repro_torch.launch.serve --full --backend kernel --temperature 0
    python -m repro_torch.launch.serve --device cpu --pool-frac 0.6 \
        --prefix-cache --shared-prefix-frac 0.5
    python -m repro_torch.launch.serve --device cpu --temperature 0.7 \
        --top-p 0.9 --ticks-per-dispatch 4
    python -m repro_torch.launch.serve --device cpu --policy rkv \
        --drift-probe --expect-drift --stream
    python -m repro_torch.launch.serve --device cpu --arch mixtral-8x7b
    python -m repro_torch.launch.serve --arch paligemma-3b --full \
        --backend kernel --temperature 0
    python -m repro_torch.launch.serve --device cpu --mesh model=2 \
        --heads 8 --kv-heads 4 --pool-frac 0.6 --prefix-cache \
        --expect-mesh-parity
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import gc

import numpy as np

from repro_torch.config import ServeConfig, ThinKVConfig
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core import ct_cache as CC
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.serving.engine import ThinKVEngine
from repro_torch.serving.orchestrator import Orchestrator


def _run_streamed(eng, args, prompts, priorities):
    """Serve through the asyncio orchestrator: open-loop Poisson arrivals
    in tick space (``default_rng(1)``, deterministic), one consumer task
    per token stream; ``--samples-per-slot n`` attaches ``n - 1``
    COW-forked sibling streams per request.  Returns (finished requests,
    orchestrator, streamed token counts by uid, parent streams)."""
    orch = Orchestrator(eng)
    spr = args.samples_per_slot
    arr_rng = np.random.default_rng(1)
    if args.arrival_rate > 0:
        gaps = arr_rng.exponential(1.0 / args.arrival_rate, len(prompts))
        at_tick = np.floor(np.cumsum(gaps)).astype(int)
    else:
        at_tick = np.zeros(len(prompts), int)

    async def go():
        # fork children draw uids from the orchestrator's counter, so
        # parents take explicit uids only without forks
        streams = [
            orch.schedule_arrival(
                after_tick=int(at_tick[i]), prompt=p,
                max_new_tokens=args.max_new,
                priority=priorities[i] if priorities else 0,
                uid=i if spr == 1 else None, samples_per_slot=spr)
            for i, p in enumerate(prompts)]
        counts = {}

        async def consume(s):
            n = 0
            async for _tok in s:
                n += 1
            counts[s.request.uid] = n

        consumers = [asyncio.ensure_future(consume(s))
                     for parent in streams for s in (parent, *parent.forks)]
        orch.close()
        done = await orch.serve()
        for c in consumers:
            await c
        return done, counts, streams

    done, counts, streams = asyncio.run(go())
    return done, orch, counts, streams


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="r1-llama-8b", choices=ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="the full-width model instead of its smoke size")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--tau", type=int, default=16)
    ap.add_argument("--group", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = disabled)")
    ap.add_argument("--ticks-per-dispatch", type=int, default=1,
                    help="fuse up to N decode ticks into one dispatch "
                         "(sampled tokens feed the next tick on the "
                         "device; a pack exits early at scheduling "
                         "events)")
    ap.add_argument("--samples-per-slot", type=int, default=1,
                    help="serve n samples per request by COW-forking the "
                         "prompt + generated-prefix cache into n logical "
                         "sequences (best-of-n reasoning); needs --stream")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "kernel", "reference"),
                    help="auto: kernel on the card, reference on the CPU")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="physical blocks in the shared pool (default: the "
                         "dense worst case, slots * NB)")
    ap.add_argument("--pool-frac", type=float, default=None,
                    help="pool size as a fraction of the dense worst case "
                         "(e.g. 0.25 oversubscribes 4x; overrides "
                         "--pool-blocks)")
    ap.add_argument("--priorities", type=str, default=None,
                    help="comma-separated priority ints cycled over "
                         "requests (higher = served first, preempted last)")
    ap.add_argument("--expect-all", action="store_true",
                    help="gate: fail unless every request finishes with "
                         "its full --max-new tokens")
    ap.add_argument("--expect-preemptions", action="store_true",
                    help="gate: fail unless at least one preemption + "
                         "resume happened and every victim resumed")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable copy-on-write prefix caching: requests "
                         "whose prompt extends a cached prefix share its "
                         "physical blocks (refcounted) and skip the "
                         "covered prefill chunks")
    ap.add_argument("--shared-prefix-frac", type=float, default=0.0,
                    help="fraction of every prompt shared across requests "
                         "(1.0 = identical prompts)")
    ap.add_argument("--expect-prefix-hits", action="store_true",
                    help="gate: fail unless the run scored >= 1 prefix "
                         "hit with > 0 prefill tokens skipped and a clean "
                         "pool refcount audit")
    ap.add_argument("--stream", action="store_true",
                    help="serve via the asyncio orchestrator: streaming "
                         "token delivery, overlapped prefill/decode, "
                         "per-request TTFT/TPOT/queue-wait percentiles")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrivals at this many requests "
                         "per engine tick (0 = everything up front); needs "
                         "--stream")
    ap.add_argument("--expect-stream-parity", action="store_true",
                    help="gate (needs --stream, greedy): a second engine's "
                         "synchronous run() must give bit-identical "
                         "per-request logits, both pool audits clean")
    ap.add_argument("--mesh", type=str, default=None,
                    help="mesh spec for tensor-parallel serving, e.g. "
                         "model=2 (N ranks, each serving its share of the "
                         "kv heads; kv_heads %% N == 0)")
    ap.add_argument("--heads", type=int, default=None,
                    help="override the arch's query-head count (e.g. to "
                         "make a smoke config head-shardable)")
    ap.add_argument("--kv-heads", type=int, default=None,
                    help="override the arch's kv-head count")
    ap.add_argument("--expect-mesh-parity", action="store_true",
                    help="gate (needs --mesh): replay the traffic on an "
                         "UNSHARDED engine and fail unless every request's "
                         "tokens and logits are bit-identical and both "
                         "pool audits are clean")
    ap.add_argument("--policy", default="thinkv",
                    choices=("thinkv", "rkv", "uniform"),
                    help="retention policy: the paper's thought-adaptive "
                         "one (thinkv), redundancy-aware farthest-point "
                         "retention (rkv), or a uniform 4-bit recency "
                         "baseline (uniform)")
    ap.add_argument("--drift-probe", action="store_true",
                    help="replay every finished request through the "
                         "uncompressed dense forward and report logit "
                         "drift against the serving path (needs --stream)")
    ap.add_argument("--expect-drift", action="store_true",
                    help="gate (needs --drift-probe): fail unless every "
                         "finished request carries finite drift stats")
    ap.add_argument("--expect-multi-tick", action="store_true",
                    help="gate (needs --ticks-per-dispatch > 1, greedy): "
                         "fail unless mean ticks/dispatch > 1 with >= 1 "
                         "early pack exit, the pool audit is clean, and a "
                         "second engine serving the requests one tick per "
                         "dispatch emits the same tokens; with "
                         "--samples-per-slot > 1 also fork COW faults, "
                         "shared refcounts > 1 and forks equal to their "
                         "parents")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def _check_args(ap, args) -> None:
    """The reference's refusals."""
    if args.expect_mesh_parity and not args.mesh:
        ap.error("--expect-mesh-parity requires --mesh")
    if args.temperature < 0:
        ap.error("--temperature must be >= 0")
    if not 0 < args.top_p <= 1:
        ap.error("--top-p must lie in (0, 1]")
    if args.ticks_per_dispatch < 1:
        ap.error("--ticks-per-dispatch must be >= 1")
    if (args.arrival_rate or args.expect_stream_parity) and not args.stream:
        ap.error("--arrival-rate/--expect-stream-parity require --stream")
    if args.expect_stream_parity and args.temperature > 0:
        ap.error("--expect-stream-parity needs --temperature 0: only "
                 "greedy per-request logits are schedule-invariant")
    if args.samples_per_slot > 1 and not args.stream:
        ap.error("--samples-per-slot > 1 requires --stream (forks land "
                 "through the orchestrator)")
    if args.expect_multi_tick and args.ticks_per_dispatch < 2:
        ap.error("--expect-multi-tick requires --ticks-per-dispatch > 1")
    if args.expect_multi_tick and args.temperature > 0:
        ap.error("--expect-multi-tick needs --temperature 0 for the "
                 "bit-exact per-tick parity replay")
    if args.drift_probe and not args.stream:
        ap.error("--drift-probe requires --stream (the probe fires from "
                 "the orchestrator's finish hook)")
    if args.expect_drift and not args.drift_probe:
        ap.error("--expect-drift requires --drift-probe")
    if args.expect_prefix_hits and not args.prefix_cache:
        ap.error("--expect-prefix-hits requires --prefix-cache")


def _model_config(ap, args):
    mcfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if args.heads is not None:
        mcfg = dataclasses.replace(mcfg, num_heads=args.heads)
    if args.kv_heads is not None:
        mcfg = dataclasses.replace(mcfg, num_kv_heads=args.kv_heads)
    if mcfg.num_kv_heads < 1 or mcfg.num_heads % mcfg.num_kv_heads:
        ap.error(f"--heads/--kv-heads must keep num_heads divisible by "
                 f"num_kv_heads (got {mcfg.num_heads} / "
                 f"{mcfg.num_kv_heads})")
    return mcfg


def main(argv=None, params=None):
    """Run the CLI on ``argv``; ``params`` are the weights to serve (random
    from the config's seed when None).  Returns the finished requests
    (rank 0's under ``--mesh``)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)
    mcfg = _model_config(ap, args)
    if not args.mesh:
        return _serve(None, args, mcfg, params)
    try:
        n = M.serve_ranks(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    if not SH.head_shardable(mcfg.num_kv_heads, n):
        ap.error(f"mesh['{SH.SERVE_HEAD_AXIS}']={n} cannot shard "
                 f"{mcfg.num_kv_heads} kv heads (head sharding needs "
                 f"kv_heads % mesh size == 0)")
    if n == 1:
        return _serve(M.make_serve_mesh(args.mesh, 0, args.device), args,
                      mcfg, params)
    return M.run_ranks(_serve, n, args.device, args, mcfg, params)[0]


def _serve(mesh, args, mcfg, params):
    """Serve the traffic on this process's engine (one rank's of ``mesh``,
    when there is one); rank 0 reports and runs the gates.  Returns the
    finished requests."""
    lead = mesh is None or mesh.rank == 0
    tk = ThinKVConfig(refresh_interval=args.tau, group_size=args.group,
                      block_size=args.group, token_budget=args.budget,
                      retention_schedule=(32, 16, 8, 4), min_retention=4,
                      max_segments=256, kmeans_iters=4)
    cfg = ServeConfig(model=mcfg, thinkv=tk, max_seqs=args.slots,
                      temperature=args.temperature, top_p=args.top_p)
    dims = CC.make_dims(tk, mcfg.num_layers, mcfg.num_kv_heads,
                        mcfg.head_dim)
    worst_case = args.slots * dims.NB
    pool_blocks = args.pool_blocks
    if args.pool_frac is not None:
        pool_blocks = max(int(worst_case * args.pool_frac), 1)
    eng = ThinKVEngine(cfg, params=params, backend=args.backend,
                       device=args.device if mesh is None else mesh.device,
                       pool_blocks=pool_blocks,
                       prefix_cache=args.prefix_cache, mesh=mesh,
                       ticks_per_dispatch=args.ticks_per_dispatch,
                       allow_forks=args.samples_per_slot > 1,
                       policy=args.policy, drift_probe=args.drift_probe,
                       record_logits=(args.expect_stream_parity
                                      or args.expect_mesh_parity))
    rng = np.random.default_rng(0)
    shared_len = int(round(args.prompt_len * args.shared_prefix_frac))
    shared = rng.integers(0, mcfg.vocab_size, shared_len)
    prompts = [np.concatenate([
        shared, rng.integers(0, mcfg.vocab_size,
                             args.prompt_len - shared_len)]).astype(np.int64)
        for _ in range(args.requests)]
    priorities = None
    if args.priorities:
        cycle = [int(x) for x in args.priorities.split(",")]
        priorities = [cycle[i % len(cycle)] for i in range(args.requests)]
    orch = streams = counts = None
    if args.stream:
        done, orch, counts, streams = _run_streamed(eng, args, prompts,
                                                    priorities)
    else:
        eng.submit(prompts, max_new_tokens=args.max_new,
                   priorities=priorities)
        done = eng.run()
    if not lead:
        eng.audit_pool()
    else:
        report(args, eng, done, worst_case, orch, counts)
        if mesh is not None:
            print(f"mesh: {mesh.spec} over {mesh.size} ranks (gloo, "
                  f"{eng.device.type}) | kv heads sharded "
                  f"{eng._nshard}-way | one fused launch per tick per rank")
        ctx = dict(args=args, cfg=cfg, eng=eng, done=done, prompts=prompts,
                   priorities=priorities, pool_blocks=pool_blocks, orch=orch,
                   streams=streams)
        for flag, gate in (("expect_all", all_gate),
                           ("expect_preemptions", preemption_gate),
                           ("expect_prefix_hits", prefix_gate),
                           ("expect_stream_parity", stream_parity_gate),
                           ("expect_drift", drift_gate),
                           ("expect_multi_tick", multi_tick_gate)):
            if getattr(args, flag):
                gate(**ctx)
    if args.expect_mesh_parity:
        run = {"outputs": {r.uid: r.output for r in done},
               "logits": eng.request_logits, "audit": eng.audit_pool(),
               "done": len(done)}
        params, backend, dev = eng.model, eng.backend, eng.device
        eng = ctx = None
        gc.collect()
        if lead:
            mesh_parity_gate(args, cfg, params, backend, dev, pool_blocks,
                             prompts, priorities, run)
    return done


def report(args, eng, done, worst_case, orch, counts) -> None:
    """The reference's report lines."""
    toks, wall = eng.metrics["tokens"], eng.metrics["wall_s"]
    fr = np.mean([r.stats["footprint_frac"] for r in done])
    bits = np.mean([r.stats["avg_bits"] for r in done])
    print(f"served {len(done)} requests [policy={args.policy}] | {toks} "
          f"tokens in {wall:.1f}s ({toks / wall:.1f} tok/s "
          f"{eng.device.type}, {eng.backend}) | mean footprint "
          f"{fr * 100:.2f}% of FullKV | avg {bits:.2f} bits")
    if args.drift_probe:
        drifts = [r.stats["drift"] for r in done if "drift" in r.stats]
        if drifts:
            mx = max(d["max_abs"] for d in drifts)
            mean = np.mean([d["mean_abs"] for d in drifts])
            agree = np.mean([d["top1_agree"] for d in drifts])
            print(f"drift probe: {len(drifts)} requests vs uncompressed "
                  f"replay | max |dlogit| {mx:.4f} | mean |dlogit| "
                  f"{mean:.4f} | top-1 agreement {agree * 100:.1f}%")
    m = eng.metrics
    print(f"pool {eng.num_pool_blocks}/{worst_case} blocks "
          f"({100.0 * eng.num_pool_blocks / worst_case:.0f}% of worst case)"
          f" | {m['preemptions']} preemptions, {m['resumes']} resumes | "
          f"mean queue wait "
          f"{m['queue_wait_ticks'] / max(m['admissions'], 1):.1f} ticks | "
          f"{m['ticks']} ticks | {m['prefill_chunks']} g-chunks + "
          f"{m['prefill_big_chunks']} big chunks")
    if args.ticks_per_dispatch > 1 or args.samples_per_slot > 1:
        print(f"mega-dispatch: {m['dispatches']} dispatches for "
              f"{m['ticks']} ticks "
              f"({m['ticks'] / max(m['dispatches'], 1):.2f} ticks/dispatch"
              f", {m['dispatches'] / max(m['tokens'], 1):.3f} "
              f"dispatches/token) | early exits: "
              f"{m['early_exit_finish']} finish, "
              f"{m['early_exit_headroom']} headroom | {m['forks']} "
              f"fork(s), {m['fork_cow_faults']} fork COW faults, peak "
              f"refcount {m['peak_refcount']}")
    if orch is not None:
        pct = orch.percentiles()
        parts = [f"{label} p50 {pct[key]['p50'] * 1e3:.0f}ms / p99 "
                 f"{pct[key]['p99'] * 1e3:.0f}ms"
                 for key, label in (("ttft_s", "TTFT"), ("tpot_s", "TPOT"))
                 if key in pct]
        if "queue_wait_ticks" in pct:
            parts.append(f"queue wait p50 "
                         f"{pct['queue_wait_ticks']['p50']:.1f} / p99 "
                         f"{pct['queue_wait_ticks']['p99']:.1f} ticks")
        rate = f"{args.arrival_rate} req/tick" if args.arrival_rate \
            else "all-at-once"
        print(f"streamed ({rate} open-loop): {sum(counts.values())} tokens "
              f"delivered over {len(counts)} streams | " + " | ".join(parts))
        print(f"overlap: prefill-inside-decode="
              f"{orch.prefill_overlaps_decode()} "
              f"stream-inside-next-tick={orch.stream_overlaps_dispatch()}")
    if args.prefix_cache:
        pc = eng.prefix_cache.stats()
        print(f"prefix cache: {m['prefix_hits']} hits | "
              f"{m['prefix_tokens_skipped']} prefill tokens skipped | "
              f"{m['cow_faults']} COW faults | {pc['entries']} entries, "
              f"{pc['evictions']} evictions")
    try:
        audit = eng.audit_pool()
    except AssertionError as e:
        raise SystemExit(f"pool refcount audit FAILED: {e}")
    print(f"pool refcount audit OK: every reference accounted, claimed + "
          f"free == pool_blocks ({audit['claimed'][:4]} claimed)")


def all_gate(args, done, **_) -> None:
    want = args.requests * max(args.samples_per_slot, 1)
    short = [r for r in done if len(r.output) < args.max_new]
    if len(done) != want or short:
        raise SystemExit(f"oversubscription gate FAILED: {len(done)}/{want} "
                         f"requests finished, {len(short)} with dropped "
                         f"tokens")
    print(f"oversubscription gate OK: {want}/{want} requests completed "
          f"with zero dropped tokens")


def preemption_gate(eng, **_) -> None:
    m = eng.metrics
    if m["preemptions"] < 1 or m["resumes"] != m["preemptions"]:
        raise SystemExit(f"preemption gate FAILED: {m['preemptions']} "
                         f"preemptions / {m['resumes']} resumes — the "
                         f"oversubscribed run never exercised spill/resume "
                         f"(or a victim was never restored)")
    print(f"preemption gate OK: {m['preemptions']} preemption(s), every "
          f"victim resumed")


def prefix_gate(eng, **_) -> None:
    m = eng.metrics
    if m["prefix_hits"] < 1 or m["prefix_tokens_skipped"] <= 0:
        raise SystemExit(f"prefix gate FAILED: {m['prefix_hits']} hits, "
                         f"{m['prefix_tokens_skipped']} tokens skipped — "
                         f"the shared-prefix run never reused a cached "
                         f"prefix")
    print(f"prefix gate OK: {m['prefix_hits']} hit(s), "
          f"{m['prefix_tokens_skipped']} prefill tokens skipped")


def _replay_engine(args, cfg, eng, pool_blocks, **kw) -> ThinKVEngine:
    """A second engine with the first one's weights, backend, device,
    pool and policy."""
    return ThinKVEngine(cfg, params=eng.model, backend=eng.backend,
                        device=eng.device, pool_blocks=pool_blocks,
                        prefix_cache=args.prefix_cache, policy=args.policy,
                        **kw)


def stream_parity_gate(args, cfg, eng, done, prompts, priorities,
                       pool_blocks, orch, **_) -> None:
    """Greedy per-request logits are schedule-invariant: the streamed run
    must reproduce a synchronous run's logits bit for bit."""
    ref = _replay_engine(args, cfg, eng, pool_blocks, record_logits=True)
    ref.submit([p.copy() for p in prompts], max_new_tokens=args.max_new,
               priorities=priorities)
    ref_done = ref.run()
    mismatch = []
    if len(done) != len(ref_done):
        mismatch.append(f"completed {len(done)} vs {len(ref_done)}")
    if set(eng.request_logits) != set(ref.request_logits):
        mismatch.append("recorded-request sets differ")
    out_by_uid = {r.uid: r.output for r in done}
    mismatch += [s.uid for s in ref_done if out_by_uid.get(s.uid) != s.output]
    logit_steps = bad_steps = 0
    for key in set(eng.request_logits) & set(ref.request_logits):
        seq, ref_seq = eng.request_logits[key], ref.request_logits[key]
        if len(seq) != len(ref_seq):
            mismatch.append(f"arrival{key}:steps")
            continue
        for a, b in zip(seq, ref_seq):
            logit_steps += 1
            if a.shape != b.shape or not (a == b).all():
                bad_steps += 1
    try:
        eng.audit_pool()
        ref.audit_pool()
    except AssertionError as e:
        raise SystemExit(f"stream-parity gate FAILED: pool audit: {e}")
    if mismatch or bad_steps:
        raise SystemExit(f"stream-parity gate FAILED: mismatches {mismatch}, "
                         f"{bad_steps}/{logit_steps} non-bit-identical logit "
                         f"steps between the streamed orchestrator and the "
                         f"synchronous run() path")
    if not orch.prefill_overlaps_decode():
        raise SystemExit("stream-parity gate FAILED: the metrics log shows "
                         "no prefill overlapping a running request's decode")
    print(f"stream-parity gate OK: {len(done)} requests, {logit_steps} logit "
          f"steps bit-identical between the streamed orchestrator and the "
          f"synchronous run() path; prefill/decode overlap observed; both "
          f"audits clean")


def mesh_parity_gate(args, cfg, params, backend, device, pool_blocks,
                     prompts, priorities, run) -> None:
    """The sharded run (``run``: its outputs, logits and audit, its engines
    dropped) against an unsharded engine serving the same traffic with the
    same weights: every request's tokens and per-step logits bit-identical
    and both pool audits clean and equal."""
    ref = ThinKVEngine(cfg, params=params, backend=backend, device=device,
                       pool_blocks=pool_blocks,
                       prefix_cache=args.prefix_cache, policy=args.policy,
                       ticks_per_dispatch=args.ticks_per_dispatch,
                       record_logits=True)
    ref.submit([p.copy() for p in prompts], max_new_tokens=args.max_new,
               priorities=priorities)
    ref_done = ref.run()
    mismatch = []
    if run["done"] != len(ref_done):
        mismatch.append(f"completed {run['done']} vs {len(ref_done)}")
    if set(run["logits"]) != set(ref.request_logits):
        mismatch.append("recorded-request sets differ")
    mismatch += [r.uid for r in ref_done
                 if run["outputs"].get(r.uid) != r.output]
    logit_steps = bad_steps = 0
    for key in set(run["logits"]) & set(ref.request_logits):
        seq, ref_seq = run["logits"][key], ref.request_logits[key]
        if len(seq) != len(ref_seq):
            mismatch.append(f"arrival{key}:steps")
            continue
        for a, b in zip(seq, ref_seq):
            logit_steps += 1
            if a.shape != b.shape or not (a == b).all():
                bad_steps += 1
    try:
        audit_s = ref.audit_pool()
    except AssertionError as e:
        raise SystemExit(f"mesh-parity gate FAILED: pool audit: {e}")
    if mismatch or bad_steps or run["audit"] != audit_s:
        raise SystemExit(
            f"mesh-parity gate FAILED: output mismatches {mismatch}, "
            f"{bad_steps}/{logit_steps} non-bit-identical logit steps, "
            f"audits {run['audit']} vs {audit_s}")
    print(f"mesh-parity gate OK: {run['done']} requests, {logit_steps} "
          f"logit steps bit-identical between --mesh {args.mesh} and the "
          f"unsharded engine; both audits clean")


def drift_gate(eng, done, orch, **_) -> None:
    drifts = [r.stats.get("drift") for r in done]
    missing = sum(1 for d in drifts if d is None)
    bad = [d for d in drifts if d is not None and
           not (np.isfinite(d["max_abs"]) and np.isfinite(d["mean_abs"])
                and d["steps"] > 0)]
    events = sum(1 for e in orch.events if e["kind"] == "drift")
    if missing or bad or eng.metrics["drift_probes"] != len(done) or \
            events != len(done):
        raise SystemExit(f"drift gate FAILED: {missing} request(s) without "
                         f"drift stats, {len(bad)} with non-finite/empty "
                         f"stats, {eng.metrics['drift_probes']} probes and "
                         f"{events} drift events for {len(done)} requests")
    agree = np.mean([d["top1_agree"] for d in drifts])
    print(f"drift gate OK: {len(done)}/{len(done)} requests probed against "
          f"the uncompressed replay, all stats finite, top-1 agreement "
          f"{agree * 100:.1f}%")


def multi_tick_gate(args, cfg, eng, done, prompts, priorities, pool_blocks,
                    streams, **_) -> None:
    """Packs of more than one tick, an early pack exit, a clean audit, and
    the tokens of a second engine serving the same requests one tick per
    dispatch (streamed when the run was, with its forks); with forks also
    fork COW faults, refcounts above 1 and forks equal to their parents."""
    m = eng.metrics
    fails = []
    mean_tpd = m["ticks"] / max(m["dispatches"], 1)
    if mean_tpd <= 1.0:
        fails.append(f"mean ticks/dispatch {mean_tpd:.2f} <= 1")
    if m["dispatches"] / max(m["tokens"], 1) >= 1.0:
        fails.append("Python dispatches per decoded token >= 1")
    if m["early_exit_finish"] + m["early_exit_headroom"] < 1:
        fails.append("no early pack exit observed (finish or headroom) — "
                     "the trace never hit a scheduling event mid-pack")
    if args.samples_per_slot > 1:
        if m["forks"] < 1:
            fails.append("no COW fork ever landed")
        if m["peak_refcount"] < 2:
            fails.append("shared-prefix refcounts never exceeded 1")
        if m["fork_cow_faults"] < 1:
            fails.append("no COW fault on a forked slot — divergence never "
                         "paid the copy (lengthen --max-new past --budget)")
        diverged = sum(1 for parent in streams for child in parent.forks
                       if child.request.output != parent.request.output)
        if diverged:
            fails.append(f"{diverged} greedy fork(s) diverged from their "
                         f"parent's tokens")
    try:
        eng.audit_pool()
    except AssertionError as e:
        fails.append(f"pool audit: {e}")
    ref = _replay_engine(args, cfg, eng, pool_blocks,
                         allow_forks=args.samples_per_slot > 1)
    if args.stream:
        _, _, _, ref_streams = _run_streamed(
            ref, args, [p.copy() for p in prompts], priorities)
        bad = sum(1 for a, b in zip(streams, ref_streams)
                  for x, y in zip((a, *a.forks), (b, *b.forks))
                  if x.request.output != y.request.output)
        if bad:
            fails.append(f"{bad} stream(s) not bit-identical to the "
                         f"per-tick replay")
    else:
        ref.submit([p.copy() for p in prompts], max_new_tokens=args.max_new,
                   priorities=priorities)
        if {r.uid: r.output for r in done} != \
                {r.uid: r.output for r in ref.run()}:
            fails.append("outputs differ from the per-tick replay")
    try:
        ref.audit_pool()
    except AssertionError as e:
        fails.append(f"per-tick replay pool audit: {e}")
    if fails:
        raise SystemExit("multi-tick gate FAILED: " + "; ".join(fails))
    forked = (f", {m['forks']} fork(s) sharing prefix blocks (peak refcount "
              f"{m['peak_refcount']}, {m['fork_cow_faults']} fork COW "
              f"faults, every fork token-identical to its parent)"
              if args.samples_per_slot > 1 else "")
    print(f"multi-tick gate OK: {m['dispatches']} dispatches for "
          f"{m['ticks']} ticks ({mean_tpd:.2f} ticks/dispatch), "
          f"{m['early_exit_finish'] + m['early_exit_headroom']} early "
          f"exit(s), bit-identical to the per-tick loop, both audits "
          f"clean{forked}")


if __name__ == "__main__":
    main()
