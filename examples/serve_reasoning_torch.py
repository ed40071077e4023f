"""End-to-end example of the PyTorch port: batched reasoning-model serving
with ThinKV (the port's counterpart of ``examples/serve_reasoning.py``,
with its flags and its lines; only the tok/s line names the device and
backend that served).

    PYTHONPATH=src python examples/serve_reasoning_torch.py [--requests 8] \\
        [--stream] [--samples N] [--ticks-per-dispatch N] [--device cpu]

Continuous batching through the ThinKV engine on a reduced
DeepSeek-R1-Distill-Llama architecture (the paper's model family):
requests stream through fixed slots, each slot's KV cache is
thought-adaptively quantized (TBQ), segment-annealed (TBE), and paged with
in-place slot reuse (CT).  Sampling at temperature 0.7 on each request's
own key stream, as the reference samples.

``--stream`` serves the same workload through the asyncio orchestrator
(``repro_torch.serving.orchestrator``): each request gets an ``async for
token in stream`` iterator, arrivals are staggered (request i after 2i
ticks) so waiting requests prefill while running ones decode, and TTFT /
TPOT are reported.  ``--samples n`` serves n candidate continuations per
prompt by COW-forking a mid-decode slot (implies ``--stream``);
``--ticks-per-dispatch N`` fuses up to N decode ticks into one dispatch.

Without ``--device`` it runs on the card on the engine's kernel backend:
each decode tick is one K1 launch, each prefill chunk a K2 and a K3
launch per layer, each commit one K4 launch.  With ``--device cpu`` the
engine runs its reference backend (the plain versions).  Tensor-parallel
serving is the full launcher's (``python -m repro_torch.launch.serve
--mesh model=N``).
"""
import argparse
import asyncio
import time

import numpy as np

from repro_torch.config import ServeConfig, ThinKVConfig
from repro_torch.configs import get_smoke_config
from repro_torch.serving.engine import ThinKVEngine
from repro_torch.serving.orchestrator import Orchestrator


def run_streamed(eng, prompts, max_new, samples=1):
    """Streamed serving: one consumer task per request drains its ``async
    for`` token stream; request i enters the queue after 2i engine ticks;
    ``samples=n`` attaches n - 1 COW-forked sibling streams per request.
    Returns (finished requests, orchestrator, parent streams)."""
    orch = Orchestrator(eng)

    async def consume(stream):
        toks = []
        async for tok in stream:
            toks.append(tok)
        return stream, toks

    async def go():
        streams = [orch.schedule_arrival(after_tick=2 * i, prompt=p,
                                         max_new_tokens=max_new,
                                         uid=i if samples == 1 else None,
                                         samples_per_slot=samples)
                   for i, p in enumerate(prompts)]
        consumers = [asyncio.ensure_future(consume(s))
                     for parent in streams
                     for s in (parent, *parent.forks)]
        orch.close()
        done = await orch.serve()
        drained = [await c for c in consumers]
        return done, drained, streams

    done, drained, streams = asyncio.run(go())
    for stream, toks in drained:
        if list(stream.request.output) != list(toks):
            raise RuntimeError(f"stream of request {stream.request.uid} "
                               f"lost a token")
    return done, orch, streams


def main(argv=None, params=None):
    """Serve and report; ``params`` are the weights to serve (random from
    the config's seed when None).  Returns (finished requests, engine)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--stream", action="store_true",
                    help="serve via the asyncio orchestrator: streaming "
                         "token delivery with staggered arrivals")
    ap.add_argument("--samples", type=int, default=1,
                    help="best-of-n: serve n COW-forked candidate "
                         "continuations per prompt (implies --stream)")
    ap.add_argument("--ticks-per-dispatch", type=int, default=1,
                    help="fuse up to N decode ticks into one dispatch")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.samples > 1:
        args.stream = True            # forks land via the orchestrator

    mcfg = get_smoke_config("r1-llama-8b")
    tk = ThinKVConfig(refresh_interval=16, group_size=8, block_size=8,
                      token_budget=args.budget,
                      retention_schedule=(32, 16, 8, 4), min_retention=4,
                      max_segments=128, kmeans_iters=4)
    eng = ThinKVEngine(ServeConfig(model=mcfg, thinkv=tk,
                                   max_seqs=args.slots, temperature=0.7),
                       params=params, device=args.device,
                       ticks_per_dispatch=args.ticks_per_dispatch,
                       allow_forks=args.samples > 1)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mcfg.vocab_size, int(rng.integers(8, 24)))
               for _ in range(args.requests)]

    t0 = time.time()
    streams = None
    if args.stream:
        done, orch, streams = run_streamed(eng, prompts, args.max_new,
                                           samples=args.samples)
    else:
        eng.submit(prompts, max_new_tokens=args.max_new)
        done = eng.run()
    wall = time.time() - t0

    mode = "streamed" if args.stream else "served"
    print(f"\n{mode} {len(done)} requests on {args.slots} slots "
          f"in {wall:.1f}s ({eng.metrics['tokens'] / wall:.1f} tok/s "
          f"{eng.device.type}, {eng.backend})")
    if args.stream:
        pct = orch.percentiles()
        if "ttft_s" in pct and "tpot_s" in pct:
            print(f"  TTFT p50 {pct['ttft_s']['p50'] * 1e3:.0f}ms / "
                  f"p99 {pct['ttft_s']['p99'] * 1e3:.0f}ms | "
                  f"TPOT p50 {pct['tpot_s']['p50'] * 1e3:.0f}ms | "
                  f"prefill-overlapped-decode="
                  f"{orch.prefill_overlaps_decode()}")
    for r in done:
        print(f"  req {r.uid}: {len(r.output)} tokens | "
              f"cache {max(r.stats['valid_tokens'])} toks "
              f"({r.stats['footprint_frac'] * 100:.1f}% of FullKV) | "
              f"avg {r.stats['avg_bits']:.2f} bits")
    if args.samples > 1:
        m = eng.metrics
        print(f"\nbest-of-{args.samples}: {m['forks']} COW forks shared "
              f"prompt+CoT blocks (peak refcount {m['peak_refcount']}, "
              f"{m['fork_cow_faults']} divergence COW faults)")
        for parent in streams:
            group = [parent, *parent.forks]
            lens = [len(s.request.output) for s in group]
            # a real deployment scores the n candidates with a verifier /
            # reward model here and keeps the argmax
            print(f"  prompt {parent.request.uid}: {len(group)} "
                  f"candidates of {lens} tokens")
    return done, eng


if __name__ == "__main__":
    main()
