"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

Ports the synchronous path of ``repro/launch/serve.py``: the ThinKV engine
serves synthetic prompts (random tokens from seed 0) and reports
throughput and compression in the reference's line

    served N requests | T tokens in Ws (tok/s) | footprint | bits

The flags and their defaults are the reference's (``--arch --full
--requests --slots --prompt-len --max-new --budget --tau --group
--backend --temperature --top-p --ticks-per-dispatch --pool-blocks
--pool-frac --prefix-cache --shared-prefix-frac --expect-multi-tick``),
but ``--temperature`` defaults to 0 (greedy; the reference's is 0.8), plus
``--device`` (the card unless ``cpu`` is asked for).  ``--temperature`` >
0 samples on per-request key streams (``--top-p`` < 1 nucleus);
``--ticks-per-dispatch`` N fuses up to N ticks into one dispatch and
prints the reference's mega-dispatch line; ``--expect-multi-tick`` (N > 1,
greedy) fails unless packs ran more than one tick, some pack exited
early, the pool audit is clean and a second engine serving the same
requests one tick per dispatch gives the same tokens.  ``--pool-frac`` (or
``--pool-blocks``) oversubscribes the shared pool, so requests are
preempted and resumed; ``--prefix-cache`` shares prompt prefixes
copy-on-write (``--shared-prefix-frac`` gives every prompt a common head).
The run then prints the preemption, COW and prefix-cache counters and
audits the pool, as the reference does.  Streaming and the gates that
need it (``--stream``, ``--samples-per-slot``, ``--arrival-rate``), the
other gates (``--priorities``, ``--expect-all``, ``--expect-preemptions``,
``--expect-prefix-hits``), tensor parallelism, the drift probe and other
policies are not ported yet (ROADMAP queue 1 items 12-14).

    python -m repro_torch.launch.serve --full --backend kernel --temperature 0
    python -m repro_torch.launch.serve --device cpu --pool-frac 0.6 \
        --prefix-cache --shared-prefix-frac 0.5
    python -m repro_torch.launch.serve --device cpu --temperature 0.7 \
        --top-p 0.9 --ticks-per-dispatch 4
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.config import ServeConfig, ThinKVConfig
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core import ct_cache as CC
from repro_torch.serving.engine import ThinKVEngine


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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable copy-on-write prefix caching: requests "
                         "whose prompt extends a cached prefix share its "
                         "physical blocks (refcounted) and skip the "
                         "covered prefill chunks")
    ap.add_argument("--shared-prefix-frac", type=float, default=0.0,
                    help="fraction of every prompt shared across requests "
                         "(1.0 = identical prompts)")
    ap.add_argument("--expect-multi-tick", action="store_true",
                    help="gate (needs --ticks-per-dispatch > 1, greedy): "
                         "fail unless mean ticks/dispatch > 1 with >= 1 "
                         "early pack exit, the pool audit is clean, and a "
                         "second engine serving the requests one tick per "
                         "dispatch emits the same tokens")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.temperature < 0:
        ap.error("--temperature must be >= 0")
    if not 0 < args.top_p <= 1:
        ap.error("--top-p must lie in (0, 1]")
    if args.ticks_per_dispatch < 1:
        ap.error("--ticks-per-dispatch must be >= 1")
    if args.expect_multi_tick and args.ticks_per_dispatch < 2:
        ap.error("--expect-multi-tick requires --ticks-per-dispatch > 1")
    if args.expect_multi_tick and args.temperature > 0:
        ap.error("--expect-multi-tick needs --temperature 0 for the "
                 "bit-exact per-tick parity replay")
    mcfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
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
    eng = ThinKVEngine(cfg, backend=args.backend, device=args.device,
                       pool_blocks=pool_blocks,
                       prefix_cache=args.prefix_cache,
                       ticks_per_dispatch=args.ticks_per_dispatch)
    rng = np.random.default_rng(0)
    shared_len = int(round(args.prompt_len * args.shared_prefix_frac))
    shared = rng.integers(0, mcfg.vocab_size, shared_len)
    prompts = [np.concatenate([
        shared, rng.integers(0, mcfg.vocab_size,
                             args.prompt_len - shared_len)]).astype(np.int64)
        for _ in range(args.requests)]
    eng.submit(prompts, max_new_tokens=args.max_new)
    done = eng.run()
    toks, wall = eng.metrics["tokens"], eng.metrics["wall_s"]
    fr = np.mean([r.stats["footprint_frac"] for r in done])
    bits = np.mean([r.stats["avg_bits"] for r in done])
    print(f"served {len(done)} requests [policy=thinkv] | {toks} tokens in "
          f"{wall:.1f}s ({toks / wall:.1f} tok/s {eng.device.type}, "
          f"{eng.backend}) | mean footprint {fr * 100:.2f}% of FullKV | "
          f"avg {bits:.2f} bits")
    m = eng.metrics
    print(f"pool {eng.num_pool_blocks}/{worst_case} blocks "
          f"({100.0 * eng.num_pool_blocks / worst_case:.0f}% of worst case)"
          f" | {m['preemptions']} preemptions, {m['resumes']} resumes | "
          f"mean queue wait "
          f"{m['queue_wait_ticks'] / max(m['admissions'], 1):.1f} ticks | "
          f"{m['ticks']} ticks | {m['prefill_chunks']} g-chunks + "
          f"{m['prefill_big_chunks']} big chunks")
    if args.ticks_per_dispatch > 1:
        print(f"mega-dispatch: {m['dispatches']} dispatches for "
              f"{m['ticks']} ticks "
              f"({m['ticks'] / max(m['dispatches'], 1):.2f} ticks/dispatch"
              f", {m['dispatches'] / max(m['tokens'], 1):.3f} "
              f"dispatches/token) | early exits: "
              f"{m['early_exit_finish']} finish, "
              f"{m['early_exit_headroom']} headroom | {m['forks']} "
              f"fork(s), {m['fork_cow_faults']} fork COW faults, peak "
              f"refcount {m['peak_refcount']}")
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
    if args.expect_multi_tick:
        multi_tick_gate(args, cfg, eng, done, prompts, pool_blocks)


def multi_tick_gate(args, cfg, eng, done, prompts, pool_blocks) -> None:
    """The reference's ``--expect-multi-tick`` gate without its streamed
    (fork) part: packs of more than one tick, an early pack exit, a clean
    audit, and the tokens of a second engine serving the same requests one
    tick per dispatch."""
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
    try:
        eng.audit_pool()
    except AssertionError as e:
        fails.append(f"pool audit: {e}")
    ref = ThinKVEngine(cfg, params=eng.model, backend=eng.backend,
                       device=eng.device, pool_blocks=pool_blocks,
                       prefix_cache=args.prefix_cache)
    ref.submit([p.copy() for p in prompts], max_new_tokens=args.max_new)
    if {r.uid: r.output for r in done} != \
            {r.uid: r.output for r in ref.run()}:
        fails.append("outputs differ from the per-tick replay")
    try:
        ref.audit_pool()
    except AssertionError as e:
        fails.append(f"per-tick replay pool audit: {e}")
    if fails:
        raise SystemExit("multi-tick gate FAILED: " + "; ".join(fails))
    print(f"multi-tick gate OK: {m['dispatches']} dispatches for "
          f"{m['ticks']} ticks ({mean_tpd:.2f} ticks/dispatch), "
          f"{m['early_exit_finish'] + m['early_exit_headroom']} early "
          f"exit(s), bit-identical to the per-tick loop, both audits clean")


if __name__ == "__main__":
    main()
