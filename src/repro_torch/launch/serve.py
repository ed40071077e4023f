"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

Ports the synchronous path of ``repro/launch/serve.py``: the ThinKV engine
serves synthetic prompts (random tokens from seed 0) greedily and reports
throughput and compression in the reference's line

    served N requests | T tokens in Ws (tok/s) | footprint | bits

The flags and their defaults are the reference's (``--arch --full
--requests --slots --prompt-len --max-new --budget --tau --group
--backend --temperature --pool-blocks --pool-frac --prefix-cache
--shared-prefix-frac``), plus ``--device`` (the card unless ``cpu`` is
asked for).  ``--temperature`` takes 0 only.  ``--pool-frac`` (or
``--pool-blocks``) oversubscribes the shared pool, so requests are
preempted and resumed; ``--prefix-cache`` shares prompt prefixes
copy-on-write (``--shared-prefix-frac`` gives every prompt a common head).
The run then prints the preemption, COW and prefix-cache counters and
audits the pool, as the reference does.  Streaming and the CI gates
(``--stream``, ``--priorities``, ``--expect-*``), multi-tick dispatch,
forks, tensor parallelism, the drift probe and other policies are not
ported yet (ROADMAP queue 1 items 11-14).

    python -m repro_torch.launch.serve --full --backend kernel --temperature 0
    python -m repro_torch.launch.serve --device cpu --pool-frac 0.6 \
        --prefix-cache --shared-prefix-frac 0.5
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
                    help="0 only: sampling at temperature > 0 is not "
                         "ported yet (ROADMAP queue 1 item 11)")
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
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.temperature != 0:
        ap.error("--temperature must be 0: sampling is not ported yet "
                 "(ROADMAP queue 1 item 11)")
    mcfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    tk = ThinKVConfig(refresh_interval=args.tau, group_size=args.group,
                      block_size=args.group, token_budget=args.budget,
                      retention_schedule=(32, 16, 8, 4), min_retention=4,
                      max_segments=256, kmeans_iters=4)
    cfg = ServeConfig(model=mcfg, thinkv=tk, max_seqs=args.slots,
                      temperature=args.temperature)
    dims = CC.make_dims(tk, mcfg.num_layers, mcfg.num_kv_heads,
                        mcfg.head_dim)
    worst_case = args.slots * dims.NB
    pool_blocks = args.pool_blocks
    if args.pool_frac is not None:
        pool_blocks = max(int(worst_case * args.pool_frac), 1)
    eng = ThinKVEngine(cfg, backend=args.backend, device=args.device,
                       pool_blocks=pool_blocks,
                       prefix_cache=args.prefix_cache)
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


if __name__ == "__main__":
    main()
