"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

Ports the synchronous path of ``repro/launch/serve.py``: the ThinKV engine
serves synthetic prompts (random tokens from seed 0) greedily and reports
throughput and compression in the reference's line

    served N requests | T tokens in Ws (tok/s) | footprint | bits

The flags and their defaults are the reference's (``--arch --full
--requests --slots --prompt-len --max-new --budget --tau --group
--backend --temperature``), plus ``--device`` (the card unless ``cpu`` is
asked for).  ``--temperature`` takes 0 only; the pool is never
oversubscribed.  Streaming, preemption, the prefix cache, multi-tick
dispatch, forks, tensor parallelism, the drift probe and other policies
are not ported yet (ROADMAP queue 1 items 10-14).

    python -m repro_torch.launch.serve --full --backend kernel --temperature 0
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.config import ServeConfig, ThinKVConfig
from repro_torch.configs import ARCHS, get_config, get_smoke_config
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
    eng = ThinKVEngine(cfg, backend=args.backend, device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mcfg.vocab_size, args.prompt_len)
               .astype(np.int64) for _ in range(args.requests)]
    eng.submit(prompts, max_new_tokens=args.max_new)
    done = eng.run()
    toks, wall = eng.metrics["tokens"], eng.metrics["wall_s"]
    fr = np.mean([r.stats["footprint_frac"] for r in done])
    bits = np.mean([r.stats["avg_bits"] for r in done])
    print(f"served {len(done)} requests [policy=thinkv] | {toks} tokens in "
          f"{wall:.1f}s ({toks / wall:.1f} tok/s {eng.device.type}, "
          f"{eng.backend}) | mean footprint {fr * 100:.2f}% of FullKV | "
          f"avg {bits:.2f} bits")
    print(f"pool {eng.num_pool_blocks} blocks | {eng.metrics['ticks']} ticks"
          f" | {eng.metrics['prefill_chunks']} g-chunks + "
          f"{eng.metrics['prefill_big_chunks']} big chunks | audit "
          f"{eng.audit_pool()['claimed'][:4]} claimed")


if __name__ == "__main__":
    main()
