"""Entry-point contract audit CLI of the port:
``python -m repro_torch.launch.audit [--fail-on-violation] [...]``
(ports ``repro/launch/audit.py``).

For every cell of ``{backends} x {rank counts} x {ticks per dispatch}``
this builds the serving engine on the smoke config (``--heads`` /
``--kv-heads`` override its head counts, 8 / 4 by default, so every rank
count shards) and audits EVERY entry point against its declared
``CompiledContract`` (``repro_torch.analysis.contracts``): exact launches
per kernel, the cross-rank collective whitelist, no fp64; host syncs are
reported per entry point.  Once per run it also audits the standalone K3
entry and the serve steps (one rank).

Cells of more than one rank run through ``launch.mesh.run_ranks`` (the
reference re-execs itself under ``XLA_FLAGS``): every rank audits its
engine, and the cell records rank 0's report and whether every rank's
was clean.

``--retrace`` also streams a small pressure trace (prefix sharing, an
oversubscribed pool, the asyncio orchestrator) under a ``RetraceGuard``
(one rank): after the first warm batch, steady-state serving must build
no kernel library.  The port builds its libraries once per process, at
the first kernel use, so on the card this catches a kernel first reached
after warmup; on the CPU nothing is built and the cell checks only the
guard's bookkeeping (the report's ``builds`` is 0).

The report goes to ``--out`` (``analysis_report.json``); with
``--fail-on-violation`` any violation or steady-state build exits 1.

    python -m repro_torch.launch.audit --device cpu --fail-on-violation
    python -m repro_torch.launch.audit --device cpu --ranks 1,2,4 --retrace
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path


def _build_engine(backend: str, tpd: int, args, mesh=None):
    from repro_torch.config import ServeConfig, ThinKVConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.engine import ThinKVEngine

    mcfg = dataclasses.replace(get_smoke_config(args.arch),
                               num_heads=args.heads,
                               num_kv_heads=args.kv_heads)
    tk = ThinKVConfig(refresh_interval=16, group_size=8, block_size=8,
                      token_budget=args.budget,
                      retention_schedule=(16, 8, 4), min_retention=4,
                      max_segments=64, kmeans_iters=4)
    scfg = ServeConfig(model=mcfg, thinkv=tk, max_seqs=args.slots,
                       temperature=0.0)
    return ThinKVEngine(scfg, backend=backend, mesh=mesh,
                        device=args.device if mesh is None else mesh.device,
                        ticks_per_dispatch=tpd, prefix_cache=args.retrace,
                        drift_probe=True)


def _stream(eng, prompts, max_new: int, stagger: int = 0):
    """Serve ``prompts`` through the asyncio orchestrator (one consumer
    task per token stream), arrivals ``stagger`` ticks apart."""
    import asyncio

    from repro_torch.serving.orchestrator import Orchestrator

    orch = Orchestrator(eng)

    async def go():
        streams = [orch.schedule_arrival(after_tick=i * stagger, prompt=p,
                                         max_new_tokens=max_new)
                   for i, p in enumerate(prompts)]

        async def drain(s):
            async for _tok in s:
                pass

        consumers = [asyncio.ensure_future(drain(s)) for s in streams]
        orch.close()
        done = await orch.serve()
        for c in consumers:
            await c
        return done

    return asyncio.run(go()), orch


def _retrace_cell(backend: str, args) -> dict:
    """The streamed pressure trace under the RetraceGuard: a warmup batch
    (every entry point reached), then a steady phase with other arrivals
    and pool pressure that must build nothing."""
    import numpy as np

    from repro_torch.analysis import RetraceGuard

    eng = _build_engine(backend, args.tpds[0], args)
    rng = np.random.default_rng(0)

    def mk(n, ln):
        return [rng.integers(0, 256, ln) for _ in range(n)]
    with RetraceGuard(eng) as guard:
        _stream(eng, mk(2, args.slots * 4) +
                ([rng.integers(0, 256, eng.prefill_chunk + 8)]
                 if eng.prefill_chunk else []), max_new=8)
        guard.mark_steady()
        shared = rng.integers(0, 256, 12)
        prompts = [np.concatenate([shared, p])
                   for p in mk(args.slots + 2, 6)] + mk(2, 3)
        _, orch = _stream(eng, prompts, max_new=12, stagger=2)
        rep = guard.report()
        rep["retrace_events_logged"] = sum(
            1 for e in orch.events if e["kind"] == "retrace" and e["steady"])
    rep["ok"] = rep["steady_retraces"] == 0
    return rep


def _engine_cells(mesh, args) -> list:
    """Audit every (backend, tpd) engine cell on this rank."""
    from repro_torch.analysis import audit_engine
    cells = []
    for backend in args.backends:
        for tpd in args.tpds:
            rep = audit_engine(_build_engine(backend, tpd, args, mesh))
            cells.append({"backend": backend, "ticks_per_dispatch": tpd,
                          **rep.to_dict(), "summary": rep.summary()})
    return cells


def _run(args) -> dict:
    from repro_torch.analysis.contracts import (_model_step_audits,
                                                audit_flash_prefill)
    from repro_torch.launch.mesh import make_serve_mesh, run_ranks

    out = {"cells": [], "steps": {}, "retrace": {}}
    for n in args.ranks:
        if n == 1:
            per_rank = [_engine_cells(make_serve_mesh(
                "model=1", 0, args.device), args)]
        else:
            per_rank = run_ranks(_engine_cells, n, args.device, args)
        for i, cell in enumerate(per_rank[0]):
            out["cells"].append({**cell, "ranks": n,
                                 "ok": all(r[i]["ok"] for r in per_rank)})
            print(f"--- {cell['backend']} x {n} rank(s) x "
                  f"tpd={cell['ticks_per_dispatch']} ---")
            print(cell["summary"])
    fp = audit_flash_prefill(device=args.device or "cuda")
    out["steps"]["flash_prefill"] = fp.to_dict()
    print(f"[{'OK ' if fp.ok else 'FAIL'}] flash_prefill: launches "
          f"{fp.census.launches}")
    for name, a in _model_step_audits(args.arch,
                                      args.device or "cuda").items():
        out["steps"][name] = a.to_dict()
        print(f"[{'OK ' if a.ok else 'FAIL'}] {name}: launches "
              f"{a.census.launches} fp64={len(a.census.fp64)}")
    if args.retrace:
        for backend in args.backends:
            rep = _retrace_cell(backend, args)
            out["retrace"][backend] = rep
            print(f"[{'OK ' if rep['ok'] else 'FAIL'}] retrace[{backend}]: "
                  f"calls={rep['calls']} steady_builds="
                  f"{rep['steady_retraces']}")
    out["ok"] = (all(c["ok"] for c in out["cells"])
                 and all(s["ok"] for s in out["steps"].values())
                 and all(r["ok"] for r in out["retrace"].values()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="entry-point contract audit over a backend x ranks x "
                    "ticks-per-dispatch matrix")
    ap.add_argument("--arch", default="r1-llama-8b")
    ap.add_argument("--backends", default="reference,kernel",
                    help="comma list of engine backends to audit")
    ap.add_argument("--ranks", default="1",
                    help="comma list of rank counts (above 1: spawned "
                         "ranks in a gloo group)")
    ap.add_argument("--ticks-per-dispatch", default="1,8", dest="tpds",
                    help="comma list of mega-dispatch trip counts")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--budget", type=int, default=48)
    ap.add_argument("--heads", type=int, default=8,
                    help="query-head override (must keep heads %% kv_heads "
                         "== 0)")
    ap.add_argument("--kv-heads", type=int, default=4, dest="kv_heads",
                    help="kv-head override (every rank count must divide "
                         "it)")
    ap.add_argument("--retrace", action="store_true",
                    help="also stream a pressure trace under the "
                         "RetraceGuard (one rank)")
    ap.add_argument("--fail-on-violation", action="store_true",
                    help="exit 1 on any contract violation or "
                         "steady-state build")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="analysis_report.json",
                    help="JSON report path ('' = don't write)")
    args = ap.parse_args(argv)
    args.backends = [b for b in args.backends.split(",") if b]
    args.tpds = [int(t) for t in str(args.tpds).split(",") if t]
    args.ranks = [int(n) for n in str(args.ranks).split(",") if n]
    report = _run(args)
    print(f"\naudit: {len(report['cells'])} engine cell(s) across rank "
          f"counts {args.ranks} -> "
          f"{'OK' if report['ok'] else 'VIOLATIONS'}")
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2))
        print(f"report written to {args.out}")
    if args.fail_on_violation and not report["ok"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
