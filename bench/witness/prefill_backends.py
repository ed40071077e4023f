"""A second witness for the prefill's parting (``PERF.md``): the measured
program's two backends, and the benchmark's reference, prefill the same
prompts of a cell on the same weights; the script prints how far each
pair's prefilled caches lie apart (``check.state_diff``: the share of the
VALID places that differ) and, at the first token, the gap by which each
backend's choice lies below the reference's best.

    python3 bench/witness/prefill_backends.py --workload qwen2-7b.reason \
        --seed 2147483901 --prompts 3

Where the kernel backend parts from the program's own plain backend as far
as from the reference, the parting is the kernels' rounding turned into
other retained tokens by eviction, and no fault of the reference.  Not
one of the benchmark's runs: it prints one JSON line and no result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def main(argv=None, device=None, root=ROOT) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--prompts", type=int, default=3)
    args = p.parse_args(argv)
    for d in (str(HERE), str(root / "src")):
        if d not in sys.path:
            sys.path.insert(0, d)
    import torch
    from benchlib import check, model, serve, spec
    from reference import thinkv_ref as R
    from repro_torch.serving.engine import ThinKVEngine
    cell = spec.Cell(spec.load(root), args.workload, root)
    dev = torch.device(device or "cuda:0")
    cfg = dict(cell.config, serving=dict(cell.config["serving"],
                                         max_seqs=args.prompts))
    a, tk, sv = model.arch(cfg), cfg["thinkv"], cfg["serving"]
    scfg, kw = model.port_config(cfg, cell.name)
    lm = model.port_params(scfg, a, args.seed, dev)
    weights = {k: v.detach() for k, v in lm.named_parameters()}
    plan = cell.kind.make(cell.traffic, args.seed, a["vocab"])
    prompts = [c[0].prompt for c in plan][:args.prompts]
    caches, firsts, seconds = {}, {}, {}
    for backend in ("kernel", "reference"):
        eng = ThinKVEngine(scfg, params=lm, backend=backend,
                           prefill_chunk=kw["prefill_chunk"],
                           policy=kw["policy"], device=dev)
        t0 = time.perf_counter()
        out = [eng.prefill(pr, i, arrival=i) for i, pr in enumerate(prompts)]
        seconds[backend] = time.perf_counter() - t0
        caches[backend] = [serve.snapshot(eng, i)
                           for i in range(len(prompts))]
        firsts[backend] = [o.first_token for o in out]
        del eng
    ref = R.Reference(a, tk, weights)
    own, ref_logits = [], []
    t0 = time.perf_counter()
    for pr in prompts:
        cache = R.Cache(tk, a["layers"], a["kv_heads"], a["head_dim"], dev)
        ref_logits.append(ref.prefill(cache, torch.as_tensor(pr, device=dev),
                                      sv["prefill_chunk"]))
        own.append(check._prefilled(cache))
    seconds["bench_reference"] = time.perf_counter() - t0
    pairs = {"kernel_vs_reference_backend": (caches["kernel"],
                                             caches["reference"]),
             "kernel_vs_bench_reference": (caches["kernel"], own),
             "reference_backend_vs_bench_reference": (caches["reference"],
                                                      own)}
    res = {"workload": cell.name, "seed": args.seed,
           "prompt_lens": [len(pr) for pr in prompts],
           "state_diff": {k: [check.state_diff(x, y) for x, y in zip(*v)]
                          for k, v in pairs.items()},
           "first_token_gap": {
               b: [float(check.gaps(lg[None], torch.tensor(
                   [f], device=lg.device))[0])
                   for lg, f in zip(ref_logits, firsts[b])]
               for b in firsts},
           "seconds": seconds}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
