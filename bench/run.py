"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the
correctness check compared, with its limit (also the last lines of standard
error).  Without a card, or with fewer cards than the cell asks for, it
prints no result and exits with 2; if the JAX package or JAX itself is
loaded once the window has closed, with 3.

``--control 1`` (not used by the benchmark's own runs) puts the TF32
control in the program's place for the comparison: ``correct`` and
``checks`` are then the control's, which has to come out not correct, and
the program's own numbers are printed beside them as ``program_<name>``
(``bench/README.md``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(names=None) -> list:
    """Top-level names among ``names`` (default: ``sys.modules``) that the
    benchmark's process may not hold, compared whole (``repro_torch`` is
    not ``repro``)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _paths() -> None:
    for p in (str(HERE), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None, device=None, faults=None, root=ROOT,
         t_start=T_START) -> int:
    args = parse(argv)
    _paths()
    import torch
    from benchlib import check, profile, serve, spec
    cell = spec.Cell(spec.load(root), args.workload, root)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {cell.chips} CUDA device(s); "
                  f"this machine has {have}", file=sys.stderr)
            return 2
        device = "cuda:0"
    torch.set_num_threads(4)
    run = serve.Run(cell.name, cell.config, cell.traffic, cell.kind,
                    args.seed, args.seconds, bool(args.trace), device,
                    t_start, faults)
    run.execute()
    if forbidden_modules():
        print(f"loaded in the benchmark's process: {forbidden_modules()}",
              file=sys.stderr)
        return 3
    if args.trace:
        metrics = spec.read_metrics(cell.per_layer, run.context(), root)
    else:
        e2e = run.end_to_end()
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    dev = run.device_info()
    result = {"attempted": run.attempted(), "failed": run.failed(),
              "metrics": metrics, "device": dev}
    if args.trace and run.slice_rec is not None:
        dev["busy_s"] = profile.busy_s(run.slice_rec)
        dev["window_s"] = run.slice_rec["wall_s"]
        result["breakdown"] = profile.breakdown(run.slice_rec)
    reqs = check.sample(run.served, cell.traffic, args.seed)
    schedule, arch, tk = run.schedule, run.arch, run.tk
    snapshots = {r.arrival: run.snapshots[r.arrival] for r in reqs
                 if r.arrival in run.snapshots}
    run.release()
    t_check = time.perf_counter()
    numbers, control = check.run(arch, tk, cell.config["serving"],
                                 cell.traffic, args.seed, reqs, schedule,
                                 snapshots, torch.device(device),
                                 bool(args.control))
    # the control's numbers stand in the program's place, judged alike;
    # the program's own reading of the run is kept beside them, unjudged
    ok, checks = check.verdict(control or numbers, cell.limits)
    if control is not None:
        checks.update({"program_" + k: {"value": v["value"], "limit": None}
                       for k, v in check.verdict(numbers, {})[1].items()})
    checks["compared_tokens"] = {"value": numbers["compared_tokens"],
                                 "limit": None}
    if forbidden_modules():
        print(f"loaded in the benchmark's process: {forbidden_modules()}",
              file=sys.stderr)
        return 3
    result = {"correct": ok, **result, "checks": checks}
    print(f"reference replay {time.perf_counter() - t_check:.1f} s for "
          f"{len(reqs)} requests", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
