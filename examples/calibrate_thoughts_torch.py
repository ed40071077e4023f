"""Offline thought-decomposition calibration (paper Algorithm 1) with the
PyTorch port (the port's counterpart of ``examples/calibrate_thoughts.py``,
which it prints line for line).

    PYTHONPATH=src python examples/calibrate_thoughts_torch.py [--device cpu]

Runs KDE over per-layer decode-step sparsity traces, selects the
tri-modal layer subset L*, extracts the inter-mode minima as thresholds
Theta, and validates the resulting classifier against the planted ground
truth.  Calibration is offline numpy, as in the reference; the classifier
runs on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.calibration import calibrate
from repro_torch.core.thoughts import classify
from repro_torch.data.synthetic import ReasoningTraceGen
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    """Run the calibration; returns its result, the predicted labels and
    the accuracy (for the tests)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = ReasoningTraceGen(dataset="aime", seed=0)
    planted_lstar = [2, 5, 9, 13]
    print("collecting sparsity traces (16 layers x 8 prompts)...")
    traces = gen.calibration_traces(num_prompts=8, length=3000,
                                    num_layers=16, lstar=planted_lstar)

    res = calibrate(traces, num_thoughts=3, num_calib_layers=4)
    print(f"selected L* = {res.layer_subset} "
          f"(planted tri-modal layers: {planted_lstar})")
    print(f"thresholds Theta = ({res.thresholds[0]:.3f}, "
          f"{res.thresholds[1]:.3f})")
    print("tri-modal hits per layer:",
          {k: v for k, v in sorted(res.per_layer_modes.items())})

    trace = gen.generate(5000)
    # f32, as the reference's classifier sees the sparsities
    spars = torch.tensor(trace.sparsities, dtype=torch.float32, device=dev)
    pred = classify(spars, tuple(res.thresholds)).cpu().numpy()
    acc = float((pred == trace.thought_types).mean())
    print(f"token-level classification accuracy vs planted: {acc:.3f}")
    return {"result": res, "pred": pred, "accuracy": acc}


if __name__ == "__main__":
    main()
