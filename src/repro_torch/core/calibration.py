"""Offline calibration of thought-decomposition thresholds (Algorithm 1;
ports ``repro/core/calibration.py``, a numpy copy: the port imports
nothing of the JAX package).

Per prompt and per layer, a Gaussian KDE is fit over the decode-step sparsity
samples; layers whose KDE exhibits exactly ``|T|`` modes form the candidate
set; ``L*`` is their intersection across prompts (falling back to the most
frequent layers when the intersection is smaller than ``num_calib_layers``).
Thresholds are the local minima between modes, averaged over prompts and
layers in ``L*``.

Offline only, plain numpy as in the reference: the paper runs calibration
once over ~100 prompts (s1K) before serving.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CalibrationResult:
    layer_subset: List[int]                 # L*
    thresholds: Tuple[float, ...]           # theta_1..theta_{|T|-1}
    per_layer_modes: Dict[int, int]         # diagnostics
    num_prompts: int = 0


def gaussian_kde(samples: np.ndarray, grid: np.ndarray,
                 bandwidth: float | None = None) -> np.ndarray:
    """KDE \\hat f_h(x) = 1/(M h) sum K((x - x_m)/h), Gaussian K."""
    samples = np.asarray(samples, np.float64).ravel()
    m = samples.size
    if m == 0:
        return np.zeros_like(grid)
    if bandwidth is None:
        # Silverman's rule of thumb
        std = samples.std()
        iqr = np.subtract(*np.percentile(samples, [75, 25]))
        sigma = min(std, iqr / 1.349) if iqr > 0 else std
        bandwidth = 0.9 * max(sigma, 1e-3) * m ** (-1 / 5)
    z = (grid[:, None] - samples[None, :]) / bandwidth
    return np.exp(-0.5 * z * z).sum(axis=1) / (m * bandwidth * np.sqrt(2 * np.pi))


def find_modes_and_minima(density: np.ndarray, grid: np.ndarray,
                          min_rel_height: float = 0.05
                          ) -> Tuple[List[float], List[float]]:
    """Local maxima (modes) and the local minima between consecutive modes."""
    d = density
    peak = (d[1:-1] > d[:-2]) & (d[1:-1] >= d[2:])
    idx = np.where(peak)[0] + 1
    idx = idx[d[idx] >= min_rel_height * d.max()] if idx.size else idx
    modes = [float(grid[i]) for i in idx]
    minima = []
    for a, b in zip(idx[:-1], idx[1:]):
        j = a + int(np.argmin(d[a:b + 1]))
        minima.append(float(grid[j]))
    return modes, minima


def calibrate(sparsity_traces: Dict[int, List[np.ndarray]],
              num_thoughts: int = 3,
              num_calib_layers: int = 4,
              grid_points: int = 512) -> CalibrationResult:
    """Run Algorithm 1.

    Args:
      sparsity_traces: layer -> list over prompts of per-decode-step sparsity
        arrays (each in [0,1]).
      num_thoughts: |T|.
      num_calib_layers: |L*| to select.

    Returns: CalibrationResult with L* and averaged thresholds.

    Raises ValueError when ``sparsity_traces`` carries no data at all
    (empty dict, or every layer's prompt list empty) — there is nothing
    to calibrate and silently returning defaults would hide a broken
    trace-collection pipeline upstream.

    When traces exist but NO layer is ever tri-modal, falls back to the
    first ``num_calib_layers`` layers plus the paper's default
    thresholds (0.55, 0.80) — a DOCUMENTED degradation, not an empty
    ``layer_subset`` (an empty L* would make the engine average sparsity
    over zero layers and feed NaN into every refresh).
    """
    grid = np.linspace(0.0, 1.0, grid_points)
    layers = sorted(sparsity_traces)
    if not layers or all(len(v) == 0 for v in sparsity_traces.values()):
        raise ValueError(
            "calibrate: sparsity_traces is empty (no layers, or no prompt "
            "traces for any layer) — collect at least one prompt's "
            "decode-step sparsity samples before calibrating")
    num_prompts = max(len(v) for v in sparsity_traces.values())

    # per (layer, prompt): modes + minima
    per_layer_hits: Dict[int, int] = {}
    per_layer_prompt_minima: Dict[int, List[List[float]]] = {}
    for layer in layers:
        hits = 0
        minima_list: List[List[float]] = []
        for trace in sparsity_traces[layer]:
            dens = gaussian_kde(np.asarray(trace), grid)
            modes, minima = find_modes_and_minima(dens, grid)
            if len(modes) == num_thoughts:
                hits += 1
                minima_list.append(minima)
        per_layer_hits[layer] = hits
        per_layer_prompt_minima[layer] = minima_list

    # L*: layers tri-modal on every prompt (Alg. 1 line 24: intersection);
    # fall back to most-frequently tri-modal layers to fill |L*|.
    full = [l for l in layers if per_layer_hits[l] == len(sparsity_traces[l])
            and per_layer_hits[l] > 0]
    ranked = sorted(layers, key=lambda l: -per_layer_hits[l])
    lstar = full[:num_calib_layers]
    for l in ranked:
        if len(lstar) >= num_calib_layers:
            break
        if l not in lstar and per_layer_hits[l] > 0:
            lstar.append(l)
    if not lstar:
        # no layer was tri-modal on ANY prompt: fall back to the first
        # num_calib_layers layers (see docstring) rather than returning
        # an empty L* — thresholds below also fall back to the defaults
        # because cnt stays 0
        lstar = layers[:num_calib_layers]
    lstar = sorted(lstar)

    # thresholds: average the j-th minimum over prompts and layers in L*
    acc = np.zeros(num_thoughts - 1)
    cnt = 0
    for l in lstar:
        for minima in per_layer_prompt_minima[l]:
            if len(minima) == num_thoughts - 1:
                acc += np.asarray(minima)
                cnt += 1
    thresholds = tuple((acc / max(cnt, 1)).tolist()) if cnt else (0.55, 0.80)

    return CalibrationResult(layer_subset=lstar, thresholds=thresholds,
                             per_layer_modes=per_layer_hits,
                             num_prompts=num_prompts)
