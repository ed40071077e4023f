"""The port's offline calibration (``repro_torch/core/calibration.py``, a
numpy copy) against the JAX package's ``repro/core/calibration.py`` on the
JAX package's synthetic sparsity traces (``repro/data/synthetic.py``):
the same layer subset L*, thresholds to 1e-12, the same per-layer mode
counts; also the KDE and the mode / minima finder, and the two documented
degradations (no tri-modal layer; no data)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import calibration as CJ  # noqa: E402
from repro.data.synthetic import ReasoningTraceGen  # noqa: E402
from repro_torch.core import calibration as CT  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """As the other port modules: one torch thread under several pytest
    workers (the calibration itself is numpy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traces(seed, prompts, length, layers, lstar):
    return ReasoningTraceGen(seed=seed).calibration_traces(
        prompts, length, layers, lstar=lstar)


@pytest.mark.parametrize("seed,prompts,length,layers,lstar,n_calib", [
    (0, 6, 3000, 16, [2, 5, 9, 13], 4),
    (1, 4, 2000, 8, [1, 3, 5, 6], 4),
    (2, 3, 1500, 10, [0, 7], 4),           # fewer tri-modal layers than |L*|
    (3, 2, 800, 6, [4], 2)])
def test_calibrate_matches_jax(seed, prompts, length, layers, lstar,
                               n_calib):
    tr = traces(seed, prompts, length, layers, lstar)
    want = CJ.calibrate(tr, num_thoughts=3, num_calib_layers=n_calib)
    got = CT.calibrate(tr, num_thoughts=3, num_calib_layers=n_calib)
    assert got.layer_subset == want.layer_subset
    np.testing.assert_allclose(got.thresholds, want.thresholds, rtol=0,
                               atol=1e-12)
    assert got.per_layer_modes == want.per_layer_modes
    assert got.num_prompts == want.num_prompts == prompts


def test_kde_and_modes_match_jax():
    rng = np.random.default_rng(4)
    samples = np.concatenate([rng.normal(0.3, 0.05, 300),
                              rng.normal(0.7, 0.04, 200)])
    grid = np.linspace(0, 1, 512)
    for bw in (None, 0.02):
        dj = CJ.gaussian_kde(samples, grid, bw)
        dt = CT.gaussian_kde(samples, grid, bw)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-12)
        assert CT.find_modes_and_minima(dt, grid) == \
            CJ.find_modes_and_minima(dj, grid)
    assert not CT.gaussian_kde(np.zeros(0), grid).any()


def test_degradations_match_jax():
    flat = {l: [np.full(500, 0.5) + 1e-3 * np.random.default_rng(l)
                .standard_normal(500)] for l in range(6)}
    want, got = CJ.calibrate(flat), CT.calibrate(flat)
    assert got.layer_subset == want.layer_subset == [0, 1, 2, 3]
    assert got.thresholds == want.thresholds == (0.55, 0.80)
    for empty in ({}, {0: [], 1: []}):
        with pytest.raises(ValueError, match="empty"):
            CT.calibrate(empty)
