"""Synthetic data: LM training batches and thought-structured reasoning
traces (a copy of ``repro/data/synthetic.py``, which is numpy only: the
port keeps its own, so the same seed gives the same batches).

Two generators:
* ``lm_batches`` — deterministic packed token batches for training runs;
* ``ReasoningTraceGen`` — decode-step traces with PLANTED tri-modal thought
  structure (segment types R/E/T with distinct attention-sparsity
  signatures, Sec. 3.1) used to calibrate phi, test the classifier, and
  drive the serving benchmarks.  Segment durations and the R->E->T mixture
  follow the paper's Fig. 10(f) breakdown (AIME-like: more transitions;
  MATH-like: fewer).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

from repro_torch.config import ThoughtType

# (T, E, R) stationary mixture per dataset difficulty (paper Fig. 10f)
MIXES = {
    "aime": (0.20, 0.40, 0.40),
    "livecodebench": (0.15, 0.50, 0.35),
    "math500": (0.08, 0.52, 0.40),
}

# sparsity signature per thought type: (mean, std); T > R > E (Obs. 1b)
SPARSITY_SIG = {
    int(ThoughtType.EXECUTION): (0.35, 0.06),
    int(ThoughtType.REASONING): (0.67, 0.05),
    int(ThoughtType.TRANSITION): (0.90, 0.03),
}


def lm_batches(vocab_size: int, batch: int, seq: int, *, seed: int = 0,
               steps: int | None = None) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic stream of packed LM batches with next-token targets."""
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        toks = rng.integers(0, vocab_size, (batch, seq + 1), dtype=np.int32)
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        i += 1


@dataclasses.dataclass
class ReasoningTrace:
    tokens: np.ndarray            # [n] int32
    thought_types: np.ndarray     # [n] int32 ground-truth segment labels
    sparsities: np.ndarray        # [n] float planted per-step sparsity
    segments: List[Tuple[int, int, int]]   # (start, end, type)


class ReasoningTraceGen:
    """Markov segment generator over thought types with planted sparsity."""

    def __init__(self, vocab_size: int = 1000, dataset: str = "aime",
                 seg_len_range: Tuple[int, int] = (100, 300), seed: int = 0):
        self.vocab = vocab_size
        self.mix = MIXES[dataset]
        self.seg_len = seg_len_range
        self.rng = np.random.default_rng(seed)

    def _next_type(self, prev: int) -> int:
        # transitions rarely repeat; otherwise sample stationary mix
        t, e, r = self.mix
        p = np.array([t, e, r], np.float64)
        if prev == int(ThoughtType.TRANSITION):
            p[int(ThoughtType.TRANSITION)] *= 0.1
        p /= p.sum()
        return int(self.rng.choice(3, p=p[[0, 1, 2]]))

    def generate(self, length: int) -> ReasoningTrace:
        toks = self.rng.integers(0, self.vocab, length).astype(np.int32)
        types = np.zeros(length, np.int32)
        spars = np.zeros(length, np.float64)
        segments: List[Tuple[int, int, int]] = []
        pos = 0
        cur = int(ThoughtType.REASONING)
        while pos < length:
            seg = int(self.rng.integers(*self.seg_len))
            end = min(pos + seg, length)
            mu, sd = SPARSITY_SIG[cur]
            types[pos:end] = cur
            spars[pos:end] = np.clip(
                self.rng.normal(mu, sd, end - pos), 0.0, 1.0)
            segments.append((pos, end, cur))
            pos = end
            cur = self._next_type(cur)
        return ReasoningTrace(tokens=toks, thought_types=types,
                              sparsities=spars, segments=segments)

    def calibration_traces(self, num_prompts: int, length: int,
                           num_layers: int, lstar: List[int] | None = None,
                           noise: float = 0.1
                           ) -> Dict[int, List[np.ndarray]]:
        """Layer -> per-prompt sparsity arrays for Algorithm 1.

        Layers in ``lstar`` carry the clean tri-modal signal; other layers
        get blurred/unimodal signals (paper App. E.4: some layers have
        ambiguous boundaries)."""
        lstar = lstar if lstar is not None else [2, 5, 9, 13]
        out: Dict[int, List[np.ndarray]] = {l: [] for l in range(num_layers)}
        for _ in range(num_prompts):
            trace = self.generate(length)
            for l in range(num_layers):
                if l in lstar:
                    sig = trace.sparsities + \
                        self.rng.normal(0, 0.02, length)
                else:
                    # ambiguous layer: heavy blur collapses the modes
                    sig = 0.5 + (trace.sparsities - 0.5) * 0.25 + \
                        self.rng.normal(0, noise, length)
                out[l].append(np.clip(sig, 0, 1))
        return out
