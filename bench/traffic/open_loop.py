"""An open loop: ``requests`` requests arriving at ``rate`` a second,
whatever the system's pace, each read by a client of its own.

The gaps between arrivals are the exponential distribution's quantiles at
``(i + 0.5) / requests`` (a Poisson process's gaps, spread evenly), dealt
in an order drawn from the seed; prompt and output lengths are spread
evenly over ``prompt_len`` and ``output_len`` and dealt likewise, so
every seed sends the same sizes and gaps in another order.  The first
arrival comes as the traffic starts, in set-up; a cell measures the
arrivals that fall in its window.  Give ``requests`` enough to outlast
set-up and the window at ``rate``.

Keys: ``requests``, ``rate`` (requests a second), ``prompt_len``,
``output_len``, and those of every mix (``benchlib/traffic.py``).
"""
from __future__ import annotations

import asyncio
import time
from typing import List, Tuple

import numpy as np

from benchlib.traffic import Request, spread

POLL_S = 0.05       # how often a wait for the next arrival looks at stop


def make(mix: dict, seed: int, vocab: int) -> List[Tuple[float, Request]]:
    """(arrival second after the traffic starts, request), in order."""
    n, rate = int(mix["requests"]), float(mix["rate"])
    rng = np.random.default_rng(int(seed))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = gaps[rng.permutation(n)]
    at = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    plen = spread(*mix["prompt_len"], n)[rng.permutation(n)]
    out = spread(*mix["output_len"], n)[rng.permutation(n)]
    return [(float(at[i]), Request(i, 0, rng.integers(
        0, vocab, size=int(plen[i]), dtype=np.int64), int(out[i])))
        for i in range(n)]


async def drive(run, plan: List[Tuple[float, Request]]) -> None:
    t0 = time.perf_counter()
    sent = []
    for at, r in plan:
        while not run.stop and time.perf_counter() < t0 + at:
            await asyncio.sleep(min(POLL_S, t0 + at - time.perf_counter()))
        if run.stop:
            break
        sent.append(asyncio.ensure_future(run.send(r)))
    await asyncio.gather(*sent)
