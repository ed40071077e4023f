"""A closed loop of ``clients``: each sends a request, reads its tokens,
and sends its next one when the last token arrives (no think time).

Requests come in rounds, the r-th request of every client forming round r.
Within a round the prompt lengths and the output lengths are spread evenly
over their ranges (``prompt_len`` and ``output_len``, both ends included)
and dealt to the clients in an order drawn from the seed, so every seed
sends the same sizes in another order; the prompt ids are drawn from the
seed, uniformly over the vocabulary.  With ``stagger_first`` the first
round's output lengths are spread over ``[1, output_len[1]]`` instead, so
that completions spread out from the start instead of arriving together.

Keys: ``clients``, ``rounds``, ``prompt_len``, ``output_len``,
``stagger_first``, and those of every mix (``benchlib/traffic.py``).
"""
from __future__ import annotations

import asyncio
from typing import List

import numpy as np

from benchlib.traffic import Request, spread


def make(mix: dict, seed: int, vocab: int) -> List[List[Request]]:
    """Every client's requests, in the order it sends them."""
    n, rounds = int(mix["clients"]), int(mix["rounds"])
    rng = np.random.default_rng(int(seed))
    clients: List[List[Request]] = [[] for _ in range(n)]
    for r in range(rounds):
        plen = spread(*mix["prompt_len"], n)[rng.permutation(n)]
        lo, hi = mix["output_len"]
        if r == 0 and mix.get("stagger_first"):
            lo = 1
        out = spread(lo, hi, n)[rng.permutation(n)]
        for c in range(n):
            ids = rng.integers(0, vocab, size=int(plen[c]), dtype=np.int64)
            clients[c].append(Request(c, r, ids, int(out[c])))
    return clients


async def drive(run, clients: List[List[Request]]) -> None:
    async def client(reqs):
        for r in reqs:
            if run.stop:
                return
            await run.send(r)
    await asyncio.gather(*(client(c) for c in clients))
