"""Segment anneals (one segment's dequantization and k-means selection in
every layer: the ``thinkv.anneal`` spans, from budget eviction's rounds and
from a transition's annealing of every earlier segment) that lie inside
``thinkv.tick`` spans, per decode tick of the profiled slice."""


def read(ctx):
    s = ctx["slice"]
    if not s or not s["ticks"] or \
            not any(n == "thinkv.advance" for n, _, _ in s["spans"]):
        return None             # no slice, or a program without these spans
    ticks = [(a, b) for n, a, b in s["spans"] if n == "thinkv.tick"]
    n = sum(1 for name, a, b in s["spans"] if name == "thinkv.anneal"
            and any(x <= a and b <= y for x, y in ticks))
    return n / s["ticks"]
