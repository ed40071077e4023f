"""Host milliseconds of budget eviction (every ``budget_evict`` call, at a
commit and inside a refresh, with its anneal rounds: the ``thinkv.evict``
spans that lie inside ``thinkv.tick`` spans) per decode tick of the
profiled slice."""

from benchlib import profile


def read(ctx):
    s = ctx["slice"]
    if not s or not s["ticks"] or \
            not any(n == "thinkv.advance" for n, _, _ in s["spans"]):
        return None             # no slice, or a program without these spans
    return profile.span_time_s(s, "thinkv.evict",
                               inside="thinkv.tick") * 1e3 / s["ticks"]
