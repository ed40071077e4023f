"""Host milliseconds of cache maintenance (commit, budget eviction,
refresh: the ``thinkv.maintain`` spans that lie inside ``thinkv.tick``
spans) per decode tick of the profiled slice."""

from benchlib import profile


def read(ctx):
    s = ctx["slice"]
    if not s or not s["ticks"]:
        return None
    return profile.span_time_s(s, "thinkv.maintain",
                               inside="thinkv.tick") * 1e3 / s["ticks"]
