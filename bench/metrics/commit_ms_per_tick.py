"""Host milliseconds of group commits (TBQ quantization, slot allocation,
plane writes: the ``thinkv.commit`` spans that lie inside ``thinkv.tick``
spans) per decode tick of the profiled slice."""

from benchlib import profile


def read(ctx):
    s = ctx["slice"]
    if not s or not s["ticks"] or \
            not any(n == "thinkv.advance" for n, _, _ in s["spans"]):
        return None             # no slice, or a program without these spans
    return profile.span_time_s(s, "thinkv.commit",
                               inside="thinkv.tick") * 1e3 / s["ticks"]
