"""Host milliseconds in ``thinkv.readback`` spans (the statements at which
the host waited for the device) anywhere in the profiled slice, per decode
tick of the slice; time in overlapping spans counts once."""

from benchlib import profile


def read(ctx):
    s = ctx["slice"]
    if not s or not s["ticks"] or \
            not any(n == "thinkv.advance" for n, _, _ in s["spans"]):
        return None             # no slice, or a program without these spans
    spans = profile.union([(a, b) for n, a, b in s["spans"]
                           if n == "thinkv.readback"])
    return sum(b - a for a, b in spans) * 1e-3 / s["ticks"]
