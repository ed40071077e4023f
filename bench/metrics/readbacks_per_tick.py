"""Statements at which the host waited for the device (``thinkv.readback``
spans: reads to the host, synchronous uploads, boolean-mask shapes)
anywhere in the profiled slice (in ticks, between them and in prefills),
per decode tick of the slice."""


def read(ctx):
    s = ctx["slice"]
    if not s or not s["ticks"] or \
            not any(n == "thinkv.advance" for n, _, _ in s["spans"]):
        return None             # no slice, or a program without these spans
    return sum(1 for n, _, _ in s["spans"]
               if n == "thinkv.readback") / s["ticks"]
