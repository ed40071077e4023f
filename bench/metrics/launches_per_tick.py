"""Device kernels launched in the profiled slice over the ticks in it
(prefills that fell inside the slice included; copies and fills not
counted)."""

from benchlib import profile


def read(ctx):
    s = ctx["slice"]
    if not s or not s["ticks"]:
        return None
    n = sum(1 for name, _, _ in s["device_ops"] if profile.is_kernel(name))
    return n / s["ticks"]
