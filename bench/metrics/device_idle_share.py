"""Share of the profiled slice's wall time in which no operation ran on
the device: 1 - the union of the device's operation intervals over the
slice's host-timed length."""

from benchlib import profile


def read(ctx):
    s = ctx["slice"]
    if not s or not s["device_ops"]:
        return None
    return 100.0 * (1.0 - profile.busy_s(s) / s["wall_s"])
