"""Median host interval between the dispatches of consecutive decode ticks
in the window (stamped by the benchmark's wrapper of ``generate``)."""

import statistics


def read(ctx):
    iv = ctx["tick_intervals_s"]
    return statistics.median(iv) * 1e3 if iv else None
