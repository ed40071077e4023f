"""Slots decoding on a tick: tokens the engine decoded in the window over
its ticks there (the engine's own counters, read at the window's ends)."""


def read(ctx):
    c = ctx["counters"]
    return c["tokens"] / c["ticks"] if c["ticks"] else None
