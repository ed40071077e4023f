"""``itl_p95_ms`` where the host paces it too unsteadily for a bound: the
95th percentile of every gap between a request's consecutive tokens whose
later token lands in the window, as the end-to-end metric takes it
(``benchlib/serve.py``), leaving out the gaps that overlap the profiled
slice of the ``--trace 1`` run."""


def read(ctx):
    return ctx.get("unprofiled", {}).get("itl_p95_ms") or None
