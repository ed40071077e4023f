"""``output_tok_s`` where the host paces it too unsteadily for a bound:
tokens the clients read in the window over its seconds, as the end-to-end
metric counts them (``benchlib/serve.py``), with the profiled slice of the
``--trace 1`` run (from its start until the profiler has stopped) left
out of both."""


def read(ctx):
    return ctx.get("unprofiled", {}).get("output_tok_s") or None
