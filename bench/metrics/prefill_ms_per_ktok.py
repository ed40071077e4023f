"""Host milliseconds of chunked prefill per 1,000 prompt tokens in the
window: the engine's ``prefill_s`` counter (its host clock around its
``thinkv.prefill`` span) over its ``prefill_tokens`` counter."""


def read(ctx):
    c = ctx["counters"]
    if not c["prefill_tokens"]:
        return None
    return c["prefill_s"] * 1e3 / (c["prefill_tokens"] / 1e3)
