"""The whole step's share of the card's f32 peak over the profiled slice:
model FLOPs done in it (2 x the parameters a token meets in products, for
decoded and prompt tokens alike, plus attention over the entries each
token attends) over the slice's seconds, over 67 TFLOP/s (the products
run in f32 with TF32 off).

Decoded tokens attend the VALID slots and buffer entries of their slot,
read from the engine's state at the slice's end (the slice's ticks are
taken to attend as many); a prompt token at position t attends the t + 1
tokens up to it (no prompt of a cell that prefills in its window passes
the budget)."""

from benchlib import roofline


def read(ctx):
    s = ctx["slice"]
    if not s or not s["ticks"] or not s["wall_s"]:
        return None
    a = ctx["arch"]
    per_key = 4 * a["heads"] * a["head_dim"]       # q.k and p.v, per layer
    pool = s["pool"]
    decode = s["counters"]["tokens"]
    prompt = sum(p[2] for p in s["prefills"])
    flops = 2 * ctx["params_in_products"] * (decode + prompt)
    if pool["active"]:
        flops += s["ticks"] * per_key * (pool["active_valid"]
                                         + pool["active_buf"])
    flops += sum(per_key * a["layers"] * p[2] * (p[2] + 1) // 2
                 for p in s["prefills"])
    return 100.0 * flops / s["wall_s"] / roofline.F32_FLOPS
