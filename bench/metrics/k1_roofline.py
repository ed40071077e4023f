"""K1 (``fused_attn_kernel``, the decode tick's attention over every layer
and slot) against its roofline in the profiled slice: the least time the
card could take for its launches over their device time.  Its bytes and
operations come from the engine's pool state read at the slice's end
(``roofline.k1_tick``: every block holding a VALID slot once, the queries,
slot planes, tables, buffers and output)."""

from benchlib import profile, roofline

KERNEL = ("fused_attn_kernel",)


def read(ctx):
    s = ctx["slice"]
    if not s:
        return None
    t, n = profile.kernel_time_s(s, KERNEL)
    if not n or not t:
        return None
    a, tk, p = ctx["arch"], ctx["thinkv"], s["pool"]
    nb = max(int(tk["token_budget"] * 2.0) // tk["block_size"], 4)
    b, f = roofline.k1_tick(p["blocks"], p["n_valid"], p["n_buf"],
                            a["layers"], ctx["serving"]["max_seqs"],
                            a["kv_heads"], a["heads"] // a["kv_heads"],
                            a["head_dim"], nb, tk["block_size"])
    return 100.0 * n * roofline.bound_s(b, f) / t
