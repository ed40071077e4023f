"""K2 (``paged_split_kernel`` with ``merge_splits_kernel``: a prefill
chunk's queries over the slot's frozen pool, once per layer) against its
roofline in the profiled slice.  Its bytes and operations come from the
chunks of the prompts prefilled inside the slice (``roofline.k2_chunk``
per layer; operations on the fp64 tensor cores)."""

from benchlib import profile, roofline

KERNELS = ("paged_split_kernel", "merge_splits_kernel")


def read(ctx):
    s = ctx["slice"]
    if not s or not s["prefills"]:
        return None
    t, n = profile.kernel_time_s(s, KERNELS)
    if not n or not t:
        return None
    a, tk, sv = ctx["arch"], ctx["thinkv"], ctx["serving"]
    nb = max(int(tk["token_budget"] * 2.0) // tk["block_size"], 4)
    bound = 0.0
    for p in s["prefills"]:
        for start, rows in roofline.prefill_chunks(
                p[2], sv["prefill_chunk"], tk["group_size"]):
            b, f = roofline.k2_chunk(start, rows, a["kv_heads"],
                                     a["heads"] // a["kv_heads"],
                                     a["head_dim"], nb, tk["block_size"])
            bound += a["layers"] * roofline.bound_s(b, f, "f64tc")
    return 100.0 * bound / t
