"""Quickstart of the PyTorch port: the ThinKV core API (the port's
counterpart of ``examples/quickstart.py``, which it prints line for line).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

1. quantize a KV group at thought-adaptive precision (TBQ);
2. build a CT paged cache and stream tokens through it (TBE + CT);
3. read compression stats and run paged decode attention;
4. the refcounted GlobalPool: share, COW, release.

Without ``--device`` it runs on the card: every commit quantizes its group
in one K4 launch (``kernels/csrc/group_quant.cu``) and the decode read
goes through K2 (``ct_paged_attention.cu``, the single-request wrapper the
controller uses); with ``--device cpu`` the same calls run the kernels'
plain versions.
"""
import argparse

import numpy as np
import torch

from repro_torch.config import ThinKVConfig
from repro_torch.core import ct_cache as CC
from repro_torch.core import quantization as Q
from repro_torch.core import thinkv as TV
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main(argv=None) -> dict:
    """Run the quickstart; returns its numbers and the tensors they came
    from (for the tests)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    # --- 1. TBQ: NVFP4 group quantization (R/E thoughts) ----------------
    x = randn(16, 128)
    codes, scales = Q.quantize_group(x, bits=4)       # e2m1 + e4m3 scales
    x_hat = Q.dequantize_group(codes, scales, bits=4)
    rel = float(torch.linalg.norm(x - x_hat) / torch.linalg.norm(x))
    print(f"NVFP4 roundtrip rel-RMSE: {rel:.3f}")

    # --- 2. a CT cache for a 2-layer toy model --------------------------
    # the paged split: CTCache carries metadata + the fp TBQ buffer,
    # PoolView the quantized planes in paged [L, NB, BS, H, ...] layout
    tk = ThinKVConfig(refresh_interval=16, group_size=8, block_size=8,
                      token_budget=64, retention_schedule=(16, 8, 4),
                      min_retention=4, max_segments=64, kmeans_iters=4)
    dims = CC.make_dims(tk, num_layers=2, kv_heads=2, head_dim=32)
    cache = CC.init_cache(dims, dev)
    view = CC.init_pool_view(dims, dims.NB, dev)

    # planted sparsity: R -> E -> T -> R windows (Sec. 3.1 tri-modal signal)
    sparsity = {0: 0.65, 1: 0.30, 2: 0.92, 3: 0.65}
    for i in range(200):
        k, v = randn(2, 2, 32), randn(2, 2, 32)
        TV.step_token(tk, dims, cache, view, k, v,
                      torch.tensor(sparsity[(i // 16) % 4], device=dev))

    stats = TV.compression_ratio(tk, dims, cache, 200)
    retained = int(CC.valid_counts(cache)[0])
    seg_types = cache.seg_type[:int(cache.cur_seg) + 1].cpu().numpy()
    print(f"after 200 tokens: {retained} retained/layer, "
          f"avg {float(stats['avg_bits']):.2f} bits, "
          f"{float(stats['footprint_frac']) * 100:.1f}% of FullKV bytes")
    print("segment types (0=T,1=E,2=R):", seg_types)

    # --- 3. paged decode attention over the compressed cache ------------
    q = randn(4, 32)
    out = ops.thinkv_decode_attention(dims, cache, view, q, layer=0)
    print("decode attention out:", tuple(out.shape), "finite:",
          bool(torch.isfinite(out).all()))

    # --- 4. the refcounted GlobalPool: share, COW, release --------------
    # the serving engine's physical pool: blocks are claimed at commits,
    # SHARED across requests by the prefix cache (refcount++), and any
    # write to a shared block copy-on-write faults into a private copy
    pool = CC.init_global_pool(dims, 2 * dims.NB, dev)
    table = CC.init_block_table(dims, dev)
    gcache = CC.init_cache(dims, dev)
    spars = torch.tensor(0.65, device=dev)
    for i in range(dims.G):
        k, v = randn(2, 2, 32), randn(2, 2, 32)
        gcache.buf_k[:, i] = k.to(torch.bfloat16)
        gcache.buf_v[:, i] = v.to(torch.bfloat16)
        CC.engine_advance(tk, dims, pool, table, gcache, spars,
                          num_tokens=i, buf_len=i, track_cow=True)
    CC.incref_blocks(pool, table)                 # a second holder
    shared = int((pool.refcount > 1).sum())
    table2 = table.clone()
    ok = bool(CC.cow_blocks(dims, pool, table2, table2 >= 0))
    CC.check_pool_invariants(pool, torch.stack([table, table2]))
    print(f"global pool: {shared} shared block refs, COW ok={ok}, "
          f"invariants hold (claimed + free == pool_blocks)")
    return {"rel_rmse": rel, "retained": retained,
            "avg_bits": float(stats["avg_bits"]),
            "footprint_frac": float(stats["footprint_frac"]),
            "seg_types": seg_types.tolist(), "codes": codes,
            "scales": scales, "out": out, "shared": shared, "cow_ok": ok,
            "refcount": pool.refcount, "tables": (table, table2)}


if __name__ == "__main__":
    main()
