#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # every phase, one CUDA card

Phases, each printing one JSON line and raising (non-zero exit) on any
failure:

1. device  — the card, torch and CUDA versions;
2. build   — the CUDA kernels built from ``src/repro_torch/kernels/csrc``
             with nvcc (one process per source, started together);
3. kernels — K1-K4 against their plain PyTorch versions on the card at the
             main path's full-width shapes (<= 1e-3 abs for attention,
             bit-exact for the quantizer), with their times, the plain
             version's time, the bound (the larger of bytes / 3.35 TB/s and
             flops / the fp32 peak) and, for K3, SDPA's time as a yardstick;
4. serve   — the port's engine on the full r1-llama-8b config (32 layers,
             random weights from a seed), kernel backend, 4 requests of
             1100-token prompts and 64 new tokens; launch counts are zeroed
             just before and read just after, and every kernel must have run
             (K1 once per tick);
5. profile — 12 decode ticks of the same traffic under torch.profiler:
             device time by kernel, the device's busy share, host spans;
6. parity  — a 4-layer full-width model through the kernel and the
             reference backends where their results must agree (see
             ``parity``): identical tokens, logits within the reference's
             bar between its backends (1e-3 + 1e-3 |logit|), and for
             decode byte-identical pools.

Then the kernels line, the card's name and power limit as nvidia-smi gives
them, and last ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_FLOPS = 67e12               # H100 SXM fp32, CUDA cores (no tensor cores)
ATOL = 1e-3
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_: float, flops: float):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def pool_need(state, table, per_block: int):
    """What a pool walk must read for these inputs: (bytes of every physical
    block that holds a VALID slot of some request, each read once; count of
    VALID slots).  state [L, R, NB, BS]; table [R, L, NB] raw."""
    import torch
    valid = state == 1
    L, np_ = state.shape[0], int(table.max()) + 1
    phys = table.permute(1, 0, 2).clamp_min(0).long()
    key = torch.arange(L, device=state.device)[:, None, None] * np_ + phys
    blocks = torch.unique(key[valid.any(-1)]).numel()
    return blocks * per_block, int(valid.sum())


def max_err(a, b) -> float:
    import torch
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    if not torch.isfinite(a).all():
        raise AssertionError("kernel output is not finite")
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# kernel inputs at the main path's shapes
# ---------------------------------------------------------------------------

def pool_case(gen, dev, L, R, H, D, BS, NB, NP, G=16, GQ=4):
    """Random pool planes, metadata with free/evicted slots and -1 table
    entries, TBQ buffers and queries (K1 layout; K2 takes one layer)."""
    import torch
    from repro_torch.core.quantization import e4m3_round

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=dev)
    codes = lambda: torch.randint(0, 256, (L, NP, BS, H, D), generator=gen,
                                  device=dev, dtype=torch.uint8)
    scales = lambda: e4m3_round(rnd(L, NP, BS, H, D // 16) * 0.045 + 0.005) \
        .to(torch.bfloat16)
    table = torch.stack([torch.stack([
        torch.randperm(NP, generator=gen, device=dev)[:NB]
        for _ in range(L)]) for _ in range(R)]).to(torch.int32)
    table[rnd(R, L, NB) < 0.1] = -1
    u = rnd(L, R, NB, BS)
    state = torch.where(u < 0.8, 1, torch.where(u < 0.9, 2, 0)) \
        .to(torch.uint8)
    state.masked_fill_((table < 0).permute(1, 0, 2)[..., None], 0)
    bits = torch.tensor([2, 4, 8], dtype=torch.uint8, device=dev)[
        torch.randint(0, 3, (L, R, NB, BS), generator=gen, device=dev)]
    return dict(
        qh=torch.randn((L, R, H, GQ, D), generator=gen, device=dev),
        k_codes=codes(), v_codes=codes(), k_scales=scales(),
        v_scales=scales(), slot_state=state, slot_bits=bits,
        block_table=table,
        buf_k=torch.randn((L, R, G, H, D), generator=gen, device=dev)
        .to(torch.bfloat16),
        buf_v=torch.randn((L, R, G, H, D), generator=gen, device=dev)
        .to(torch.bfloat16),
        buf_len=torch.randint(0, G + 1, (R,), generator=gen, device=dev,
                              dtype=torch.int32))


def check_kernels(dev, mc, tk):
    """K1-K4 vs their plain versions at full width; returns per-kernel
    records (timings from this run)."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    L, H, D = mc.num_layers, mc.num_kv_heads, mc.head_dim
    gq, R, BS, G = mc.num_heads // H, 4, tk.block_size, tk.group_size
    NB = int(tk.token_budget * 2) // BS
    NP = R * NB
    recs = {}

    # K1: a whole decode tick's attention
    c = pool_case(gen, dev, L, R, H, D, BS, NB, NP, G, gq)
    args = tuple(c.values())
    out = ops.paged_decode_attention_fused(*args)
    torch.cuda.synchronize()
    err = max_err(out, ref.ct_paged_attention_fused_ref(*args))
    per_block = BS * H * (2 * D + 2 * 2 * (D // 16))
    pool_b, n_slots = pool_need(c["slot_state"], c["block_table"], per_block)
    n_buf = L * int(c["buf_len"].sum())
    flops = 4 * H * gq * D * (n_slots + n_buf)
    b_ms, b_by = bound(
        pool_b + nbytes(c["qh"], c["slot_state"], c["slot_bits"],
                        c["block_table"], c["buf_len"], out)
        + 2 * n_buf * H * D * 2, flops)
    recs["K1"] = dict(
        name="ct_paged_attention_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/ct_paged_attention.cu",
        replaces="src/repro/kernels/ct_paged_attention.py:204",
        shape=f"L={L} R={R} H={H} GQ={gq} D={D} BS={BS} NB={NB}",
        max_abs_err=err,
        ms=time_ms(lambda: ops.paged_decode_attention_fused(*args), 20),
        plain_ms=time_ms(lambda: ref.ct_paged_attention_fused_ref(*args), 3,
                         1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    emit({"phase": "kernel", **recs["K1"]})

    # K2: frozen-pool partition of prefill chunks (queries folded into GQ)
    layer = {k: c[k][0] for k in ("k_codes", "v_codes", "k_scales",
                                  "v_scales")}
    for GQ in (gq, 16 * gq, 128 * gq):
        qh = torch.randn((1, H, GQ, D), generator=gen, device=dev)
        args = (qh, layer["k_codes"], layer["v_codes"], layer["k_scales"],
                layer["v_scales"], c["slot_state"][0, :1].contiguous(),
                c["slot_bits"][0, :1].contiguous(),
                c["block_table"][:1, 0].contiguous())
        outs = ops.paged_decode_attention_batched(*args)
        torch.cuda.synchronize()
        err = max_err(outs, ref.ct_paged_attention_batched_ref(*args))
        pool_b, n_slots = pool_need(args[5][None], args[7][:, None],
                                    per_block)
        b_ms, b_by = bound(pool_b + nbytes(qh, *args[5:], *outs),
                           4 * H * GQ * D * n_slots)
        rec = dict(
            name="ct_paged_attention_batched", route="cuda",
            source="src/repro_torch/kernels/csrc/ct_paged_attention.cu",
            replaces="src/repro/kernels/ct_paged_attention.py:285",
            shape=f"R=1 H={H} GQ={GQ} D={D} BS={BS} NB={NB}",
            max_abs_err=err,
            ms=time_ms(lambda: ops.paged_decode_attention_batched(*args), 20),
            plain_ms=time_ms(
                lambda: ref.ct_paged_attention_batched_ref(*args), 5, 1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        emit({"phase": "kernel", **rec})
        if GQ == 128 * gq:
            recs["K2"] = rec            # the big-chunk shape (most launches)

    # K3: intra-chunk causal attention with stats (big chunk; g-chunk)
    F = torch.nn.functional
    for S, n_valid in ((128, None), (G, 11)):
        q = torch.randn((S, mc.num_heads, D), generator=gen, device=dev)
        k = torch.randn((S, H, D), generator=gen, device=dev)
        v = torch.randn((S, H, D), generator=gen, device=dev)
        outs = ops.prefill_attention_stats(q, k, v, n_valid=n_valid)
        torch.cuda.synchronize()
        kv_valid = None if n_valid is None else \
            torch.arange(S, device=dev) < n_valid
        err = max_err(outs, ref.flash_prefill_stats_ref(
            q, k, v, kv_valid=kv_valid))
        nv = S if n_valid is None else n_valid
        pairs = sum(min(i + 1, nv) for i in range(S))
        flops = 4 * mc.num_heads * pairs * D
        b_ms, b_by = bound(nbytes(q, k[:nv], v[:nv], *outs), flops)
        # SDPA yardstick on the same inputs (kv heads repeated for GQA)
        qt = q.transpose(0, 1)[None]
        kt, vt = (x.transpose(0, 1).repeat_interleave(gq, 0)[None]
                  for x in (k, v))
        rec = dict(
            name="flash_prefill", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_prefill.cu",
            replaces="src/repro/kernels/flash_prefill.py:83",
            shape=f"S={S} Hq={mc.num_heads} H={H} D={D} n_valid={nv}",
            max_abs_err=err,
            ms=time_ms(lambda: ops.prefill_attention_stats(
                q, k, v, n_valid=n_valid), 20),
            plain_ms=time_ms(lambda: ref.flash_prefill_stats_ref(
                q, k, v, kv_valid=kv_valid), 10, 1),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 20))
        emit({"phase": "kernel", **rec})
        if n_valid is None:
            recs["K3"] = rec

    # K4: commit quantization, with subnormal-scale and saturating groups
    N = L * G * H
    x = torch.randn((N, D), generator=gen, device=dev)
    x[0, :16] *= 1e-4
    x[1, :16] *= 1e-6
    x[2, :16] = 0.0
    x[3, :16] *= 3000.0
    x[4, :16] = 448.0 * 127.0 * 1.5
    for bits in (2, 4, 8):
        codes, scales = ops.tbq_group_quant(x, bits)
        torch.cuda.synchronize()
        rc, rs = ref.group_quant_ref(x, bits)
        if not (torch.equal(codes, rc) and
                torch.equal(scales.view(torch.int16), rs.view(torch.int16))):
            bad = int((codes != rc).sum()) + int((scales.view(torch.int16)
                                                   != rs.view(torch.int16))
                                                  .sum())
            raise AssertionError(f"group_quant bits={bits}: {bad} codes or "
                                 f"scales differ from the plain version")
        b_ms, b_by = bound(nbytes(x, codes, scales), 8 * N * D)
        rec = dict(
            name="group_quant", route="cuda",
            source="src/repro_torch/kernels/csrc/group_quant.cu",
            replaces="src/repro/kernels/group_quant.py:70",
            shape=f"N={N} D={D} bits={bits}", max_abs_err=0.0,
            ms=time_ms(lambda: ops.tbq_group_quant(x, bits), 50),
            plain_ms=time_ms(lambda: ref.group_quant_ref(x, bits), 10, 1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        emit({"phase": "kernel", **rec})
        if bits == 4:
            recs["K4"] = rec
    for name, rec in recs.items():
        if name != "K4" and rec["max_abs_err"] > ATOL:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{rec['max_abs_err']} > {ATOL}")
    return recs


def serve(engine_cls, cfg, params, prompts, max_new, backend, dev):
    eng = engine_cls(cfg, params=params, backend=backend, device=dev,
                     record_logits=True)
    eng.submit(prompts, max_new_tokens=max_new)
    done = eng.run()
    return eng, done


def compare(ek, dk, er, dr):
    """Kernel-backend engine vs reference-backend engine on the same
    requests: tokens, logits against the reference's bar between its own
    backends (tests/test_engine_backends.py: |k - r| <= 1e-3 + 1e-3 |r|),
    and the pool bytes that differ (both engines claim physical blocks in
    the same order)."""
    import numpy as np
    import torch
    worst = over = 0.0
    for a in er.request_logits:
        lk, lr = np.stack(ek.request_logits[a]), np.stack(er.request_logits[a])
        diff = np.abs(lk - lr)
        worst = max(worst, float(diff.max()))
        over = max(over, float((diff / (ATOL + ATOL * np.abs(lr))).max()))
    return {"identical_tokens": sorted((r.arrival, r.output) for r in dk) ==
            sorted((r.arrival, r.output) for r in dr),
            "max_abs_logit_diff": worst, "max_diff_over_bar": over,
            "pool_bytes_differing": sum(
                int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                for a, b in zip(ek.pool.view, er.pool.view)),
            "audit_equal": ek.audit_pool() == er.audit_pool()}


def parity(engine_cls, cfg, params, prompts, short, max_new, dev):
    """The two backends on the card, where their results must agree.

    * prefill: prompts of one big chunk (K2 + K3) and one partial g-chunk
      (K2 + K3 with n_valid), each from an empty pool: first tokens equal,
      logits within the bar;
    * decode: the long prompts prefilled by the same (reference) attention
      in both engines, then ``max_new`` tokens through K1 in one and the
      dense path in the other.  A tick's keys and values come from the
      trunk and never from attention outputs (the ATTENTION-LATE tick), so
      while tokens agree the caches stay byte-identical: tokens equal,
      logits within the bar at every tick, pools equal.

    Free-running engines drift apart further: prefill-written keys and
    values of layers past the first depend on attention outputs, and a
    value that lands on the other side of a quantization boundary changes
    its code.  That run is reported (``free_running``), not held to the
    bar."""
    def run(backend, reqs, n, prefill_backend=None):
        eng = engine_cls(cfg, params=params, device=dev, record_logits=True,
                         backend=prefill_backend or backend)
        eng.submit(reqs, max_new_tokens=n)
        if prefill_backend:
            eng._admit_and_prefill()
            eng.backend = backend
        return eng, eng.run()

    pre = compare(*run("kernel", short, 1), *run("reference", short, 1))
    dec = compare(*run("kernel", prompts, max_new, "reference"),
                  *run("reference", prompts, max_new))
    free = compare(*run("kernel", prompts, max_new),
                   *run("reference", prompts, max_new))
    failed = [name for name, r in (("prefill", pre), ("decode", dec))
              if not (r["identical_tokens"] and r["max_diff_over_bar"] <= 1
                      and r["audit_equal"])]
    if dec["pool_bytes_differing"]:
        failed.append("decode pools")
    return {"prefill": pre, "decode": dec, "free_running": free,
            "failed": failed}


def profile_decode(engine_cls, cfg, params, prompts, dev, ticks=12):
    """Decode ticks of the serve phase's traffic under torch.profiler (the
    prompts prefilled first, outside the window; the window holds one
    commit round of all 4 slots): device time by kernel, the device's busy
    share of the window, and the engine's host spans (tick, cache
    maintenance)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    eng = engine_cls(cfg, params=params, backend="kernel", device=dev)
    eng.submit(prompts, max_new_tokens=ticks + 1)
    eng.run(max_ticks=0)                       # admission + prefill
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        eng.run(max_ticks=ticks)
        wall_ms = 1e3 * (time.perf_counter() - t1)
    spans, kernels = {}, {}
    for e in prof.events():
        on_card = str(e.device_type).endswith("CUDA")
        if e.name.startswith("thinkv."):
            sp = spans.setdefault(e.name, {"count": 0, "host_ms": 0.0})
            if not on_card:
                sp["count"] += 1
                sp["host_ms"] += e.cpu_time_total / 1e3
        elif on_card:
            k = kernels.setdefault(e.name[:90], [0.0, 0])
            k[0] += e.device_time_total / 1e3
            k[1] += 1
    busy_ms = sum(t for t, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"phase": "profile", "ticks": eng.metrics["ticks"],
            "window_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "spans": spans,
            "top_kernels": [{"name": n, "ms": t, "count": c}
                            for n, (t, c) in top],
            "seconds": time.perf_counter() - t0}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.config import ServeConfig, ThinKVConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.models.lm import init_params
    from repro_torch.serving.engine import ThinKVEngine

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    build.build_all()
    logs = build.build_logs()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in logs.items()}})

    mc = get_config("r1-llama-8b")
    tk = ThinKVConfig()
    t0 = time.perf_counter()
    recs = check_kernels(dev, mc, tk)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})

    # ---- serve: the main path at full width and depth ----
    cfg = ServeConfig(model=mc, thinkv=tk, max_seqs=4)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, mc.vocab_size, 1100) for _ in range(4)]
    max_new = 64
    t0 = time.perf_counter()
    params = init_params(mc, SEED, dev)
    init_s = time.perf_counter() - t0
    ops.reset_launches()
    eng, done = serve(ThinKVEngine, cfg, params, prompts, max_new, "kernel",
                      dev)
    launches = dict(ops.LAUNCHES)
    audit = eng.audit_pool()
    m = eng.metrics
    if len(done) != 4 or any(len(r.output) != max_new for r in done):
        raise AssertionError("not every request finished with its tokens")
    for arr in eng.request_logits.values():
        lg = np.stack(arr)
        if lg.shape != (max_new, mc.vocab_size) or not np.isfinite(lg).all():
            raise AssertionError(f"bad logits: shape {lg.shape}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} never launched on the main "
                                 f"path")
    if launches["ct_paged_attention_fused"] != m["ticks"]:
        raise AssertionError(f"K1 launched {launches['ct_paged_attention_fused']}"
                             f" times over {m['ticks']} ticks")
    emit({"phase": "serve", "layers": mc.num_layers, "requests": len(done),
          "prompt_len": 1100, "max_new": max_new, "init_s": init_s,
          "wall_s": m["wall_s"], "prefill_s": m["prefill_s"],
          "decode_s": m["decode_s"], "ticks": m["ticks"],
          "tokens": m["tokens"],
          "decode_tok_s": m["tokens"] / m["decode_s"],
          "ms_per_tick": 1e3 * m["decode_s"] / m["ticks"],
          "prefill_chunks": m["prefill_chunks"],
          "prefill_big_chunks": m["prefill_big_chunks"],
          "footprint_frac": float(np.mean(
              [r.stats["footprint_frac"] for r in done])),
          "avg_bits": float(np.mean([r.stats["avg_bits"] for r in done])),
          "launches": launches, "audit_claimed": audit["claimed"][:4],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del eng
    emit(profile_decode(ThinKVEngine, cfg, params, prompts, dev))
    del params
    torch.cuda.empty_cache()

    # ---- parity: kernel vs reference backend, 4 layers at full width ----
    t0 = time.perf_counter()
    mc4 = dataclasses.replace(mc, num_layers=4)
    cfg4 = ServeConfig(model=mc4, thinkv=tk, max_seqs=4)
    params4 = init_params(mc4, SEED, dev)
    short = [rng.integers(0, mc.vocab_size, n) for n in (128, 12)]
    rec = parity(ThinKVEngine, cfg4, params4, prompts, short, max_new, dev)
    emit({"phase": "parity", "layers": 4, **rec,
          "seconds": time.perf_counter() - t0})
    if rec["failed"]:
        raise AssertionError(f"kernel and reference backends disagree: "
                             f"{rec['failed']}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    lines = []
    for rec in recs.values():
        rec["launches"] = launches[rec["name"]]
        lines.append({k: rec[k] for k in keys})
    emit({"phase": "done", "seconds": time.perf_counter() - t_all})
    emit({"kernels": lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
