#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # every phase, one CUDA card
    python3 chip_smoke.py --ab DIR   # DIR/src (a parent checkout) against
                                     # this tree: kernels, commit_profile,
                                     # serve, prefill_profile, profile and
                                     # the ssm prefill, in the order
                                     # parent, this, this, parent
    python3 chip_smoke.py --families-leg [--src DIR/src]
                                     # the train_mesh phase's SSM, hybrid
                                     # and encoder-decoder leg alone, on
                                     # this tree's port (or DIR's)

Phases, each printing one JSON line and raising (non-zero exit) on any
failure:

1. device     — the card, torch and CUDA versions;
2. build      — the CUDA kernels built from ``src/repro_torch/kernels/csrc``
                with nvcc (one process per source, started together);
3. kernels    — K1-K5 and the single-request ``ct_paged_attention`` wrapper
                against their plain PyTorch versions on the card at the
                main paths' full-width shapes (<= 1e-3 abs for attention,
                bit-exact for the quantizer, rtol = atol = 3e-4 for the
                selective scan), with their device time (``device_ms``) and
                eager time, the plain version's time, the bound (the larger
                of bytes / 3.35 TB/s and operations / the peak of the units
                that run them, named in ``bound_peak``) and, for K3, SDPA's
                time as a yardstick; K3 also without its stats
                (``prefill_attention``); K4 at a commit's shape (K and V
                bf16 [32, 16, 8, 128], one launch, at each thought's width)
                and through its direct entry (f32 [N, D], bits 2, 4, 8);
   commit_profile — one group commit at r1-llama-8b's cache width under
                torch.profiler: the device kernels and copies it runs;
   trace      — K1-K4 against their plain versions at the traces' shapes
                (head_dim 16, BS 8, K2 split and merged, K1 and K2 also at
                an odd kv head count; 1e-3 abs, K4 bit-exact), each timed
                against its bound, then the
                flash, the pressure and the sampled trace (the JAX
                engine's parameters; the pressure trace oversubscribes a
                14-block pool with the prefix cache on, the sampled trace
                is the pressure trace at temperature 0.7, top-p 0.9 in
                packs of up to 8 ticks, the rkv and uniform traces are the
                pressure trace under those retention policies with the
                drift probe on; the moe, qwen2 and vlm traces are the
                pressure trace on mixtral-8x7b's, qwen2-7b's and
                paligemma-3b's smoke configs, qkv biases non-zero) on the
                kernel and the reference backend, each held to the JAX
                reference engine's record (``tests/golden/torch_{flash,
                pressure,sampled,rkv,uniform,moe,qwen2,vlm}_trace.npz``):
                identical tokens, logits within
                1e-3, equal
                counters (dispatches and early exits among them) and pool
                audit, each request's drift (steps and top-1 agreement
                equal, magnitudes within 2e-3), K1 once per tick, K2 and
                K3 launched, K4 once per commit the run made;
4. serve      — the port's engine on the full r1-llama-8b config (32 layers,
                random weights from a seed), kernel backend, 4 requests of
                1100-token prompts and 64 new tokens; launch counts are
                zeroed just before and read just after, and K1-K4 must have
                run (K1 once per tick, K2 and K3 once per prefill chunk and
                layer: big chunks at GQ 512 / S 128, g-chunks at GQ 64 /
                S 16; K4 once per group commit, 288);
5. prefill_profile — the first 332 tokens of a serve prompt (2 big
                chunks, 5 g-chunks) prefilled under torch.profiler: K2's and
                K3's device time, the device's busy share, host spans;
   profile    — 12 decode ticks of the same traffic under torch.profiler:
                device time by kernel, the device's busy share, host spans;
   pressure   — the oversubscribed pool at r1-llama-8b's full width (8 of
                its 32 layers, ``CUT_LAYERS``, to keep the script within
                its time limit; random weights, kernel backend, 4 slots,
                ThinKVConfig
                with a 512-token budget), the prefix cache on: 8 requests of
                384-768 tokens (four share a 256-token prefix, priorities
                0/1) and 64 new tokens on a pool of 0.5 * 4 * NB blocks,
                which must preempt, resume, hit the cache and COW-fault
                without a spill storm; every request's tokens, clean
                audits after the run and after every preemption and
                resume, every resume bit-exact against its spill, K1 once
                per tick and K4 once per commit; against an unpressured
                pool without the cache and against the reference backend
                only reported;
   serve_step — the dense serve steps at the serve phase's shapes: the 4
                prompts prefilled by a kernel-backend engine, their pool
                views and buffers gathered into the ThinKV step's batch,
                one ThinKV decode step on ``backend="kernel"`` (one K1
                launch per layer for the batch) held against the same
                step with K1's plain version (logits <= 1e-3), the
                reference backend's gap reported; K1 at the step's shape
                (L 1, R 4, the batch's pool of B·L·NB blocks) against its
                plain version (<= 1e-4) with its device time and bound;
                the FullKV prefill of the same prompts and one FullKV
                decode step (bf16 caches); device ms per step, KV bytes
                per request and the two steps' top-1 agreement;
   audit      — the entry-point contracts (``repro_torch.analysis``) at
                the serve shapes, one rank, both backends, 8 ticks per
                dispatch, the drift probe on: each entry point run once
                on a scratch request (K1 once per tick and per trip, K2
                and K3 once per layer of a chunk, K4 once per commit, no
                fp64, no collective; the census's dispatches equal to
                ``ops.LAUNCHES``) and the standalone K3 entry; then the
                host syncs per entry point on a line of their own;
   sampled    — the serve phase's model at 8 of its 32 layers
                (``CUT_LAYERS``) and its first two prompts, each with
                ``samples_per_slot=2`` (2 parents and 2 forks on 4 slots),
                at DeepSeek-R1-Distill's published sampling settings
                (temperature 0.6, top-p 0.95), 64 new tokens, served at 1,
                8, 8 and 1 ticks per dispatch: bit-identical tokens and
                logits across the four runs, children other than their
                parents; greedy at 8 the children equal their parents; in
                every run 2 forks, COW faults on forked slots, a clean
                audit, K1 once per tick, K4 once per commit; ms/tick,
                dispatches per token, the sampler's device time at
                [4, 128256] and ``fork_slot``'s time;
   policy     — the pressure phase's model at 8 of its 32 layers, pool
                and traffic served under each retention policy
                (``thinkv``, the control arm,
                ``rkv`` and ``uniform``) with the drift probe on: per
                policy preemptions, resumes, COW faults, commits, the
                footprint as a share of bf16, mean bits, ``prefill_s``,
                ms/tick and drift (max, mean, top-1 agreement against the
                dense replay); held: every request's tokens, a clean
                audit, one probe per request with finite drift, K1 once
                per tick, K4 once per commit, uniform's mean bits 4.00;
   tp         — tensor-parallel serving over kv heads on 2 gloo ranks
                (``launch.mesh.run_ranks``, both on the one card):
                the pressure phase's traffic at its depth on both
                backends, every rank bit-identical (tokens, every logit,
                counters, audit) to the pressure phase's one-process run
                of that backend, and a prefix detached on 2 ranks equal
                to one detached here on one rank and decoding the same
                16 tokens after an insert into this one-rank engine;
                then, this process holding no weights, r1-llama-8b at
                full width and depth on 2 ranks (32.1 GB of weights
                each) serving the serve phase's traffic, every rank
                bit-identical to the serve phase's run, with its launch
                contracts (K1 once per tick, K2 and K3 once per layer
                per chunk, K4 once per commit, launch counts zeroed just
                before and read just after) and a clean
                ``audit_compiled()``; per rank ms per tick, the gather's
                time and peak memory;
6. parity     — a 4-layer full-width model through the kernel and the
                reference backends where their results must agree (see
                ``parity``): identical tokens, logits within the reference's
                bar between its backends (1e-3 + 1e-3 |logit|), and for
                decode byte-identical pools;
   archs      — the MoE family and the dense configs of other head
                groupings: K1-K4 against their plain versions at the
                full-width shapes of qwen2-7b (28 q / 4 kv heads, GQ 7),
                mixtral-8x7b (GQ 4), llama4-scout (GQ 5), yi-6b (GQ 8 over
                4 kv heads) and mistral-large-123b (GQ 12), with device
                time, bound and SDPA's time for K3; then qwen2-7b at full
                width and depth (random f32 weights, 30.3 GB) and
                mixtral-8x7b at full width and 4 of its 32 layers (24.3
                GB), each serving the serve phase's traffic on the kernel
                backend with its launch checks, held to the reference
                backend from identical state (the parity phase's prefill
                and decode checks) and, for mixtral, its routing per layer
                (kept choices per expert, dropped choices) from a second
                run with the same tokens; qwen2-7b's 28-layer prefill
                (two big chunks, a g-chunk from an empty pool and one
                after a big chunk), each backend held within the parity
                bar of the f64 run of the plain path that follows its
                stored codes and bf16 keys and values
                (``f64_prefill_check``: one layer's weights cast to f64
                at a time), and the backends' prefill held to each other
                at 4 layers;
   vlm        — paligemma-3b (head_dim 256, one kv head, GQ 8, tied and
                scaled embeddings, GeGLU): K1-K4 at its full-width shapes
                against their plain versions with times, bounds and
                SDPA's time at D 256; the full model (18 layers, ~10 GB)
                serving the serve phase's traffic on the kernel backend
                with its launch checks, held to the reference backend
                (decode from identical state; prefill at 4 layers), both
                backends' prefill held within the bar of the f64 run, and
                the serve steps with an image prefix
                (patches [4, 256, 1152]: a 1356-row prefill, one FullKV
                step, one ThinKV step on K1 at D 256 against the plain
                K1's);
   hybrid     — zamba2-7b at full width and depth (81 Mamba-2 layers and
                ONE shared attention block after every 6th: 13
                invocations of 32 x 112 heads; random f32 weights, ~27
                GB) through ``serving/serve_step.py``: a 4 x 512 prefill,
                64 FullKV steps from an empty state over the prompts'
                first tokens (the last 16 held to the teacher-forced
                forward, rtol = atol = 5e-3), the ThinKV step on a seeded
                pool with the FullKV run's Mamba-2 states on the kernel
                backend (K1 at head_dim 112, once per invocation: 13
                launches, counts zeroed just before and read just after)
                held to the same step over the plain K1 (logits <= 1e-3,
                greedy tokens, buffers within one bf16 step) and beside
                the reference backend (greedy tokens where its margin
                allows), K1 at the step's shape against its plain version
                with its time and bound, and the hybrid record
                (``tests/golden/torch_hybrid_steps.npz``) on the kernel
                backend; first K2 and K3 at the shared block's head_dim
                112 (32 q / 32 kv heads, GQ 1, BS 16, NB 128: K2 at a big
                chunk's 128 rows and a g-chunk's 16, K3 at S 128 and at S
                16 with 11 valid keys) against their plain versions, with
                times, bounds and SDPA's time (no serving path launches
                them);
   encdec     — whisper-medium at full width and depth (24 + 24 layers,
                1500 stub frames, 16 x 64 heads; ~3 GB): the same, the
                prefill step running the encoder, the cross KV from
                ``cross_caches`` TBQ'd at 4 bits through K4's direct entry
                (bit-exact to its plain version, timed against its
                bound), K1 at D 64 once per decoder layer, and the encdec
                record;
7. ssm        — falcon-mamba-7b at full width and depth (64 layers, random
                f32 weights from a seed, ~28 GB) through
                ``serving/serve_step.py``: a 4 x 1024-token prefill (K5 in
                every layer), 4 requests stepped through 128-token prompts
                and 64 greedy tokens, the teacher-forced forward against
                the decode logits at every position (rtol = atol = 5e-3),
                and K5 against the plain scan at 4 layers
                (1e-3 + 1e-3 |logit|, identical greedy tokens);
8. controller — the single-request ThinKV controller (``core/thinkv.py``)
                at r1-llama-8b's cache width (32 layers, 8 kv heads, head
                dim 128, default ThinKVConfig): ``step_token`` over a
                2048-token K/V stream, and at every tau boundary every
                layer's ``thinkv_decode_attention`` through the wrapper
                against ``decode_attention_ref`` (3e-4 + 3e-4 |r|).
   examples   — the port's examples at their default sizes on the card,
                each held to its own CPU run: ``quickstart_torch.py``
                (integers, codes and scales equal, floats within 1e-5;
                its commits on K4, its decode read once on K2 through the
                wrapper), ``calibrate_thoughts_torch.py`` (L*, thresholds,
                labels, accuracy equal) and ``serve_reasoning_torch.py``
                on the batch path, ``--stream``, ``--samples 2`` and
                ``--ticks-per-dispatch 4`` (the kernel backend's tokens
                those of the CPU's reference backend from the same
                weights; K1 once per tick, K2 and K3 once per prefill
                chunk and layer, K4 once per commit; counts zeroed just
                before each run and read just after).
9. train      — single-card training, which runs no kernel of the port
                (K1-K5 have no backward; the reference's train path runs
                plain XLA): r1-llama-8b at full width and 2 of its 32
                layers (1.487 G parameters, random f32 weights from seed
                0, TF32 off), ``lm_batches`` at batch 8 and sequence 512
                (the loss in 2 chunks of 256), remat on.  Step 1's loss
                and gradient norm within 1e-4 relative of the same step
                evaluated in f64 (an f64 copy of the weights through the
                same code), every gradient leaf within 1e-4 of its largest
                |g|, and the same for the step in two microbatches; then 8
                default AdamW steps: ms per step, tokens per second, the
                share of the f32 peak that 6·N·tokens reaches
                (``roofline/analysis.py``'s ``model_flops_for`` over its
                ``F32_FLOPS``: N the reference's active parameter count,
                the embedding table among them; and with N the
                parameters in products, also with the recomputed forward
                8·N·tokens), peak GB, the losses, zero kernel launches;
                the JAX train record (``tests/golden/
                torch_train_steps.npz``) replayed within 1e-4 relative; a
                smoke run failing at step 5 and resumed ending on the
                uninterrupted run's loss within 1e-4; the train step's
                contract on the card.
   train_mesh — sharded training on gloo ranks sharing the card
                (``train_mesh_phase``): the train phase's model, batch
                and seed on 2 ranks, data 2 and then data 1 x model 2
                (the compute split over ``model``), 2 and 3 steps, step
                1's loss, gradient and every parameter held to the
                one-rank step (the reference's bars); per rank the bytes
                held between steps, the peak, ms per step and per step
                the collective bytes by kind, axis and what moves, equal
                to the dry run's count, no parameter gathered over
                ``model``; zero kernel launches; the same at data 1 x
                model 2 for falcon-mamba-7b (2 of 64 layers), zamba2-7b (7
                of 81: a group of 6 Mamba-2 layers, the shared block, a
                tail layer; 4 x 512 each) and whisper-medium (2 + 2 of 24
                + 24 layers, 1500 frames, 4 x 256), 2 steps each; the dry
                run at the production meshes, timed; then at smoke size yi-6b and mixtral on
                (data 2, model 2) held to the one-rank step, the trainer
                resumed 1 -> 2 and 2 -> 1 ranks against an uninterrupted
                run, and ring attention, the pipeline, the compressed
                cross-pod gradient and the overlapped MoE FFN over 2
                ranks on card tensors against their one-rank formulas.

Then the kernels line (each kernel's launches on its own path: K1-K4 from
the serve phase, from the tp phase's serve leg (rank 0) as
``launches_tp``, from the pressure phase as ``launches_pressure`` and from
the sampled phase's first run at 8 ticks per dispatch as
``launches_sampled``, from the policy phase's runs as ``launches_policy``
(by policy) and, for K1, from the serve_step phase's ThinKV step as
``launches_serve_step``, K1-K4 from the archs phase's runs as
``launches_archs`` with their times at its shapes under ``archs``, from
the vlm phase's run as ``launches_vlm`` (K1 also from its serve step) with
their times at its shapes under ``vlm``, K1 from the hybrid and encdec
phases' ThinKV steps as ``launches_hybrid`` / ``launches_encdec`` (its
times at those steps' shapes under ``by_shape``, head_dim 112 and 64) and
K4 from the encdec phase's cross KV, from the traces' kernel-backend
replays as ``launches_trace`` with their times at head_dim 16 under
``trace``, K2 and K3 also by shape (their head_dim 112 records from the
hybrid phase among them, 0 launches), K5 from the ssm phase's
prefill, the wrapper from the controller phase, every kernel's count in
each example's card run as ``launches_examples``, and every kernel's 0
from the train_mesh phase as ``launches_train_mesh``), the card's name and power limit as nvidia-smi gives
them, and last ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
# --src DIR imports the port from another tree (the A/B run's parent)
SRC = os.path.abspath(sys.argv[sys.argv.index("--src") + 1]) \
    if "--src" in sys.argv else os.path.join(HERE, "src")
sys.path.insert(0, SRC)
# tests/ holds the JAX records' reader (test_torch_steps_record, numpy only)
sys.path.insert(1, os.path.join(HERE, "tests"))



def _roofline_module():
    """This checkout's ``repro_torch/roofline/analysis.py`` (by its path,
    so an A/B run's ``--src`` tree does not replace it): the H100's peaks
    and the 6·N·tokens count."""
    import importlib.util
    path = os.path.join(HERE, "src", "repro_torch", "roofline",
                        "analysis.py")
    spec = importlib.util.spec_from_file_location("_chip_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # its dataclass looks itself up
    spec.loader.exec_module(mod)
    return mod


RA = _roofline_module()
HBM_BYTES_PER_S = RA.HBM_BW       # H100 SXM HBM3
F32_FLOPS = RA.F32_FLOPS          # H100 SXM fp32, CUDA cores
F64_TC_FLOPS = RA.F64_TC_FLOPS    # H100 SXM fp64 tensor cores (K2, K3)
PEAKS = RA.PEAKS
SFU_PER_SM_CLOCK = 16           # special-function unit results (ex2) per SM
ATOL = 1e-3
SCAN_TOL = 3e-4                 # the JAX package's bar, scan kernel vs oracle
SSM_TOL = 5e-3                  # the JAX package's bar, decode vs forward
SEED = 0
K1_K4 = ("ct_paged_attention_fused", "ct_paged_attention_batched",
         "flash_prefill", "group_quant")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA graph,
    the graph replayed ``reps`` times between CUDA events.  The replay
    launches the same kernels with no host work between them, so a launch
    shorter than its host dispatch is timed too (``time_ms`` times the
    dispatch then)."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Eager time of one ``fn()`` (host dispatch included): CUDA events
    around ``iters`` calls."""
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


def bound(bytes_: float, flops: float, sfu_s: float = 0.0,
          peak: str = "f32"):
    """(ms, what bounds it, the peak used): bytes over HBM, flops over the
    peak of the units the kernel runs them on (``PEAKS``), and ``sfu_s``
    seconds of special-function work."""
    rate, name = PEAKS[peak]
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, max(flops / rate, sfu_s)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            f"HBM 3.35 TB/s; {name}")


def over_bar(got, want, tol: float) -> float:
    """max |got - want| / (tol + tol |want|): <= 1 passes the bar."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError("output is not finite")
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


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


def commit_buffers(gen, dev, L, G, H, D):
    """A commit's bf16 K and V buffers [L, G, H, D], their first groups
    with an amax in the E4M3 subnormal scale range, at zero, and at and
    past the 448 saturation edge."""
    import torch
    x = torch.randn((2, L * G * H, D), generator=gen, device=dev)
    x[:, 0, :16] *= 1e-4
    x[:, 1, :16] *= 1e-6
    x[:, 2, :16] = 0.0
    x[:, 3, :16] *= 3000.0
    x[:, 4, :16] = 448.0 * 127.0 * 1.5
    x[:, 5, :16] = 448.0
    x[1] *= 40.0
    return [a.reshape(L, G, H, D).to(torch.bfloat16) for a in x]


def commit_quant(ops, ref, k, v, bits, levels):
    """(the tree's quantization of one commit, its plain version): one K4
    launch (``tbq_commit_quant``), or on a tree from before it (an A/B
    parent) what that tree's commit ran: both buffers widened to f32, K4
    at every level, the thought's selected."""
    if hasattr(ops, "tbq_commit_quant"):
        return (lambda: ops.tbq_commit_quant(k, v, bits, levels),
                lambda: ref.group_quant_commit_ref(k, v, bits, levels))

    def per_level(quant):
        import torch

        def one(x, b):
            codes, scales = quant(x.reshape(-1, x.shape[-1]), b)
            return codes.reshape(x.shape), scales.reshape(*x.shape[:-1], -1)

        def run():
            kf, vf, out = k.float(), v.float(), None
            for b in levels:
                q = (*one(kf, b), *one(vf, b))
                out = q if out is None else tuple(
                    torch.where(bits == b, n, o) for n, o in zip(q, out))
            return out
        return run
    return per_level(ops.tbq_group_quant), per_level(ref.group_quant_ref)


def assert_same_quant(got, want, what):
    """Codes and scale bits equal (K4 is held bit-exact)."""
    import torch
    bad = 0
    for g, w in zip(got, want):
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        bad += int((g != w).sum())
    if bad:
        raise AssertionError(f"group_quant {what}: {bad} codes or scales "
                             f"differ from the plain version")


def kernel_record(name, source, replaces, shape, err, fn, plain, bound_,
                  library=None, plain_iters=5, **extra):
    """One kernel's record: device and eager times of ``fn``, the plain
    version's eager time, the bound (ms, by, peak) and its share."""
    ms = device_ms(fn)
    b_ms, b_by, b_peak = bound_
    rec = dict(name=name, route="cuda",
               source=f"src/repro_torch/kernels/csrc/{source}",
               replaces=f"src/repro/kernels/{replaces}", shape=shape,
               max_abs_err=err, ms=ms, eager_ms=time_ms(fn, 20),
               plain_ms=time_ms(plain, plain_iters, 1), bound_ms=b_ms,
               bound_by=b_by, bound_peak=b_peak, bound_share=b_ms / ms,
               library_ms=None if library is None else device_ms(library),
               **extra)
    emit({"phase": "kernel", **rec})
    return rec


PAGED = ("ct_paged_attention.cu", "ct_paged_attention.py")


def paged_per_block(BS, H, D) -> int:
    """Bytes of one pool block: K and V codes and their bf16 scales."""
    return BS * H * (2 * D + 2 * 2 * (D // 16))


def k1_record(gen, dev, L, R, H, gq, D, BS, NB, G, label=""):
    """K1 over a whole decode tick (every layer and slot) against its plain
    version; returns (record, the pool case)."""
    import torch
    from repro_torch.kernels import ops, ref
    c = pool_case(gen, dev, L, R, H, D, BS, NB, R * NB, G, gq)
    args = tuple(c.values())
    out = ops.paged_decode_attention_fused(*args)
    torch.cuda.synchronize()
    err = max_err(out, ref.ct_paged_attention_fused_ref(*args))
    pool_b, n_slots = pool_need(c["slot_state"], c["block_table"],
                                paged_per_block(BS, H, D))
    n_buf = L * int(c["buf_len"].sum())
    flops = 4 * H * gq * D * (n_slots + n_buf)
    rec = kernel_record(
        "ct_paged_attention_fused", PAGED[0], f"{PAGED[1]}:204",
        f"{label}L={L} R={R} H={H} GQ={gq} D={D} BS={BS} NB={NB}", err,
        lambda: ops.paged_decode_attention_fused(*args),
        lambda: ref.ct_paged_attention_fused_ref(*args),
        bound(pool_b + nbytes(c["qh"], c["slot_state"], c["slot_bits"],
                              c["block_table"], c["buf_len"], out)
              + 2 * n_buf * H * D * 2, flops), plain_iters=3)
    return rec, c


def k2_record(gen, dev, c, GQ, label=""):
    """K2 over layer 0 of slot 0 of pool case ``c`` at ``GQ`` query rows
    per kv head (a chunk's queries folded into the group) against its
    plain version."""
    import torch
    from repro_torch.kernels import ops, ref
    _, BS, H, D = c["k_codes"].shape[1:]
    NB = c["block_table"].shape[-1]
    qh = torch.randn((1, H, GQ, D), generator=gen, device=dev)
    args = (qh, c["k_codes"][0], c["v_codes"][0], c["k_scales"][0],
            c["v_scales"][0], c["slot_state"][0, :1].contiguous(),
            c["slot_bits"][0, :1].contiguous(),
            c["block_table"][:1, 0].contiguous())
    outs = ops.paged_decode_attention_batched(*args)
    torch.cuda.synchronize()
    err = max_err(outs, ref.ct_paged_attention_batched_ref(*args))
    pool_b, n_slots = pool_need(args[5][None], args[7][:, None],
                                paged_per_block(BS, H, D))
    return kernel_record(
        "ct_paged_attention_batched", PAGED[0], f"{PAGED[1]}:285",
        f"{label}R=1 H={H} GQ={GQ} D={D} BS={BS} NB={NB}", err,
        lambda: ops.paged_decode_attention_batched(*args),
        lambda: ref.ct_paged_attention_batched_ref(*args),
        bound(pool_b + nbytes(qh, *args[5:], *outs),
              4 * H * GQ * D * n_slots, peak="f64tc"))


def k3_record(gen, dev, S, n_valid, Hq, H, D, label="", plain=False):
    """K3 (intra-chunk causal attention with stats; ``n_valid`` masks a
    g-chunk's padded keys) against its plain version, with SDPA's time on
    the same inputs as the library yardstick; with ``plain`` also the
    variant without stats at the same shape."""
    import torch
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    q = torch.randn((S, Hq, D), generator=gen, device=dev)
    k = torch.randn((S, H, D), generator=gen, device=dev)
    v = torch.randn((S, H, D), generator=gen, device=dev)
    outs = ops.prefill_attention_stats(q, k, v, n_valid=n_valid)
    torch.cuda.synchronize()
    kv_valid = None if n_valid is None else \
        torch.arange(S, device=dev) < n_valid
    err = max_err(outs, ref.flash_prefill_stats_ref(q, k, v,
                                                    kv_valid=kv_valid))
    nv = S if n_valid is None else n_valid
    pairs = sum(min(i + 1, nv) for i in range(S))
    flops = 4 * Hq * pairs * D
    # SDPA yardstick on the same inputs (kv heads repeated for GQA)
    qt = q.transpose(0, 1)[None]
    kt, vt = (x.transpose(0, 1).repeat_interleave(Hq // H, 0)[None]
              for x in (k, v))
    rec = kernel_record(
        "flash_prefill", "flash_prefill.cu", "flash_prefill.py:83",
        f"{label}S={S} Hq={Hq} H={H} D={D} n_valid={nv}", err,
        lambda: ops.prefill_attention_stats(q, k, v, n_valid=n_valid),
        lambda: ref.flash_prefill_stats_ref(q, k, v, kv_valid=kv_valid),
        bound(nbytes(q, k[:nv], v[:nv], *outs), flops, peak="f64tc"),
        library=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), plain_iters=10)
    if plain:
        out = ops.prefill_attention(q, k, v)
        torch.cuda.synchronize()
        kernel_record(
            "flash_prefill", "flash_prefill.cu", "flash_prefill.py:83",
            rec["shape"] + " (no stats: prefill_attention)",
            max_err(out, ref.flash_prefill_ref(q, k, v)),
            lambda: ops.prefill_attention(q, k, v),
            lambda: ref.flash_prefill_ref(q, k, v),
            bound(nbytes(q, k, v, out), flops, peak="f64tc"),
            plain_iters=10)
    return rec


def k4_commit_record(gen, dev, L, G, H, D, tk, label=""):
    """K4 over one commit's K and V buffers [L, G, H, D] (bf16, with
    subnormal-scale, zero and saturating groups), bit-exact against its
    plain version at each thought's width; returns (record at the last
    width, the buffers)."""
    import torch
    from repro_torch.kernels import ops, ref
    k, v = commit_buffers(gen, dev, L, G, H, D)
    levels = tuple(sorted(set(tk.precision)))
    for thought, width in enumerate(tk.precision):
        bits = torch.tensor(width, dtype=torch.int32, device=dev)
        fn, plain = commit_quant(ops, ref, k, v, bits, levels)
        got, want = fn(), plain()
        torch.cuda.synchronize()
        assert_same_quant(got, want, f"{label}commit, thought {thought}")
    outs = fn()
    rec = kernel_record(
        "group_quant", "group_quant.cu", "group_quant.py:70",
        f"{label}commit: K, V bf16 [L={L}, G={G}, H={H}, D={D}] at bits "
        f"{width} of {levels}", 0.0, fn, plain,
        bound(nbytes(k, v, bits, *outs), 8 * 2 * k.numel()), plain_iters=10)
    return rec, k


def check_kernels(dev, mc, tk):
    """K1-K4 and the wrapper vs their plain versions at full width; returns
    per-kernel records keyed K1, K2 (GQ 512), K2_64, K2_4, K3 (S 128),
    K3_16, K4, wrapper, K5 (timings from this run).  ``ms`` is device time
    (``device_ms``), ``eager_ms`` the same calls dispatched one by one."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    L, H, D = mc.num_layers, mc.num_kv_heads, mc.head_dim
    gq, R, BS, G = mc.num_heads // H, 4, tk.block_size, tk.group_size
    NB = int(tk.token_budget * 2) // BS
    per_block = paged_per_block(BS, H, D)

    # K1: a whole decode tick's attention
    recs = {}
    recs["K1"], c = k1_record(gen, dev, L, R, H, gq, D, BS, NB, G)
    # K2: frozen-pool partition of prefill chunks (queries folded into GQ)
    for GQ, key in ((gq, "K2_4"), (16 * gq, "K2_64"), (128 * gq, "K2")):
        recs[key] = k2_record(gen, dev, c, GQ)
    # K3: intra-chunk causal attention with stats (big chunk; g-chunk)
    recs["K3"] = k3_record(gen, dev, 128, None, mc.num_heads, H, D,
                           plain=True)
    recs["K3_16"] = k3_record(gen, dev, G, 11, mc.num_heads, H, D)
    # K4: one commit's quantization (L x G x H rows of D, K and V in bf16)
    # at each thought's width, with subnormal-scale, zero and saturating
    # groups; then the direct entry (f32 [N, D]) at bits 2, 4 and 8
    recs["K4"], k = k4_commit_record(gen, dev, L, G, H, D, tk)
    N = L * G * H
    x = k.float().reshape(N, D)
    for bits in (2, 4, 8):
        codes, scales = ops.tbq_group_quant(x, bits)
        torch.cuda.synchronize()
        assert_same_quant((codes, scales), ref.group_quant_ref(x, bits),
                          f"direct, bits {bits}")
        rec = kernel_record(
            "group_quant", "group_quant.cu", "group_quant.py:70",
            f"direct: N={N} D={D} bits={bits}", 0.0,
            lambda: ops.tbq_group_quant(x, bits),
            lambda: ref.group_quant_ref(x, bits),
            bound(nbytes(x, codes, scales), 8 * N * D), plain_iters=10)
        if bits == 4:
            recs["K4_direct"] = rec
    # the single-request wrapper at r1-llama-8b's shape: a shuffled physical
    # pool, physical metadata, a raw table with -1 entries, one K2 launch
    NPw = NB + 16
    state = torch.where(torch.rand((NPw, BS), generator=gen, device=dev)
                        < 0.8, 1, 2).to(torch.uint8)
    bits = torch.tensor([2, 4, 8], dtype=torch.uint8, device=dev)[
        torch.randint(0, 3, (NPw, BS), generator=gen, device=dev)]
    table = torch.randperm(NPw, generator=gen, device=dev)[:NB] \
        .to(torch.int32)
    table[torch.rand(NB, generator=gen, device=dev) < 0.1] = -1
    planes = {k: c[k][0, :NPw] for k in ("k_codes", "v_codes", "k_scales",
                                         "v_scales")}
    q = torch.randn((mc.num_heads, D), generator=gen, device=dev)
    args = (q, planes["k_codes"], planes["v_codes"], planes["k_scales"],
            planes["v_scales"], state, bits, table)
    outs = ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    err = max_err(outs, ref.ct_paged_attention_ref(*args))
    logical, _ = ref.logical_metadata(state, bits, table)
    pool_b, n_slots = pool_need(logical[None, None], table[None, None],
                                per_block)
    recs["wrapper"] = kernel_record(
        "ct_paged_attention", PAGED[0], f"{PAGED[1]}:355",
        f"Hq={mc.num_heads} H={H} D={D} BS={BS} NB={NB} NP={NPw}", err,
        lambda: ops.paged_decode_attention(*args),
        lambda: ref.ct_paged_attention_ref(*args),
        bound(pool_b + nbytes(q, table, *outs) + 2 * NB * BS,
              4 * H * gq * D * n_slots, peak="f64tc"))

    for name, rec in recs.items():
        if not name.startswith("K4") and rec["max_abs_err"] > ATOL:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{rec['max_abs_err']} > {ATOL}")
    recs["K5"] = check_mamba_scan(dev, gen)
    over = [n for n, r in recs.items() if r["bound_share"] > 1]
    if over:
        raise AssertionError(f"a bound above the measured time: {over}")
    return recs


def check_mamba_scan(dev, gen, B=4, S=1024, di=8192, N=16):
    """K5 at falcon-mamba-7b's prefill shape (one launch per layer for the
    whole batch) against ``mamba_scan_ref``, rtol = atol = 3e-4."""
    import torch
    from repro_torch.kernels import ops, ref
    x = torch.randn((B, S, di), generator=gen, device=dev)
    dt = 0.01 + 0.1 * torch.rand((B, S, di), generator=gen, device=dev)
    b = torch.randn((B, S, N), generator=gen, device=dev)
    c = torch.randn((B, S, N), generator=gen, device=dev)
    a = -torch.exp(torch.randn((di, N), generator=gen, device=dev))
    y = ops.mamba_scan(x, dt, b, c, a)
    torch.cuda.synchronize()
    want = ref.mamba_scan_ref(x, dt, b, c, a)
    over = over_bar(y, want, SCAN_TOL)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_exp = B * S * di * N
    b_ms, b_by, b_peak = bound(nbytes(x, dt, b, c, a, y), 5 * n_exp,
                               n_exp / (SFU_PER_SM_CLOCK * sms * clock_hz))
    rec = kernel_record(
        "mamba_scan", "mamba_scan.cu", "mamba_scan.py:64",
        f"B={B} S={S} di={di} N={N}", max_err(y, want),
        lambda: ops.mamba_scan(x, dt, b, c, a),
        lambda: ref.mamba_scan_ref(x, dt, b, c, a),
        (b_ms, b_by, b_peak + f"; exp on the SFUs ({SFU_PER_SM_CLOCK} per "
         f"SM per clock at {clock_hz / 1e6:.0f} MHz)"), plain_iters=2,
        max_over_bar=over, sm_clock_max_hz=clock_hz, sms=sms)
    if over > 1:
        raise AssertionError(f"K5 disagrees with its plain version: "
                             f"{over} x the bar (rtol = atol = {SCAN_TOL})")
    return rec


def serve(engine_cls, cfg, params, prompts, max_new, backend, dev, **kw):
    eng = engine_cls(cfg, params=params, backend=backend, device=dev,
                     record_logits=True, **kw)
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


def parity(engine_cls, cfg, params, prompts, short, max_new, dev,
           free_running=True, hold=("prefill", "decode")):
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
    its code.  That run is reported (``free_running``; skipped when the
    flag is off), not held to the bar.  ``hold`` names the comparisons
    held; the others are reported."""
    def run(backend, reqs, n, prefill_backend=None):
        eng = engine_cls(cfg, params=params, device=dev, record_logits=True,
                         backend=prefill_backend or backend)
        eng.submit(reqs, max_new_tokens=n)
        if prefill_backend:
            eng.run(max_ticks=0)               # admission + prefill
            eng.backend = backend
        return eng, eng.run()

    pre = compare(*run("kernel", short, 1), *run("reference", short, 1))
    dec = compare(*run("kernel", prompts, max_new, "reference"),
                  *run("reference", prompts, max_new))
    free = compare(*run("kernel", prompts, max_new),
                   *run("reference", prompts, max_new)) \
        if free_running else None
    failed = [name for name, r in (("prefill", pre), ("decode", dec))
              if name in hold and not (r["identical_tokens"] and
                                       r["max_diff_over_bar"] <= 1 and
                                       r["audit_equal"])]
    if "decode" in hold and dec["pool_bytes_differing"]:
        failed.append("decode pools")
    return {"prefill": pre, "decode": dec, "free_running": free,
            "failed": failed}


def f64_failures(chk: dict) -> list:
    """What of an ``f64_prefill_check`` is not held: non-finite f64
    logits, a backend whose greedy tokens differ from the f64 run's, a
    backend beyond the parity bar from the f64 run."""
    bad = [] if chk["finite"] else ["the f64 logits are not finite"]
    bad += [f"{b} backend's greedy tokens differ from the f64 run's"
            for b in ("kernel", "reference") if not chk[f"{b}_top1_equal"]]
    return bad + [f"{b} backend {chk[f'{b}_vs_f64']['over_bar']:.3f} x the "
                  f"bar from the f64 run" for b in ("kernel", "reference")
                  if b not in chk["within_bar"]]


def prefill_logits_f64(params, mc, dev, chunks):
    """The last token's logits of each of ``chunks``: the plain dense
    forward evaluated in f64 over what the engine's prefill computes for a
    prompt's last chunk.  A chunk is (tokens, start, state):

    * a big chunk from an empty pool is (tokens, 0, None): causal
      attention over its own keys and values, unrounded (the engine's
      are f32);
    * a g-chunk after ``start`` prompt tokens carries ``state``
      (``slot_state_f64``): per layer the valid rows of the pool it
      attended, dequantized, and its keys and values as the engine stored
      them (the TBQ buffer, bf16), or None to round its own f64 ones to
      bf16.  It attends the pool (one partition) merged with its own keys
      and values (the causal one), as K2, K3 and their merge do.

    One layer's weights are cast to f64 at a time; the hidden state, RoPE
    and attention (``kernels/ref.py``'s plain K3 and merge on f64 inputs)
    stay in f64.  Returns (f64 logits per chunk, and per chunk the number
    of stored bf16 values that differ from the f64 run's own rounding at
    the state it follows: 0 where nothing is stored).  Dense families
    only."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.layers import attention as A
    from repro_torch.layers.mlp import mlp
    f64, bf16 = torch.float64, torch.bfloat16
    if mc.moe is not None:
        raise ValueError("the f64 prefill covers the dense families")
    half = mc.head_dim // 2
    inv = mc.rope_theta ** (-torch.arange(half, dtype=f64, device=dev)
                            / half)

    def rope(x, start):
        ang = (start + torch.arange(x.shape[0], dtype=f64, device=dev)
               )[:, None] * inv
        cos, sin = ang.cos()[:, None], ang.sin()[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def norm(x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + mc.norm_eps) * w.to(f64)
    hs, flips = [], [0] * len(chunks)
    for tokens, _, _ in chunks:
        h = params.embedding[torch.as_tensor(tokens, device=dev)].to(f64)
        hs.append(h * mc.d_model ** 0.5 if mc.tie_embeddings else h)
    for i in range(mc.num_layers):
        lp = {g: {k: w.to(f64) for k, w in d.items()}
              for g, d in params.layer(i).items()}
        for j, (_, start, st) in enumerate(chunks):
            h = hs[j]
            q, k, v = A._project_qkv(lp["attn"], norm(h, lp["norm1"]["scale"]),
                                     mc)
            q, k = rope(q, start), rope(k, start)
            if st is not None:
                own = k.to(bf16), v.to(bf16)
                if st["buf"] is not None:
                    kb, vb = st["buf"][0][i], st["buf"][1][i]
                    flips[j] += int((kb != own[0]).sum() +
                                    (vb != own[1]).sum())
                    own = kb, vb
                k, v = own[0].to(f64), own[1].to(f64)
            o, m, l = ref.flash_prefill_stats_ref(q, k, v)
            if st is not None and len(st["pool"][i][0]):
                o = ref.merge_flash_ref(*ref.flash_prefill_stats_ref(
                    q, *st["pool"][i], causal=False), o, m, l)
            h = h + A.out_proj(lp["attn"], o)
            hs[j] = h + mlp(lp["mlp"], norm(h, lp["norm2"]["scale"]), mc.act,
                            mc.mlp_gated)
        del lp
    w = params.embedding if mc.tie_embeddings else params.lm_head.T
    out = []
    for h in hs:
        last = norm(h[-1], params.final_norm)
        out.append(torch.cat([w[r:r + 32768].to(f64) @ last
                              for r in range(0, w.shape[0], 32768)]))
    return out, flips


def slot_state_f64(eng, i: int, n: int) -> dict:
    """What the last g-chunk (``n`` tokens, fewer than g, so not yet
    committed) of the prompt prefilled into slot ``i`` attended: per layer
    the valid rows of the slot's pool view, dequantized (what K2 and the
    engine's dense path read) and cast to f64; and the chunk's keys and
    values as the engine stored them (``buf``: the TBQ buffer, bf16
    [L, n, H, D])."""
    import torch
    from repro_torch.core import ct_cache as CC
    from repro_torch.core import quantization as Q
    dims, pv = eng.dims, eng.pool.view
    pool = []
    for l in range(dims.L):
        table = eng.tables[i, l].clamp_min(0).long()
        bits = eng.caches.slot_bits[i, l].to(torch.int32).reshape(-1, 1, 1)
        valid = (eng.caches.slot_state[i, l] == CC.VALID).reshape(-1)

        def deq(codes, scales):
            c = codes[l][table].reshape(dims.NS, *codes.shape[3:])
            sc = scales[l][table].reshape(dims.NS, *scales.shape[3:])
            return Q.dequantize_by_bitcode(c, sc.float(), bits)[valid] \
                .double()
        pool.append((deq(pv.k_codes, pv.k_scales),
                     deq(pv.v_codes, pv.v_scales)))
    cache = eng.caches.slot(i)
    return {"pool": pool, "buf": (cache.buf_k[:, :n].clone(),
                                  cache.buf_v[:, :n].clone())}


def f64_prefill_check(engine_cls, cfg, params, prompts, dev) -> dict:
    """Each backend's prefill logits of ``prompts`` against the f64 run of
    the plain path (``prefill_logits_f64``) that follows that backend's
    prefill.  A prompt is one big chunk (K3, and K2 over an empty pool), or
    a g-chunk of fewer than g tokens after none or one big chunk (K2 over
    the slot's pool, empty or holding the big chunk's codes, K3 over the
    chunk's keys and values with n_valid, and the merge).  For a g-chunk
    the f64 run reads the pool codes and the bf16 keys and values the
    backend stored, so it holds the arithmetic after them; a second f64
    run rounds its own keys and values to bf16 instead (``own_rounding``,
    reported), and ``bf16_flips`` counts the stored values that differ
    from the f64 run's own rounding.  Per backend the largest
    |logit - f64| and its ratio to the parity bar (1e-3 + 1e-3 |f64|),
    whether its greedy tokens equal the f64 run's, and the two backends'
    distance from each other on the same scale.  ``within_bar`` lists the
    backends at or under the bar (``f64_failures`` says what is held)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    mc, got, chunks, idx = cfg.model, {}, [], {}
    if len(prompts) > cfg.max_seqs:
        raise ValueError(f"{len(prompts)} prompts for {cfg.max_seqs} slots")
    for backend in ("kernel", "reference"):
        eng = engine_cls(cfg, params=params, backend=backend, device=dev)
        BC, G = eng.prefill_chunk, eng.dims.G
        got[backend] = []
        for j, p in enumerate(prompts):
            tail = len(p) % BC
            if len(p) > 2 * BC - 1 or (len(p) != BC and not 0 < tail < G):
                raise ValueError(f"a prompt of {len(p)} tokens is neither "
                                 f"one big chunk ({BC}) nor a g-chunk "
                                 f"(< {G}) after at most one")
            got[backend].append(eng.prefill(p, j, arrival=j).logits)
            if tail:
                st = slot_state_f64(eng, j, tail)
                for how in ("follow", "own_rounding"):
                    idx[backend, how, j] = len(chunks)
                    chunks.append((p[len(p) - tail:], len(p) - tail,
                                   st if how == "follow" else
                                   {"pool": st["pool"], "buf": None}))
            elif backend == "kernel":
                idx["big", j] = len(chunks)
                chunks.append((p, 0, None))
        del eng
        gc.collect()                 # engines keep the weights in cycles
        torch.cuda.empty_cache()
    logits, nflip = prefill_logits_f64(params, mc, dev, chunks)
    logits = [x.cpu().numpy() for x in logits]

    def ref64(backend, how):
        return [logits[idx.get((backend, how, j), idx.get(("big", j)))]
                for j in range(len(prompts))]

    def dist(a, b):
        diff = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
        over = max(float((np.abs(x - y) / (ATOL + ATOL * np.abs(y))).max())
                   for x, y in zip(a, b))
        return {"max_abs": diff, "over_bar": over}
    out = {"prompt_lens": [len(p) for p in prompts],
           "layers": mc.num_layers,
           "bf16_values_stored": sum(2 * mc.num_layers * (len(p) % BC) *
                                     mc.num_kv_heads * mc.head_dim
                                     for p in prompts)}
    for b in got:
        f64 = ref64(b, "follow")
        out[f"{b}_vs_f64"] = dist(got[b], f64)
        out[f"{b}_top1_equal"] = all(int(x.argmax()) == int(y.argmax())
                                     for x, y in zip(got[b], f64))
        gch = [j for j in range(len(prompts)) if (b, "follow", j) in idx]
        out[f"{b}_vs_f64_own_rounding"] = dist(
            [got[b][j] for j in gch],
            [logits[idx[b, "own_rounding", j]] for j in gch]) if gch else None
        out[f"{b}_bf16_flips"] = sum(nflip[idx[b, "follow", j]] for j in gch)
    out.update(kernel_vs_reference=dist(got["kernel"], got["reference"]),
               f64_logit_absmax=max(float(np.abs(x).max()) for x in logits),
               finite=all(np.isfinite(x).all() for x in logits))
    out["within_bar"] = [b for b in got if out[f"{b}_vs_f64"]["over_bar"]
                         <= 1]
    out["seconds"] = time.perf_counter() - t0
    return out


# device kernel names of K1-K5 (this tree's and the parent designs')
KERNEL_GROUPS = {"K1": ("fused_attn_kernel",),
                 "K2": ("paged_split_kernel", "merge_splits_kernel",
                        "paged_attn_kernel<false"),
                 "K3": ("flash_prefill_kernel",),
                 "K4": ("group_quant_kernel",),
                 "K5": ("mamba_scan_kernel",)}


def profile_window(fn, top: int = 12) -> dict:
    """``fn()`` under torch.profiler: the window's wall time, the device
    time by kernel (and of each of K1-K5's kernels together),
    the device's busy share, and the host spans (``thinkv.*``
    record_function ranges)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
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
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    groups = {}
    for g, names in KERNEL_GROUPS.items():
        hits = [tc for n, tc in kernels.items() if any(x in n for x in names)]
        groups[g] = {"ms": sum(t for t, _ in hits),
                     "count": sum(c for _, c in hits)}
    return {"window_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "launches": sum(c for _, c in kernels.values()),
            "spans": spans, "kernel_groups": groups,
            "top_kernels": [{"name": n, "ms": t, "count": c}
                            for n, (t, c) in ranked]}


# the profiled prefill: 2 big chunks and 5 g-chunks (a serve prompt has 8
# and 5); the profiler's cost grows with the ops it records
PROFILED_PREFILL = 2 * 128 + 76


def profile_prefill(engine_cls, cfg, params, prompt, dev) -> dict:
    """One prompt's chunked prefill (big chunks and g-chunks, every
    layer) under torch.profiler: whether K2's and K3's device time reaches
    ``prefill_s``."""
    t0 = time.perf_counter()
    eng = engine_cls(cfg, params=params, backend="kernel", device=dev)
    eng.submit([prompt], max_new_tokens=1)
    rec = profile_window(lambda: eng.run(max_ticks=0))
    m = eng.metrics
    return {"phase": "prefill_profile", "prompt_len": len(prompt),
            "big_chunks": m["prefill_big_chunks"],
            "g_chunks": m["prefill_chunks"], "prefill_s": m["prefill_s"],
            **rec, "seconds": time.perf_counter() - t0}


def profile_decode(engine_cls, cfg, params, prompts, dev, ticks=12):
    """Decode ticks of the serve phase's traffic under torch.profiler (the
    prompts prefilled first, outside the window; the window holds one
    commit round of all 4 slots)."""
    t0 = time.perf_counter()
    eng = engine_cls(cfg, params=params, backend="kernel", device=dev)
    eng.submit(prompts, max_new_tokens=ticks + 1)
    eng.run(max_ticks=0)                       # admission + prefill
    rec = profile_window(lambda: eng.run(max_ticks=ticks))
    return {"phase": "profile", "ticks": eng.metrics["ticks"], **rec,
            "seconds": time.perf_counter() - t0}


def ssm_prefill(dev, rng):
    """falcon-mamba-7b at full width and depth (random f32 weights from the
    seed): a 4 x 1024-token prefill with launch counts zeroed just before
    and read just after (K5 once per layer and nothing else), then the same
    prefill under torch.profiler (the device's busy share, K5's share of
    it).  Returns (cfg, params, prompts, record)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import factory
    from repro_torch.serving import serve_step as SS
    cfg = get_config("falcon-mamba-7b")
    V = cfg.vocab_size
    model = factory.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill = SS.make_prefill_step(model, cfg)
    prompts = torch.from_numpy(rng.integers(0, V, (4, 1024))).to(dev)
    prefill(params, {"tokens": prompts[:, :16]})          # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    lg = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if lg.shape != (4, V) or not torch.isfinite(lg).all():
        raise AssertionError(f"bad prefill logits: shape {tuple(lg.shape)}")
    if launches["mamba_scan"] != cfg.num_layers or \
            sum(launches.values()) != cfg.num_layers:
        raise AssertionError(f"prefill launched {launches}: expected one "
                             f"mamba_scan per layer ({cfg.num_layers})")
    prof = profile_window(lambda: prefill(params, {"tokens": prompts}),
                          top=8)
    busy = prof["device_busy_ms"]
    rec = {"prompts": 4, "prompt_len": 1024, "layers": cfg.num_layers,
           "init_s": init_s, "params_gb": sum(
               p.numel() * p.element_size()
               for p in params.parameters()) / 1e9,
           "seconds": prefill_s, "tok_s": 4 * 1024 / prefill_s,
           "first_tokens": lg.argmax(-1).tolist(), "launches": launches,
           "busy_share": 1 - prof["idle_share"],
           "k5_ms": prof["kernel_groups"]["K5"]["ms"],
           "k5_share": prof["kernel_groups"]["K5"]["ms"] / busy,
           "profile": prof}
    return cfg, params, prompts, rec


def ssm_phase(dev, rng) -> dict:
    """falcon-mamba-7b at full width and depth through the serve steps."""
    import dataclasses as dc

    import torch
    from repro_torch.layers import embedding as E
    from repro_torch.models import ssm_lm
    from repro_torch.serving import serve_step as SS
    t_all = time.perf_counter()

    # 1. prefill: 4 prompts of 1024 tokens, K5 in every layer
    cfg, params, prompts, pre = ssm_prefill(dev, rng)
    V = cfg.vocab_size

    # 2. decode: step 128-token prompts into the state, then 64 greedy tokens
    step = SS.make_decode_step_fullkv(cfg)
    short = torch.from_numpy(rng.integers(0, V, (4, 128))).to(dev)
    st = ssm_lm.init_decode_state(cfg, 4, dev)
    conv, h = st.conv, st.h
    logits, seq = [], [short]
    t0 = time.perf_counter()
    for i in range(short.shape[1]):
        lgt, conv, h = step(params, {"tokens": short[:, i],
                                     "conv_state": conv, "ssm_state": h})
        logits.append(lgt)
    torch.cuda.synchronize()
    prompt_s = time.perf_counter() - t0
    new = 64
    t0 = time.perf_counter()
    for _ in range(new):
        tok = logits[-1].argmax(-1)
        seq.append(tok[:, None])
        lgt, conv, h = step(params, {"tokens": tok, "conv_state": conv,
                                     "ssm_state": h})
        logits.append(lgt)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    dec = torch.stack(logits, 1)                          # [4, 192, V]
    if not torch.isfinite(dec).all():
        raise AssertionError("decode logits are not finite")

    # where the time goes: 8 decode steps under the profiler
    def steps(n=8):
        c, hh, tk = conv, h, logits[-1].argmax(-1)
        for _ in range(n):
            lgt, c, hh = step(params, {"tokens": tk, "conv_state": c,
                                       "ssm_state": hh})
            tk = lgt.argmax(-1)
    prof_decode = profile_window(steps, top=8)

    # 3. the teacher-forced forward (K5 in every layer) at every position
    tf, _ = ssm_lm.logits_fn(params, {"tokens": torch.cat(seq, 1)}, cfg)
    tf_over = over_bar(dec, tf, SSM_TOL)
    tf_diff = float((dec - tf).abs().max())
    del dec, tf, logits

    # 4. K5 against the plain scan, 4 layers of the same weights, step 1's
    # prompts: last-token logits and greedy tokens
    cfg4 = dc.replace(cfg, num_layers=4)
    last = {}
    for backend in ("kernel", "reference"):
        hid = ssm_lm.hidden_fn(params, {"tokens": prompts}, cfg4,
                               backend=backend)
        last[backend] = E.unembed(params.embed_params, hid[:, -1], cfg4)
    torch.cuda.synchronize()
    p4_over = over_bar(last["kernel"], last["reference"], ATOL)
    p4_tokens = torch.equal(last["kernel"].argmax(-1),
                            last["reference"].argmax(-1))
    rec = {"phase": "ssm", "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "d_inner": 2 * cfg.d_model,
           "init_s": pre["init_s"], "params_gb": pre["params_gb"],
           "prefill": {k: pre[k] for k in (
               "prompts", "prompt_len", "seconds", "tok_s", "first_tokens",
               "launches", "busy_share", "k5_ms", "k5_share")},
           "decode": {"requests": 4, "prompt_len": short.shape[1],
                      "new_tokens": new, "prompt_s": prompt_s,
                      "decode_s": decode_s,
                      "decode_tok_s": 4 * new / decode_s,
                      "ms_per_step": 1e3 * decode_s / new},
           "teacher_forced": {"positions": short.shape[1] + new,
                              "max_abs_diff": tf_diff,
                              "max_diff_over_bar": tf_over},
           "profile_prefill": pre["profile"],
           "profile_decode_8_steps": prof_decode,
           "scan_parity_4_layers": {"max_abs_diff": float(
               (last["kernel"] - last["reference"]).abs().max()),
               "max_diff_over_bar": p4_over, "identical_tokens": p4_tokens},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t_all}
    emit(rec)
    failed = [n for n, ok in (("teacher-forced vs decode", tf_over <= 1),
                              ("4-layer scan parity", p4_over <= 1),
                              ("4-layer greedy tokens", p4_tokens)) if not ok]
    if failed:
        raise AssertionError(f"ssm phase failed: {failed}")
    return rec


def controller_phase(dev, mc, tk, n_tokens=2048) -> dict:
    """``step_token`` over a K/V stream at r1-llama-8b's cache width; at
    every tau boundary, every layer's attention through the wrapper held
    against ``decode_attention_ref``."""
    import numpy as np
    import torch
    from repro_torch.core import ct_cache as CC
    from repro_torch.core import thinkv as TV
    from repro_torch.kernels import ops
    t_all = time.perf_counter()
    L, H, D = mc.num_layers, mc.num_kv_heads, mc.head_dim
    dims = CC.make_dims(tk, L, H, D)
    cache = CC.init_cache(dims, dev)
    view = CC.init_pool_view(dims, dims.NB, dev)
    rng = np.random.default_rng(SEED)
    run = 4          # keys in runs around separated centres (no medoid ties)
    centres = rng.standard_normal((n_tokens // run, L, H, D),
                                  dtype=np.float32) * 3
    keys = torch.from_numpy(np.repeat(centres, run, axis=0) + rng.standard_normal(
        (n_tokens, L, H, D), dtype=np.float32) * 0.3).to(dev)
    values = torch.from_numpy(rng.standard_normal(
        (n_tokens, L, H, D), dtype=np.float32)).to(dev)
    # planted sparsity per tau window: R -> E -> T -> R
    sparsity = torch.tensor([0.65, 0.30, 0.92, 0.65], device=dev)
    tau = tk.refresh_interval
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ops.reset_launches()
    checks, worst, worst_over, step_s = 0, 0.0, 0.0, 0.0
    for i in range(n_tokens):
        t0 = time.perf_counter()
        TV.step_token(tk, dims, cache, view, keys[i], values[i],
                      sparsity[(i // tau) % 4])
        torch.cuda.synchronize()
        step_s += time.perf_counter() - t0
        if (i + 1) % tau:
            continue
        checks += 1
        q = torch.randn((mc.num_heads, D), generator=gen, device=dev)
        for layer in range(L):
            got = ops.thinkv_decode_attention(dims, cache, view, q, layer)
            want = TV.decode_attention_ref(dims, cache, view, q, layer)
            worst = max(worst, float((got - want).abs().max()))
            worst_over = max(worst_over, over_bar(got, want, SCAN_TOL))
    launches = ops.LAUNCHES["ct_paged_attention"]
    comp = TV.compression_ratio(tk, dims, cache, n_tokens)
    seg_types = cache.seg_type[:int(cache.cur_seg) + 1].tolist()
    rec = {"phase": "controller", "layers": L, "kv_heads": H, "head_dim": D,
           "tokens": n_tokens, "tau_checks": checks,
           "wrapper_launches": launches, "max_abs_err": worst,
           "max_err_over_bar": worst_over,
           "step_token_s": step_s, "step_token_ms": 1e3 * step_s / n_tokens,
           "footprint_frac": comp["footprint_frac"],
           "avg_bits": float(comp["avg_bits"]),
           "valid_tokens_per_layer": sorted(set(
               comp["valid_tokens"].tolist())),
           "segment_types": seg_types,
           "seconds": time.perf_counter() - t_all}
    emit(rec)
    if launches != checks * L or worst_over > 1:
        raise AssertionError(f"controller phase failed: {launches} wrapper "
                             f"launches for {checks * L} reads, error "
                             f"{worst_over} x the bar")
    return rec


EXAMPLE_SERVE_ARGS = (("batch", []), ("stream", ["--stream"]),
                      ("samples2", ["--samples", "2"]),
                      ("tpd4", ["--ticks-per-dispatch", "4"]))


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(main, argv, on_card: bool, **kw):
    """``main(argv, **kw)`` with its printed lines captured; on the card the
    launch counts are zeroed just before and read just after.  Returns
    (result, launches, seconds, lines)."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels import ops
    buf = io.StringIO()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = main(argv, **kw)
    if on_card:
        torch.cuda.synchronize()
    return res, dict(ops.LAUNCHES), time.perf_counter() - t0, \
        buf.getvalue().splitlines()


def examples_phase() -> dict:
    """The port's three examples (``examples/*_torch.py``) at their default
    sizes on the card, each held to its own CPU run (the plain versions):
    the quickstart's integers, codes and scales equal and its floats within
    1e-5, its commits on K4 and its decode read on K2 (the single-request
    wrapper, once); the calibration's L*, thresholds, labels and accuracy
    equal; ``serve_reasoning_torch.py`` on the batch path, ``--stream``,
    ``--samples 2`` and ``--ticks-per-dispatch 4``, the kernel backend's
    tokens those of the CPU's reference backend (the same weights on both,
    made on the CPU from the config's seed), K1 once per tick, K2 and K3
    once per prefill chunk and layer, K4 once per commit."""
    import copy
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import init_params
    t_phase = time.perf_counter()
    failed, rec = [], {"phase": "examples"}
    qs = load_example("quickstart_torch")
    want = run_example(qs.main, ["--device", "cpu"], False)[0]
    got, launches, sec, lines = run_example(qs.main, [], True)
    bad = [k for k in ("retained", "seg_types", "shared", "cow_ok")
           if got[k] != want[k]]
    bad += [k for k in ("codes", "scales", "refcount")
            if not torch.equal(got[k].cpu(), want[k])]
    bad += [k for k in ("rel_rmse", "avg_bits", "footprint_frac")
            if not abs(got[k] - want[k]) <= 1e-5]
    out_err = max_err(got["out"].cpu(), want["out"])
    if out_err > 1e-5:
        bad.append(f"decode attention out {out_err}")
    if bad:
        failed.append(f"quickstart differs from its CPU run: {bad}")
    others = {k: n for k, n in launches.items()
              if k not in ("ct_paged_attention", "group_quant") and n}
    if launches["ct_paged_attention"] != 1 or not launches["group_quant"] \
            or others:
        failed.append(f"quickstart launches {launches}: K2 once through "
                      f"the wrapper and K4 at every commit expected")
    rec["quickstart"] = {"seconds": sec, "launches": launches,
                         "out_vs_cpu": out_err, "lines": lines}
    cal = load_example("calibrate_thoughts_torch")
    want = run_example(cal.main, ["--device", "cpu"], False)[0]
    got, launches, sec, lines = run_example(cal.main, [], True)
    if got["result"] != want["result"] or \
            not (got["pred"] == want["pred"]).all() or \
            got["accuracy"] != want["accuracy"]:
        failed.append("calibration differs from its CPU run")
    rec["calibrate"] = {"seconds": sec, "accuracy": got["accuracy"],
                        "lines": lines}
    sr = load_example("serve_reasoning_torch")
    mc = get_smoke_config("r1-llama-8b")
    params = init_params(mc, ServeConfig(model=mc).seed, "cpu")
    params_card = copy.deepcopy(params).to("cuda")
    rec["serve_reasoning"] = {}
    for name, argv in EXAMPLE_SERVE_ARGS:
        (want, _), _, cpu_s, _ = run_example(
            sr.main, ["--device", "cpu"] + argv, False, params=params)
        (done, eng), launches, sec, lines = run_example(
            sr.main, argv, True, params=params_card)
        m, L = eng.metrics, eng.cfg.model.num_layers
        chunks = (m["prefill_chunks"] + m["prefill_big_chunks"]) * L
        expect = {"ct_paged_attention_fused": m["ticks"],
                  "ct_paged_attention_batched": chunks,
                  "flash_prefill": chunks, "group_quant": m["commits"]}
        if eng.backend != "kernel" or any(
                launches[k] != n or not n for k, n in expect.items()):
            failed.append(f"serve_reasoning {name}: launches {launches} on "
                          f"the {eng.backend} backend, {expect} expected")
        tokens = {r.uid: list(r.output) for r in done}
        if tokens != {r.uid: list(r.output) for r in want}:
            failed.append(f"serve_reasoning {name}: tokens differ from the "
                          f"CPU run's")
        rec["serve_reasoning"][name] = {
            "seconds": sec, "cpu_seconds": cpu_s, "launches": launches,
            "ticks": m["ticks"], "dispatches": m["dispatches"],
            "commits": m["commits"], "requests": len(done),
            "tokens": m["tokens"],
            "report": next(ln for ln in lines if "tok/s" in ln)}
    rec["launches"] = {
        "quickstart": rec["quickstart"]["launches"],
        **{f"serve_reasoning {n}": r["launches"]
           for n, r in rec["serve_reasoning"].items()}}
    rec["seconds"] = time.perf_counter() - t_phase
    rec["failed"] = failed
    emit(rec)
    if failed:
        raise AssertionError(f"examples phase failed: {failed}")
    return rec


def check_trace_kernels(dev, cfg) -> dict:
    """K1-K4 at the flash trace's shapes (``cfg``: head_dim 16, BS 8, the
    128-token big chunk and the g-chunk, the commit [L, G, H, D]) against
    their plain versions on the same card tensors: <= 1e-3 abs for
    attention, bit-exact for the quantizer, each timed against its bound
    (``k1_record`` ... ``k4_commit_record``: records keyed K1, K2, K2_g,
    K3, K3_g, K4).  K2 runs its split walk (NS > 1), so the merge is held
    too; K1 and K2 also run at an odd kv head count, where the half of a
    row's scale word alternates from row to row.  Returns (max errors by
    case, records); raises on a mismatch."""
    import torch
    from repro_torch.core.ct_cache import make_dims
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mc, tk = cfg.model, cfg.thinkv
    dims = make_dims(tk, mc.num_layers, mc.num_kv_heads, mc.head_dim)
    L, H, D, BS, NB, G = dims.L, dims.H, dims.D, dims.BS, dims.NB, dims.G
    gq, R, C = mc.num_heads // H, cfg.max_seqs, 128
    sms = ops._sm_count(dev.index or 0)
    label = "trace: "
    recs = {}
    # K1: a tick at the trace's shape, timed; GQ 8 over 3 kv heads is two
    # 4-row tiles per (layer, slot, kv head) and an odd row-to-row parity
    recs["K1"], c = k1_record(gen, dev, L, R, H, gq, D, BS, NB, G, label)
    errs = {f"K1 H={H} GQ={gq}": recs["K1"]["max_abs_err"]}
    c3 = pool_case(gen, dev, L, R, 3, D, BS, NB, R * NB, G, 8)
    args = tuple(c3.values())
    errs["K1 H=3 GQ=8"] = max_err(ops.paged_decode_attention_fused(*args),
                                  ref.ct_paged_attention_fused_ref(*args))
    # K2: the big chunk's and the g-chunk's queries folded into GQ (timed,
    # over layer 0 of slot 0 of K1's pool), and 64 rows over 3 kv heads
    for key, h, g in (("K2", H, C * gq), ("K2_g", H, G * gq),
                      (None, 3, 64)):
        ns = ops.kv_splits(1, h, g, NB, sms, D)
        if ns < 2:
            raise AssertionError(f"K2 at H={h} GQ={g} NB={NB}: {ns} share, "
                                 f"the merge is not run")
        if key:
            recs[key] = k2_record(gen, dev, c, g, label)
            errs[f"K2 H={h} GQ={g} NS={ns}"] = recs[key]["max_abs_err"]
            continue
        c3 = pool_case(gen, dev, 1, 1, h, D, BS, NB, NB, G, g)
        args = (c3["qh"][0], c3["k_codes"][0], c3["v_codes"][0],
                c3["k_scales"][0], c3["v_scales"][0], c3["slot_state"][0],
                c3["slot_bits"][0], c3["block_table"][:, 0].contiguous())
        errs[f"K2 H={h} GQ={g} NS={ns}"] = max_err(
            ops.paged_decode_attention_batched(*args),
            ref.ct_paged_attention_batched_ref(*args))
    # K3: the big chunk, and a g-chunk with a ragged tail
    for key, S, n_valid in (("K3", C, None), ("K3_g", G, 5)):
        recs[key] = k3_record(gen, dev, S, n_valid, mc.num_heads, H, D,
                              label)
        errs[f"K3 S={S} n_valid={n_valid}"] = recs[key]["max_abs_err"]
    torch.cuda.synchronize()
    bad = {n: e for n, e in errs.items() if not e <= ATOL}
    # K4: a commit of the trace, bit-exact at each thought's width
    recs["K4"], _ = k4_commit_record(gen, dev, L, G, H, D, tk, label)
    errs["K4 commit"] = 0.0
    emit({"phase": "trace_kernels", "head_dim": D, "block_size": BS,
          "blocks": NB, "max_abs_err": errs})
    if bad:
        raise AssertionError(f"a kernel at the trace's shapes disagrees "
                             f"with its plain version: {bad} > {ATOL}")
    return errs, recs


TRACE_RECORDS = ("flash", "pressure", "sampled", "rkv", "uniform", "moe",
                 "qwen2", "vlm")


def trace_phase(dev) -> dict:
    """The flash, the pressure and the sampled trace at their config
    (r1-llama-8b's smoke form with 8 q and 8 kv heads at head_dim 16) with
    the JAX engine's parameters, on the kernel and then the reference
    backend, each held to the JAX reference engine's record
    (``tests/golden/torch_<trace>_trace.npz``): identical tokens, logits
    within 1e-3, equal counters and pool audit.  The flash trace runs a
    128-token big chunk, g-chunks, eviction and refresh on an unpressured
    pool; the pressure trace a 14-block pool for 3 slots with the prefix
    cache (preemption, resume, prefix hits, COW faults; block tables alias
    shared blocks); the sampled trace the pressure trace at temperature
    0.7, top-p 0.9 in packs of up to 8 ticks (its counters include the
    dispatches and early pack exits; the record's smallest draw margin
    must lie above 1e-3 / T, so no draw can flip under the card's logit
    error); the rkv and uniform traces are the pressure trace under those
    retention policies with the drift probe on (each request's drift is
    held to the record's too); the moe, qwen2 and vlm traces are the
    pressure trace on mixtral-8x7b's, qwen2-7b's and paligemma-3b's smoke
    configs.  The kernel
    backend launches K1 once per tick and K2 and K3; both launch K4 once per
    commit the run made (the engine's ``commits``, which for the flash
    trace must also equal its length arithmetic: prefix hits skip
    commits).  First K1-K4 are held against their plain versions at the
    traces' shapes (``check_trace_kernels``).  Launch counts are zeroed
    just before each run."""
    from repro_torch.kernels import ops
    from repro_torch.serving import trace_record as TR
    t0 = time.perf_counter()
    recs = {name: TR.load(os.path.join(HERE, "tests", "golden",
                                       f"torch_{name}_trace.npz"))
            for name in TRACE_RECORDS}
    kernel_errs, kernel_recs = check_trace_kernels(
        dev, TR.serve_config(recs["flash"]))
    out, failed = {"phase": "trace", "kernels_max_abs_err": kernel_errs}, []
    kernel_launches = dict.fromkeys(K1_K4, 0)
    for name, rec in recs.items():
        runs, params = {}, None
        for backend in ("kernel", "reference"):
            ops.reset_launches()
            eng, done, _ = TR.replay(rec, backend, dev, params)
            launches = dict(ops.LAUNCHES)
            params = eng.model
            bad, worst = TR.mismatches(rec, eng, done)
            m = eng.metrics
            margin = rec["min_margin"]
            if margin is not None and \
                    margin < 1e-3 / rec["settings"]["temperature"]:
                bad.append(f"the record's min_margin {margin} is below "
                           f"1e-3 / T: a draw may flip")
            k1 = launches["ct_paged_attention_fused"]
            if backend == "reference" and k1:
                bad.append(f"K1 launched {k1} times")
            if backend == "kernel" and k1 != m["ticks"]:
                bad.append(f"K1 launched {k1} times over {m['ticks']} ticks")
            if backend == "kernel" and not all(launches[k] > 0
                                               for k in K1_K4):
                bad.append(f"a kernel never launched: {launches}")
            if launches["group_quant"] != m["commits"]:
                bad.append(f"K4 launched {launches['group_quant']} times "
                           f"for {m['commits']} commits")
            if name == "flash" and m["commits"] != TR.expected_commits(rec):
                bad.append(f"{m['commits']} commits, "
                           f"{TR.expected_commits(rec)} expected")
            if backend == "kernel":
                for k in K1_K4:
                    kernel_launches[k] += launches[k]
            runs[backend] = {
                "tokens": {r.arrival: r.output for r in done},
                "drift": {r.arrival: r.stats["drift"] for r in done
                          if "drift" in r.stats},
                "max_abs_logit_diff": worst,
                "counters": {k: m[k] for k in rec["counters"]},
                "commits": m["commits"], "launches": launches,
                "mismatches": bad}
            failed += [f"{name} {backend}: {b}" for b in bad]
        mc = TR.serve_config(rec).model
        out[name] = {"head_dim": mc.head_dim, "heads": mc.num_heads,
                     "kv_heads": mc.num_kv_heads, "layers": mc.num_layers,
                     "pool_blocks": rec["settings"].get("pool_blocks"),
                     "prefix_cache": rec["settings"].get("prefix_cache",
                                                         False),
                     **{k: rec["settings"][k] for k in (
                         "temperature", "top_p", "ticks_per_dispatch",
                         "policy", "drift_probe")
                        if k in rec["settings"]},
                     "record_drift": rec["drift"],
                     "min_margin": rec["min_margin"],
                     "record_tokens": rec["tokens"],
                     "record_counters": rec["counters"], **runs}
    out["launches_kernel_backend"] = kernel_launches
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if failed:
        raise AssertionError(f"a trace differs from the JAX record: "
                             f"{failed}")
    out["records"] = kernel_recs
    return out


def commit_profile(dev, mc, tk) -> dict:
    """One group commit (``commit_group``) at r1-llama-8b's cache width (32
    layers, 8 kv heads, head_dim 128, default ThinKVConfig) under
    torch.profiler, after a warm-up commit: the device kernels and copies
    it runs (K4 among them) and their device time."""
    import torch
    from repro_torch.core import ct_cache as CC
    from repro_torch.kernels import ops
    dims = CC.make_dims(tk, mc.num_layers, mc.num_kv_heads, mc.head_dim)
    cache = CC.init_cache(dims, dev)
    view = CC.init_pool_view(dims, dims.NB, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def fill():
        cache.buf_k.normal_(generator=gen)
        cache.buf_v.normal_(generator=gen)
        cache.buf_len.fill_(dims.G)
        cache.num_tokens.add_(dims.G)
    fill()
    CC.commit_group(tk, dims, cache, view)
    fill()
    torch.cuda.synchronize()
    ops.reset_launches()
    rec = profile_window(lambda: CC.commit_group(tk, dims, cache, view),
                         top=40)
    out = {"phase": "commit_profile", "L": dims.L, "G": dims.G, "H": dims.H,
           "D": dims.D, "group_quant_launches": ops.LAUNCHES["group_quant"],
           "device_ops": rec["launches"], "device_busy_ms":
           rec["device_busy_ms"], "window_ms": rec["window_ms"],
           "ops": [(k["name"], k["count"], k["ms"])
                   for k in rec["top_kernels"]]}
    emit(out)
    return out


def serve_phase(engine_cls, cfg, params, prompts, max_new, init_s, dev,
                phase="serve"):
    """The main path: the engine serves ``prompts`` with launch counts zeroed
    just before and read just after; K1-K4 must have run (K1 once per tick,
    K2 and K3 once per prefill chunk and layer, split by shape, K4 once per
    group commit: every G tokens a request writes)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    mc = cfg.model
    ops.reset_launches()
    eng, done = serve(engine_cls, cfg, params, prompts, max_new, "kernel",
                      dev)
    launches = dict(ops.LAUNCHES)
    audit = eng.audit_pool()
    m = eng.metrics
    if len(done) != len(prompts) or any(len(r.output) != max_new
                                        for r in done):
        raise AssertionError("not every request finished with its tokens")
    for arr in eng.request_logits.values():
        lg = np.stack(arr)
        if lg.shape != (max_new, mc.vocab_size) or not np.isfinite(lg).all():
            raise AssertionError(f"bad logits: shape {lg.shape}")
    for k in K1_K4:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the main "
                                 f"path")
    if launches["ct_paged_attention_fused"] != m["ticks"]:
        raise AssertionError(f"K1 launched {launches['ct_paged_attention_fused']}"
                             f" times over {m['ticks']} ticks")
    # a big chunk folds prefill_chunk queries into K2's GQ, a g-chunk G
    gq = mc.num_heads // mc.num_kv_heads
    big, small = eng.prefill_chunk, eng.dims.G
    nb, ng = m["prefill_big_chunks"] * mc.num_layers, \
        m["prefill_chunks"] * mc.num_layers
    by_shape = {"ct_paged_attention_batched": {f"GQ={big * gq}": nb,
                                               f"GQ={small * gq}": ng},
                "flash_prefill": {f"S={big}": nb, f"S={small}": ng}}
    for k, shapes in by_shape.items():
        if sum(shapes.values()) != launches[k]:
            raise AssertionError(f"{k}: {launches[k]} launches, but the "
                                 f"chunks account for {shapes}")
    commits = sum((len(p) + max_new - 1) // small for p in prompts)
    # a tree from before the one-launch commit (an A/B parent) ran K4 on K
    # and V at every precision level
    per_commit = 1 if hasattr(ops, "tbq_commit_quant") else \
        2 * len(set(cfg.thinkv.precision))
    if launches["group_quant"] != commits * per_commit:
        raise AssertionError(f"group_quant: {launches['group_quant']} "
                             f"launches for {commits} commits")
    rec = {"phase": phase, "layers": mc.num_layers, "requests": len(done),
           "prompt_len": len(prompts[0]), "max_new": max_new,
           "init_s": init_s, "wall_s": m["wall_s"],
           "prefill_s": m["prefill_s"], "decode_s": m["decode_s"],
           "ticks": m["ticks"], "tokens": m["tokens"],
           "decode_tok_s": m["tokens"] / m["decode_s"],
           "ms_per_tick": 1e3 * m["decode_s"] / m["ticks"],
           "prefill_chunks": m["prefill_chunks"],
           "prefill_big_chunks": m["prefill_big_chunks"],
           "footprint_frac": float(np.mean(
               [r.stats["footprint_frac"] for r in done])),
           "avg_bits": float(np.mean([r.stats["avg_bits"] for r in done])),
           "commits": commits, "launches": launches,
           "launches_by_shape": by_shape,
           "audit_claimed": audit["claimed"][:4],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    rec["outputs"] = {r.arrival: r.output for r in done}
    rec["run"] = run_record(eng, done)
    return rec


def run_record(eng, done) -> dict:
    """What the tp phase holds a run to: every request's tokens and
    recorded logits, the engine counters and the pool audit."""
    import numpy as np
    return {"outputs": {r.arrival: r.output for r in done},
            "logits": {a: np.stack(v) for a, v in eng.request_logits.items()},
            "counters": {k: v for k, v in eng.metrics.items()
                         if not k.endswith("_s")},
            "audit": eng.audit_pool()}


PRESSURE_FRAC = 0.5      # of the worst case, 4 slots x NB blocks
PRESSURE_BUDGET = 512
PRESSURE_ATOL = 1e-4     # K1 and K2 on the pressure phase's aliased pool


def pressure_traffic(vocab: int, rng):
    """8 requests of 384-768 prompt tokens; requests 0, 2, 4 and 6 share a
    256-token prefix; priorities alternate 0/1."""
    import numpy as np
    lens = rng.integers(384, 769, 8)
    shared = rng.integers(0, vocab, 256)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n - 256)])
               if i % 2 == 0 else rng.integers(0, vocab, n)
               for i, n in enumerate(lens)]
    return [p.astype(np.int64) for p in prompts], [i % 2 for i in range(8)]


def aliased_tables(gen, dev, L, NB, NP):
    """Block tables [4, L, NB] over a pool of NP >= 2 NB blocks in which
    slots share physical blocks by construction, as prefix hits and COW
    sources do: per layer, slots 1 and 2 map slot 0's first NB/4 blocks at
    the same positions (a three-way prefix), slot 3 maps slot 0's second
    half at its own first half; every other entry is a block of its own or
    -1."""
    import torch
    assert NP >= 2 * NB, (NP, NB)
    q, h = NB // 4, NB // 2
    none = torch.full((h,), -1, dtype=torch.long, device=dev)
    rows = []
    for _ in range(L):
        perm = torch.randperm(NP, generator=gen, device=dev)
        rows.append(torch.stack([
            perm[:NB],
            torch.cat([perm[:q], perm[NB:2 * NB - q]]),
            torch.cat([perm[:q], perm[2 * NB - q:2 * NB], none]),
            torch.cat([perm[h:NB], none])]))
    return torch.stack(rows, 1).to(torch.int32)


def check_pressure_kernels(dev, mc, dims, pool_blocks) -> dict:
    """K1 and K2 at the pressure phase's shapes against their plain
    versions on the same card tensors: NB 64, a pool of ``pool_blocks``
    (fewer than 4 x NB) and tables that alias blocks across slots
    (``aliased_tables``), each slot with its own metadata.  K1 over the
    tick; K2 on slot 1 (a quarter of its table shared) at GQ 4, 64 and 512,
    each asserted to split its walk (NS > 1) so the merge runs.  Outputs
    and running maxima are held at PRESSURE_ATOL; K2's l at ATOL, since
    the f32 plain version's own rounding of l over ~1000 keys nears 1e-4
    (``tests/test_torch_cuda.py::batched_f64``).  Raises on a miss."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    L, H, D, BS, NB, G = dims.L, dims.H, dims.D, dims.BS, dims.NB, dims.G
    gq, R = mc.num_heads // H, 4
    c = pool_case(gen, dev, L, R, H, D, BS, NB, pool_blocks, G, gq)
    c["block_table"] = aliased_tables(gen, dev, L, NB, pool_blocks)
    c["slot_state"].masked_fill_(
        (c["block_table"] < 0).permute(1, 0, 2)[..., None], 0)
    args = tuple(c.values())
    errs = {"K1": max_err(ops.paged_decode_attention_fused(*args),
                          ref.ct_paged_attention_fused_ref(*args))}
    bars = {"K1": PRESSURE_ATOL}
    sms = ops._sm_count(dev.index or 0)
    for GQ in (gq, 16 * gq, 128 * gq):
        qh = torch.randn((1, H, GQ, D), generator=gen, device=dev)
        args = (qh, c["k_codes"][0], c["v_codes"][0], c["k_scales"][0],
                c["v_scales"][0], c["slot_state"][0, 1:2].contiguous(),
                c["slot_bits"][0, 1:2].contiguous(),
                c["block_table"][1:2, 0].contiguous())
        ns = ops.kv_splits(1, H, GQ, NB, sms, D)
        if ns < 2:
            raise AssertionError(f"K2 at GQ={GQ} NB={NB}: {ns} share, the "
                                 f"merge is not run")
        got = ops.paged_decode_attention_batched(*args)
        want = ref.ct_paged_attention_batched_ref(*args)
        name = f"K2 GQ={GQ} NS={ns}"
        errs[name] = max_err(got[:2], want[:2])
        errs[name + " l"] = max_err(got[2], want[2])
        bars.update({name: PRESSURE_ATOL, name + " l": ATOL})
    torch.cuda.synchronize()
    bad = {n: e for n, e in errs.items() if not e <= bars[n]}
    if bad:
        raise AssertionError(f"K1/K2 on the aliased pool of {pool_blocks} "
                             f"blocks disagree with their plain versions: "
                             f"{bad}")
    return errs


def watch_pool(eng, storm: int):
    """Wrap ``eng._preempt`` and ``eng._resume``: audit the pool after each,
    hold every successful resume bit-exact against its spill (metadata and
    buffers, and the planes gathered through the new table over every
    mapped block), and raise past ``storm`` preemptions (a spill storm:
    victims resumed and preempted again at every commit).  Returns the
    log of resumes checked."""
    import torch
    from repro_torch.core import ct_cache as CC
    preempt, resume = eng._preempt, eng._resume
    log = {"resumes_checked": 0, "audits": 0}

    def as_bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    def wrapped_preempt(slot):
        if eng.metrics["preemptions"] >= storm:
            raise AssertionError(f"spill storm: more than {storm} "
                                 f"preemptions")
        preempt(slot)
        eng.audit_pool()
        log["audits"] += 1

    def wrapped_resume(slot, st):
        ok = resume(slot, st)
        eng.audit_pool()
        log["audits"] += 1
        if not ok:
            return ok
        i, dev = slot.idx, eng.device
        bad = [f for f in CC.CTCache.FIELDS
               if not torch.equal(as_bits(getattr(eng.caches, f)[i]),
                                  as_bits(getattr(st.cache, f).to(dev)))]
        table = eng.tables[i]
        mapped = table >= 0
        want = st.mapped if st.shared_table is None else \
            st.mapped | (st.shared_table >= 0)
        want = torch.as_tensor(want, device=dev)
        if not torch.equal(mapped, want):
            bad.append("mapped blocks")
        view = CC.gather_view(eng.pool.view, table)
        bad += [name for name, got, sp in zip(CC.PoolView._fields, view,
                                              st.view)
                if not torch.equal(as_bits(got[mapped]),
                                   as_bits(sp.to(dev)[mapped]))]
        if bad:
            raise AssertionError(f"resume of slot {i} is not bit-exact: "
                                 f"{bad}")
        log["resumes_checked"] += 1
        return ok
    eng._preempt, eng._resume = wrapped_preempt, wrapped_resume
    return log


def clock_headroom(eng):
    """Wrap the engine's two headroom steps in host clocks: the decode
    tick's clock (``decode_s``) starts after ``_ensure_decode_headroom``,
    the prefill's (``prefill_s``) takes in ``_ensure_prefill_headroom``.
    With the drift probe on, ``measure_drift`` is clocked too
    (``drift_s``).  Returns the seconds spent in each, summed over the
    run."""
    clocks = {"decode_headroom_s": 0.0, "prefill_headroom_s": 0.0}

    def clocked(fn, key):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                clocks[key] += time.perf_counter() - t0
        return run
    eng._ensure_decode_headroom = clocked(eng._ensure_decode_headroom,
                                          "decode_headroom_s")
    eng._ensure_prefill_headroom = clocked(eng._ensure_prefill_headroom,
                                           "prefill_headroom_s")
    if eng.drift_probe:
        clocks["drift_s"] = 0.0
        eng.measure_drift = clocked(eng.measure_drift, "drift_s")
    return clocks


def pressure_serve(engine_cls, cfg, params, prompts, priorities, max_new,
                   dev, backend, pool_blocks, prefix_cache, watch=True,
                   **engine_kw):
    """Serve the pressure traffic (``engine_kw``: e.g. the policy and the
    drift probe); returns (engine, finished, launches, the watch log or,
    unwatched, the clocks of ``clock_headroom``, seconds)."""
    import torch
    from repro_torch.kernels import ops
    eng = engine_cls(cfg, params=params, backend=backend, device=dev,
                     record_logits=True, pool_blocks=pool_blocks,
                     prefix_cache=prefix_cache, **engine_kw)
    log = watch_pool(eng, 8 * len(prompts)) if watch else clock_headroom(eng)
    eng.submit(prompts, max_new_tokens=max_new, priorities=priorities)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    seconds = time.perf_counter() - t0
    return eng, done, dict(ops.LAUNCHES), log, seconds


def cow_compare_ms(eng) -> float:
    """Device time of what ``track_cow`` adds to a commit at this engine's
    width: a copy of the slot's gathered view and ``changed_slots`` over
    it (slot 0's table, all NB blocks gathered as the commit does)."""
    from repro_torch.core import ct_cache as CC
    view = CC.gather_view(eng.pool.view, eng.tables[0])

    def once():
        view0 = CC.PoolView(*(p.clone() for p in view))
        return CC.changed_slots(view0, view)
    return device_ms(once, iters=5, reps=3)


def pressure_phase(engine_cls, params, mc, dev, max_new=64) -> dict:
    """The oversubscribed pool at r1-llama-8b's width: 4 slots, the kernel
    backend, ThinKVConfig defaults but a 512-token budget (so requests of
    384-768 + 64 tokens are evicted and a commit can write into a shared
    block: with the default 1024 nothing is ever evicted, and no shared
    block is written), the prefix cache on, 8 requests
    (``pressure_traffic``, numpy seed 0), 64 new tokens each, a pool of
    PRESSURE_FRAC x 4 x NB blocks.  First K1 and K2 are held against their
    plain versions on an aliased pool of that size
    (``check_pressure_kernels``).  Held in the served run: every request's
    64 tokens, finite logits, preemptions, resumes, prefix hits and COW
    faults all > 0 and no spill storm, the audit after the run and after
    every preemption and resume, every resume bit-exact, no commit claim
    failed (the engine raises), K1 once per tick and K4 once per commit.
    The times come from the same run served again without those checks,
    its headroom steps clocked apart.  Reported only: the tokens and logits
    against the same requests on an unpressured pool without the prefix
    cache, and against the reference backend on the same pool."""
    import numpy as np
    import torch
    from repro_torch.config import ServeConfig, ThinKVConfig
    from repro_torch.core import ct_cache as CC
    t_phase = time.perf_counter()
    tk = ThinKVConfig(token_budget=PRESSURE_BUDGET)
    cfg = ServeConfig(model=mc, thinkv=tk, max_seqs=4)
    prompts, priorities = pressure_traffic(
        mc.vocab_size, np.random.default_rng(SEED))
    dims = CC.make_dims(tk, mc.num_layers, mc.num_kv_heads, mc.head_dim)
    counters = ("preemptions", "resumes", "prefix_hits", "cow_faults")
    pool_blocks = int(4 * dims.NB * PRESSURE_FRAC)
    kernel_errs = check_pressure_kernels(dev, mc, dims, pool_blocks)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng, done, launches, log, watched_s = pressure_serve(
        engine_cls, cfg, params, prompts, priorities, max_new, dev, "kernel",
        pool_blocks, True)
    m = eng.metrics
    failed = []
    zero = [k for k in counters if m[k] == 0]
    if zero:
        failed.append(f"counters at 0: {zero}")
    if len(done) != len(prompts) or any(len(r.output) != max_new
                                        for r in done):
        failed.append("not every request finished with its tokens")
    for arr in eng.request_logits.values():
        lg = np.stack(arr)
        if lg.shape != (max_new, mc.vocab_size) or not np.isfinite(lg).all():
            failed.append(f"bad logits: shape {lg.shape}")
            break
    audit = eng.audit_pool()
    if launches["ct_paged_attention_fused"] != m["ticks"]:
        failed.append(f"K1 launched {launches['ct_paged_attention_fused']} "
                      f"times over {m['ticks']} ticks")
    if launches["group_quant"] != m["commits"]:
        failed.append(f"K4 launched {launches['group_quant']} times for "
                      f"{m['commits']} commits")
    if not all(launches[k] > 0 for k in K1_K4):
        failed.append(f"a kernel never launched: {launches}")
    if log["resumes_checked"] != m["resumes"]:
        failed.append(f"{log['resumes_checked']} of {m['resumes']} resumes "
                      f"checked")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 \
        if dev.type == "cuda" else None
    cow_ms = cow_compare_ms(eng) if dev.type == "cuda" else None

    def against(other):
        eo, do_ = other[0], other[1]
        mine = {r.arrival: r.output for r in done}
        theirs = {r.arrival: r.output for r in do_}
        worst = max(float(np.abs(np.stack(eng.request_logits[a]) -
                                 np.stack(eo.request_logits[a])).max())
                    for a in eng.request_logits)
        return {"identical_tokens": mine == theirs,
                "requests_identical": sum(mine[a] == theirs.get(a)
                                          for a in mine),
                "max_abs_logit_diff": worst,
                "counters": {k: eo.metrics[k] for k in counters + (
                    "ticks", "prefill_chunks", "prefill_big_chunks")}}
    # the timed twin: the same run without the audits and resume checks
    timed = pressure_serve(engine_cls, cfg, params, prompts, priorities,
                           max_new, dev, "kernel", pool_blocks, True,
                           watch=False)
    tm, clocks = timed[0].metrics, timed[3]
    twin = against(timed)
    unpressured = against(pressure_serve(
        engine_cls, cfg, params, prompts, priorities, max_new, dev, "kernel",
        None, False, watch=False))
    ref_run = pressure_serve(engine_cls, cfg, params, prompts, priorities,
                             max_new, dev, "reference", pool_blocks, True)
    reference = against(ref_run)
    rec = {"phase": "pressure", "layers": mc.num_layers,
           "d_model": mc.d_model, "heads": mc.num_heads,
           "kv_heads": mc.num_kv_heads, "head_dim": mc.head_dim,
           "budget": tk.token_budget, "NB": dims.NB, "slots": 4,
           "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
           "max_new": max_new, "frac": PRESSURE_FRAC,
           "pool_blocks": pool_blocks, "worst_case_blocks": 4 * dims.NB,
           "kernel_max_abs_err": kernel_errs,
           **{k: m[k] for k in counters + (
               "prefix_tokens_skipped", "ticks", "tokens", "commits",
               "prefill_chunks", "prefill_big_chunks", "admissions",
               "queue_wait_ticks")},
           "audit_claimed": audit["claimed"][:4],
           "audits": log["audits"], "resumes_bit_exact": log["resumes_checked"],
           "launches": launches, "watched_run_s": watched_s,
           # times of the unwatched twin; decode_s (and so ms/tick) leaves
           # out decode_headroom_s, prefill_s takes in prefill_headroom_s
           "run_s": timed[4], "prefill_s": tm["prefill_s"],
           "decode_s": tm["decode_s"],
           "ms_per_tick": 1e3 * tm["decode_s"] / max(tm["ticks"], 1),
           **clocks, "spill_s": tm["spill_s"],
           "spill_bytes_per_preemption":
               tm["spill_bytes"] / max(tm["preemptions"], 1),
           "spill_s_per_preemption":
               tm["spill_s"] / max(tm["preemptions"], 1),
           "cow_compare_ms": cow_ms, "peak_mem_gb": peak_gb,
           "twin": twin, "vs_unpressured": unpressured,
           "vs_reference_backend": reference,
           "failed": failed, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if failed:
        raise AssertionError(f"pressure phase failed: {failed}")
    rec["runs"] = {"kernel": run_record(eng, done),
                   "reference": run_record(*ref_run[:2])}
    rec["traffic"] = (prompts, priorities, pool_blocks)
    return rec


SAMPLED_T, SAMPLED_TOP_P = 0.6, 0.95   # DeepSeek-R1-Distill's model card
SAMPLED_ORDER = (1, 8, 8, 1)            # ticks per dispatch, in turns


def sampled_serve(engine_cls, cfg, params, prompts, max_new, dev, tpd,
                  profile_forks=False):
    """The prompts through the orchestrator with ``samples_per_slot=2``
    (each parent and one fork), ``tpd`` ticks per dispatch, the kernel
    backend; launch counts zeroed just before and read just after.  Each
    ``fork_slot`` is timed: its host ms (from a synchronised start to a
    synchronised end) or, with ``profile_forks``, its device busy ms
    (torch.profiler; the fork reads a refcount back, so it cannot be
    captured in a CUDA graph).  Returns (engine, streams, launches, fork
    times)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.orchestrator import Orchestrator
    eng = engine_cls(cfg, params=params, backend="kernel", device=dev,
                     record_logits=True, allow_forks=True,
                     ticks_per_dispatch=tpd)
    fork, forks = eng.fork_slot, []

    def timed_fork(*args):
        torch.cuda.synchronize()
        if profile_forks:
            forks.append(profile_window(lambda: fork(*args))[
                "device_busy_ms"])
            return
        t0 = time.perf_counter()
        fork(*args)
        torch.cuda.synchronize()
        forks.append(1e3 * (time.perf_counter() - t0))
    eng.fork_slot = timed_fork
    orch = Orchestrator(eng)
    streams = [orch.submit(p, max_new_tokens=max_new, samples_per_slot=2)
               for p in prompts]
    torch.cuda.synchronize()
    ops.reset_launches()
    orch.run_sync()
    return eng, streams, dict(ops.LAUNCHES), forks


def sampled_phase(engine_cls, params, mc, prompts, dev, max_new=64) -> dict:
    """Sampling at DeepSeek-R1-Distill's published settings (temperature
    0.6, top-p 0.95), forks and packs at r1-llama-8b's full width and
    ``mc``'s depth (``CUT_LAYERS`` from ``main``; random weights, the
    kernel backend, default ThinKVConfig, 4 slots): the serve phase's first two 1100-token prompts,
    each submitted with ``samples_per_slot=2``, so 4 slots hold 2 parents
    and 2 forks; 64 new tokens.  Served at 1, 8, 8 and 1 ticks per
    dispatch (in turns, since the host's speed drifts within a call): the
    four runs must give the same tokens and bit-identical logits per
    request, and each child other tokens than its parent.  Then greedy at
    8 ticks per dispatch with the same forks: each child's tokens equal
    its parent's.  In every run: 2 forks, peak refcount > 1, at least one
    COW fault on a forked slot, a clean audit, K1 once per tick, K4 once
    per commit, and at 8 fewer dispatches than ticks.  Also timed: one
    ``_sample_slots`` draw at [4, 128256] (greedy, T 0.6 top-p 1, T 0.6
    top-p 0.95; device ms from a CUDA graph) and ``fork_slot`` (host ms in
    the four sampled runs, device busy ms in the greedy run)."""
    import numpy as np
    import torch
    from repro_torch.config import ServeConfig, ThinKVConfig
    from repro_torch.serving import prng
    from repro_torch.serving.engine import _sample_slots
    t_phase = time.perf_counter()
    counters = ("ticks", "tokens", "dispatches", "forks", "fork_cow_faults",
                "cow_faults", "peak_refcount", "commits",
                "early_exit_finish", "early_exit_headroom")
    failed, runs, first = [], [], None

    def check(eng, streams, launches, tpd, label):
        m = eng.metrics
        if m["forks"] != len(streams) or m["peak_refcount"] <= 1 or \
                m["fork_cow_faults"] < 1:
            failed.append(f"{label}: forks {m['forks']}, peak refcount "
                          f"{m['peak_refcount']}, fork COW faults "
                          f"{m['fork_cow_faults']}")
        try:
            eng.audit_pool()
        except AssertionError as e:
            failed.append(f"{label}: audit {e}")
        if launches["ct_paged_attention_fused"] != m["ticks"]:
            failed.append(f"{label}: K1 launched "
                          f"{launches['ct_paged_attention_fused']} times over"
                          f" {m['ticks']} ticks")
        if launches["group_quant"] != m["commits"]:
            failed.append(f"{label}: K4 launched {launches['group_quant']} "
                          f"times for {m['commits']} commits")
        if tpd > 1 and not m["dispatches"] < m["ticks"]:
            failed.append(f"{label}: {m['dispatches']} dispatches for "
                          f"{m['ticks']} ticks")
        reqs = [r for s in streams for r in (s.request,
                                             s.forks[0].request)]
        if any(len(r.output) != max_new for r in reqs):
            failed.append(f"{label}: not every request has its tokens")
        for arr in eng.request_logits.values():
            if not np.isfinite(np.stack(arr)).all():
                failed.append(f"{label}: logits not finite")
                break
        return {"tpd": tpd, **{k: m[k] for k in counters},
                "prefill_s": m["prefill_s"], "decode_s": m["decode_s"],
                "ms_per_tick": 1e3 * m["decode_s"] / max(m["ticks"], 1),
                "dispatches_per_token": m["dispatches"] / max(m["tokens"], 1),
                "trips_per_dispatch": m["ticks"] / max(m["dispatches"], 1),
                "launches": launches}

    cfg = ServeConfig(model=mc, thinkv=ThinKVConfig(), max_seqs=4,
                      temperature=SAMPLED_T, top_p=SAMPLED_TOP_P)
    prompts = prompts[:2]
    fork_times = []
    for n, tpd in enumerate(SAMPLED_ORDER):
        eng, streams, launches, forks = sampled_serve(
            engine_cls, cfg, params, prompts, max_new, dev, tpd)
        fork_times += forks
        runs.append(check(eng, streams, launches, tpd, f"run {n} tpd {tpd}"))
        outs = {r.arrival: (r.output, np.stack(eng.request_logits[r.arrival]))
                for s in streams for r in (s.request, s.forks[0].request)}
        if first is None:
            first = outs
            same_parent = [s.request.output == s.forks[0].request.output
                           for s in streams]
            if any(same_parent):
                failed.append(f"a sampled child emitted its parent's "
                              f"tokens: {same_parent}")
        elif sorted(outs) != sorted(first) or any(
                outs[a][0] != first[a][0] or
                not np.array_equal(outs[a][1], first[a][1]) for a in first):
            failed.append(f"run {n} (tpd {tpd}) differs from run 0 in "
                          f"tokens or logits")
        del eng
    greedy_cfg = dataclasses.replace(cfg, temperature=0.0)
    eng, streams, launches, fork_busy = sampled_serve(
        engine_cls, greedy_cfg, params, prompts, max_new, dev, 8,
        profile_forks=True)
    greedy = check(eng, streams, launches, 8, "greedy tpd 8")
    greedy["children_equal_parents"] = [
        s.request.output == s.forks[0].request.output for s in streams]
    if not all(greedy["children_equal_parents"]):
        failed.append(f"a greedy child differs from its parent: "
                      f"{greedy['children_equal_parents']}")
    del eng
    torch.cuda.empty_cache()
    # the sampler at the tick's width: one draw for 4 slots
    gen = torch.Generator(device=dev).manual_seed(SEED)
    logits = torch.randn((4, mc.vocab_size), generator=gen, device=dev) * 3
    keys = prng.split(prng.prng_key(SEED, dev), 4)
    sampler_ms = {
        f"T={t} top_p={p}": device_ms(
            lambda t=t, p=p: _sample_slots(keys, logits, t, p))
        for t, p in ((0.0, 1.0), (SAMPLED_T, 1.0),
                     (SAMPLED_T, SAMPLED_TOP_P))}
    rec = {"phase": "sampled", "layers": mc.num_layers,
           "temperature": SAMPLED_T, "top_p": SAMPLED_TOP_P, "slots": 4,
           "requests": len(prompts), "samples_per_slot": 2,
           "prompt_len": len(prompts[0]), "max_new": max_new,
           "runs": runs, "greedy": greedy,
           "sampler_device_ms": sampler_ms,
           "fork_host_ms": float(np.mean(fork_times)),
           "forks_host_timed": len(fork_times),
           "fork_device_busy_ms": float(np.mean(fork_busy)),
           "forks_profiled": len(fork_busy),
           "failed": failed, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if failed:
        raise AssertionError(f"sampled phase failed: {failed}")
    return rec


POLICY_NAMES = ("thinkv", "rkv", "uniform")


def policy_phase(engine_cls, params, mc, dev, max_new=64) -> dict:
    """The pressure phase's traffic, model width (at ``mc``'s depth:
    ``CUT_LAYERS`` from ``main``), 4 slots, 512-token budget, pool
    (PRESSURE_FRAC x 4 x NB blocks) and prefix cache, served on the kernel
    backend under each retention policy with the drift probe on
    (``thinkv`` is the control arm).  Per policy: preemptions, resumes, COW
    faults, commits, the footprint as a share of bf16, the mean bits,
    ``prefill_s``, ms/tick (``decode_s`` leaves out decode-headroom
    preemption, as in the pressure phase's twin) and the drift against the
    dense replay (max, mean, top-1 agreement; the probe's host seconds
    apart).  Held: every request's tokens, a clean audit, one probe per
    request with finite drift, K1 once per tick, K4 once per commit, K1-K4
    launched, uniform's mean bits 4.00.  With random weights the drift
    tests the mechanism, not quality."""
    import numpy as np
    import torch
    from repro_torch.config import ServeConfig, ThinKVConfig
    from repro_torch.core import ct_cache as CC
    t_phase = time.perf_counter()
    tk = ThinKVConfig(token_budget=PRESSURE_BUDGET)
    cfg = ServeConfig(model=mc, thinkv=tk, max_seqs=4)
    prompts, priorities = pressure_traffic(
        mc.vocab_size, np.random.default_rng(SEED))
    dims = CC.make_dims(tk, mc.num_layers, mc.num_kv_heads, mc.head_dim)
    pool_blocks = int(4 * dims.NB * PRESSURE_FRAC)
    runs, failed = {}, []
    for name in POLICY_NAMES:
        eng, done, launches, clocks, run_s = pressure_serve(
            engine_cls, cfg, params, prompts, priorities, max_new, dev,
            "kernel", pool_blocks, True, watch=False, policy=name,
            drift_probe=True)
        m, bad = eng.metrics, []
        try:
            audit = eng.audit_pool()["claimed"][:4]
        except AssertionError as e:
            audit = None
            bad.append(f"pool audit: {e}")
        if len(done) != len(prompts) or any(len(r.output) != max_new
                                            for r in done):
            bad.append("not every request finished with its tokens")
        drifts = [r.stats.get("drift") for r in done]
        if m["drift_probes"] != len(prompts) or None in drifts or not all(
                np.isfinite(d["max_abs"]) and np.isfinite(d["mean_abs"])
                and d["steps"] == max_new for d in drifts if d):
            bad.append(f"{m['drift_probes']} probes for {len(prompts)} "
                       f"requests, drift {drifts}")
        if launches["ct_paged_attention_fused"] != m["ticks"]:
            bad.append(f"K1 launched {launches['ct_paged_attention_fused']}"
                       f" times over {m['ticks']} ticks")
        if launches["group_quant"] != m["commits"]:
            bad.append(f"K4 launched {launches['group_quant']} times for "
                       f"{m['commits']} commits")
        if not all(launches[k] > 0 for k in K1_K4):
            bad.append(f"a kernel never launched: {launches}")
        bits = float(np.mean([r.stats["avg_bits"] for r in done]))
        if name == "uniform" and f"{bits:.2f}" != "4.00":
            bad.append(f"uniform's mean bits {bits}")
        ok = [d for d in drifts if d]
        runs[name] = {
            **{k: m[k] for k in ("preemptions", "resumes", "cow_faults",
                                 "commits", "ticks", "tokens",
                                 "prefix_hits", "drift_probes")},
            "footprint_frac": float(np.mean(
                [r.stats["footprint_frac"] for r in done])),
            "avg_bits": bits, "prefill_s": m["prefill_s"],
            "decode_s": m["decode_s"],
            "ms_per_tick": 1e3 * m["decode_s"] / max(m["ticks"], 1),
            "run_s": run_s, **clocks,
            "drift_max_abs": max((d["max_abs"] for d in ok), default=None),
            "drift_mean_abs": float(np.mean([d["mean_abs"] for d in ok]))
            if ok else None,
            "drift_top1_agree": float(np.mean([d["top1_agree"] for d in ok]))
            if ok else None,
            "audit_claimed": audit, "launches": launches, "mismatches": bad}
        failed += [f"{name}: {b}" for b in bad]
        del eng, done
        torch.cuda.empty_cache()
    rec = {"phase": "policy", "layers": mc.num_layers,
           "budget": tk.token_budget, "NB": dims.NB, "slots": 4,
           "requests": len(prompts), "max_new": max_new,
           "frac": PRESSURE_FRAC, "pool_blocks": pool_blocks, "runs": runs,
           "failed": failed, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if failed:
        raise AssertionError(f"policy phase failed: {failed}")
    return rec


SERVE_STEP_K1_ATOL = 1e-4


class plain_k1:
    """Within the block, ``ops.paged_decode_attention_fused`` computes K1's
    plain version on the card (what the step is held against)."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.ops, self.kernel = ops, ops.paged_decode_attention_fused
        ops.paged_decode_attention_fused = \
            lambda *a, group=16: ref.ct_paged_attention_fused_ref(
                *a, group=group)

    def __exit__(self, *exc):
        self.ops.paged_decode_attention_fused = self.kernel


def thinkv_step_batch(eng) -> dict:
    """The ThinKV decode step's batch of an engine's slots after prefill:
    each slot's pool view gathered through its table (``[B, L, NB, BS,
    ...]``), its slot planes, bf16 buffer and counts, the token its
    prefill sampled and its position."""
    import torch
    from repro_torch.core import ct_cache as CC
    views = [CC.gather_view(eng.pool.view, eng.tables[i])
             for i in range(eng.cfg.max_seqs)]
    batch = {name: torch.stack([v[j] for v in views]).contiguous()
             for j, name in enumerate(CC.PoolView._fields)}
    c = eng.caches
    batch.update(
        slot_state=c.slot_state.clone(), slot_bits=c.slot_bits.clone(),
        buf_k=c.buf_k.clone(), buf_v=c.buf_v.clone(),
        buf_len=c.buf_len.clone(), positions=c.num_tokens.clone(),
        tokens=torch.as_tensor(eng._feed, device=eng.device))
    return batch


def check_serve_step_k1(dev, mc, batch) -> dict:
    """K1 at the ThinKV step's shape (L 1, R B, the batch's planes as one
    pool of B·L·NB blocks, layer 0's table and slot planes, its buffer with
    one more row) against its plain version, <= SERVE_STEP_K1_ATOL, with
    its device time and bound."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, L, nb, bs, h, d = batch["k_codes"].shape
    gq = mc.num_heads // h

    def pool(a):
        return a.reshape(1, b * L * nb, bs, h, a.shape[-1])
    table = (torch.arange(b, device=dev)[:, None] * L * nb
             + torch.arange(nb, device=dev)[None]).to(torch.int32)[:, None]
    meta = [batch[k][:, 0].reshape(1, b, nb, bs).contiguous()
            for k in ("slot_state", "slot_bits")]
    args = (torch.randn((1, b, h, gq, d), generator=gen, device=dev),
            *(pool(batch[k]) for k in ("k_codes", "v_codes", "k_scales",
                                       "v_scales")),
            *meta, table, batch["buf_k"][:, 0][None].contiguous(),
            batch["buf_v"][:, 0][None].contiguous(),
            (batch["buf_len"] + 1).to(torch.int32))
    out = ops.paged_decode_attention_fused(*args)
    torch.cuda.synchronize()
    err = max_err(out, ref.ct_paged_attention_fused_ref(*args))
    per_block = bs * h * (2 * d + 2 * 2 * (d // 16))
    pool_b, n_slots = pool_need(meta[0], table, per_block)
    n_buf = int(args[-1].sum())
    rec = kernel_record(
        "ct_paged_attention_fused", "ct_paged_attention.cu",
        "ct_paged_attention.py:204",
        f"serve step: L=1 R={b} H={h} GQ={gq} D={d} BS={bs} NB={nb}", err,
        lambda: ops.paged_decode_attention_fused(*args),
        lambda: ref.ct_paged_attention_fused_ref(*args),
        bound(pool_b + nbytes(args[0], *meta, table, args[-1], out)
              + 2 * n_buf * h * d * 2, 4 * h * gq * d * (n_slots + n_buf)),
        plain_iters=3)
    if not err <= SERVE_STEP_K1_ATOL:
        raise AssertionError(f"K1 at the serve step's shape: {err} > "
                             f"{SERVE_STEP_K1_ATOL}")
    return rec


def bf16_steps_over(a, b) -> float:
    """max |a - b| / max(ATOL, one bf16 step at max(|a|, |b|)) over the
    elements of two bf16 tensors: <= 1 when every element is at most one
    rounding step (or ATOL) apart."""
    import torch
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return float(((a - b).abs() / step.clamp_min(ATOL)).max())


def kv_bytes_per_request(batch, mapped_blocks=None) -> list:
    """A ThinKV request's KV bytes: its mapped pool blocks (codes and
    scales of K and V; every block of the batch's planes where
    ``mapped_blocks`` is None), its slot planes and its bf16 buffer."""
    b, L, nb, bs, h, d = batch["k_codes"].shape
    if mapped_blocks is None:
        mapped_blocks = [L * nb] * b
    per_block = bs * h * (2 * d + 2 * 2 * (d // 16))
    meta = 2 * L * nb * bs + 2 * L * batch["buf_k"].shape[2] * h * d * 2
    return [int(n) * per_block + meta for n in mapped_blocks]


def fullkv_bytes(mc, tokens: int) -> int:
    """A FullKV request's bf16 K and V over ``tokens`` rows of every
    attention layer (the reference's cache dtype)."""
    return tokens * 2 * mc.num_attention_layers() * mc.num_kv_heads * \
        mc.head_dim * 2


def serve_step_phase(params, mc, dev, prompts, patches=None,
                     phase="serve_step") -> dict:
    """The dense serve steps at the serve phase's shapes (default
    ThinKVConfig, 4 slots, the 4 x 1100-token prompts).  A kernel-backend
    engine prefills the prompts; the 4 slots' pool views and buffers make
    the ThinKV step's batch (``thinkv_step_batch``), which
    ``thinkv_step_check`` holds on the kernel backend (K1 once per layer,
    the plain K1's step, the reference backend's, K1 at the step's shape
    against its plain version).  The FullKV prefill of the same prompts and
    one FullKV decode step over bf16 caches of T = S + 64 rows follow.
    Reported: device ms per step (the profiler's busy time), KV bytes per
    request and the two steps' top-1 agreement.

    With ``patches`` [B, P, frontend_dim] (the VLM family) the FullKV
    prefill runs over the image prefix and the text (P + S rows), as does
    ``make_prefill_step`` (its logits held to the prefill's, its time
    reported), and both decode steps run at positions past the prefix."""
    import numpy as np
    import torch
    from repro_torch.config import ServeConfig, ThinKVConfig
    from repro_torch.models import lm
    from repro_torch.serving import serve_step as SS
    from repro_torch.serving.engine import ThinKVEngine
    t_phase = time.perf_counter()
    tk = ThinKVConfig()
    eng = ThinKVEngine(ServeConfig(model=mc, thinkv=tk, max_seqs=4),
                       params=params, backend="kernel", device=dev)
    eng.submit(prompts, max_new_tokens=2)
    eng.run(max_ticks=0)                        # admission + prefill
    batch = thinkv_step_batch(eng)
    P = 0 if patches is None else patches.shape[1]
    batch["positions"] = batch["positions"] + P
    mapped = (eng.tables >= 0).sum((1, 2)).tolist()
    del eng
    torch.cuda.empty_cache()
    chk = thinkv_step_check(mc, tk, params, batch, dev)
    failed = chk.pop("failed")

    # FullKV: the same prompts (after the image prefix), bf16 caches of
    # P + S + 64 rows
    toks = torch.as_tensor(np.stack(prompts), device=dev)
    B, S = toks.shape
    pre = {"tokens": toks} if patches is None else \
        {"tokens": toks, "patches": patches}
    t0 = time.perf_counter()
    lg0, kc, vc = lm.prefill(params, pre, mc)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    step_rec = {}
    if patches is not None:
        prefill_step = SS.make_prefill_step(None, mc)
        t0 = time.perf_counter()
        lg_step = prefill_step(params, pre)
        torch.cuda.synchronize()
        step_rec = {"prefill_step_s": time.perf_counter() - t0,
                    "prefill_step_rows": P + S,
                    "prefill_step_vs_prefill": max_err(lg_step, lg0)}
        if not step_rec["prefill_step_vs_prefill"] <= ATOL:
            failed.append(f"the prefill step's logits "
                          f"{step_rec['prefill_step_vs_prefill']} from "
                          f"lm.prefill's")
    T = P + S
    caches = []
    for c in (kc, vc):
        full = torch.zeros((B, mc.num_layers, T + 64, mc.num_kv_heads,
                            mc.head_dim), dtype=torch.bfloat16, device=dev)
        full[:, :, :T] = c.transpose(0, 1)
        caches.append(full)
    del kc, vc
    fb = {"tokens": batch["tokens"], "positions": batch["positions"],
          "k_cache": caches[0], "v_cache": caches[1],
          "cache_len": torch.full((B,), T, dtype=torch.int32, device=dev)}
    step_f = SS.make_decode_step_fullkv(mc)
    out_f = step_f(params, fb)
    fullkv_prof = profile_window(lambda: step_f(params, fb))
    agree = (out_f[0].argmax(-1).cpu() ==
             torch.as_tensor(chk["greedy_tokens"])).float().mean()
    if not all(torch.isfinite(t).all() for t in (out_f[0], lg0)):
        failed.append("non-finite logits")
    rec = {"phase": phase, "layers": mc.num_layers, "requests": B,
           "prompt_len": S, "image_tokens": P, **step_rec,
           "NB": batch["k_codes"].shape[2],
           "BS": batch["k_codes"].shape[3], "G": batch["buf_k"].shape[2],
           **chk,
           "fullkv_step_device_ms": fullkv_prof["device_busy_ms"],
           "fullkv_step_window_ms": fullkv_prof["window_ms"],
           "fullkv_prefill_s": prefill_s,
           "thinkv_kv_bytes_per_request": kv_bytes_per_request(batch,
                                                               mapped),
           "fullkv_kv_bytes_per_request": fullkv_bytes(mc, T + 1),
           "top1_agree_fullkv_thinkv": float(agree),
           "first_token_agree_fullkv_engine": float(
               (lg0.argmax(-1) == batch["tokens"]).float().mean()),
           "failed": failed, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if failed:
        raise AssertionError(f"{phase} phase failed: {failed}")
    return rec


# configs whose full-width kernel shapes the archs phase holds, each at the
# depth it serves here (qwen2-7b in full, mixtral-8x7b at 4 of 32 layers)
# or, when not served, at its full depth: the query-group sizes 7, 4, 5, 8
# and 12 over 4 or 8 kv heads
ARCH_KERNELS = (("qwen2-7b", 28), ("mixtral-8x7b", 4),
                ("llama4-scout-17b-a16e", 48), ("yi-6b", 32),
                ("mistral-large-123b", 88))
ARCH_SERVED = (("qwen2-7b", None), ("mixtral-8x7b", 4))
ARCH_PROMPT, ARCH_NEW = 1100, 64
PARITY_LAYERS = 4          # the parity phase's depth
# the pressure, sampled and policy phases' depth (of r1-llama-8b's 32),
# cut so that the whole script stays well inside its time limit on a slow
# host
CUT_LAYERS = 8


def check_arch_kernels(dev, tk, archs=ARCH_KERNELS) -> dict:
    """K1-K4 against their plain versions at each ``archs`` (config,
    depth)'s full-width shapes (1e-3 abs for attention, K4 bit-exact): K1
    over a 4-slot tick, K2 at the big chunk's and the g-chunk's folded GQ
    (128 and 16 queries per q head), K3 at S 128 and at a g-chunk with 11
    valid keys (SDPA's time beside it), K4 over one commit.  Returns the
    records keyed ``"<arch> K1"`` ... ``"<arch> K4"``."""
    import torch
    from repro_torch.configs import get_config
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    BS, G = tk.block_size, tk.group_size
    NB = int(tk.token_budget * 2) // BS
    recs = {}
    for arch, L in archs:
        mc = get_config(arch)
        H, D, hq = mc.num_kv_heads, mc.head_dim, mc.num_heads
        gq, label = hq // H, f"{arch}: "
        recs[f"{arch} K1"], c = k1_record(gen, dev, L, 4, H, gq, D, BS, NB,
                                          G, label)
        recs[f"{arch} K2"] = k2_record(gen, dev, c, 128 * gq, label)
        recs[f"{arch} K2_g"] = k2_record(gen, dev, c, G * gq, label)
        del c
        recs[f"{arch} K3"] = k3_record(gen, dev, 128, None, hq, H, D, label)
        recs[f"{arch} K3_g"] = k3_record(gen, dev, G, 11, hq, H, D, label)
        recs[f"{arch} K4"], _ = k4_commit_record(gen, dev, L, G, H, D, tk,
                                                 label)
        torch.cuda.empty_cache()
    bad = {n: r["max_abs_err"] for n, r in recs.items()
           if not r["max_abs_err"] <= ATOL}
    over = [n for n, r in recs.items() if r["bound_share"] > 1]
    if bad or over:
        raise AssertionError(f"archs kernels: disagree with their plain "
                             f"versions {bad} (> {ATOL}); bound above the "
                             f"time {over}")
    return recs


def moe_routing(engine_cls, cfg, params, prompts, max_new, dev) -> dict:
    """The MoE routing of a second kernel-backend run of the same traffic
    (``layers/moe.py``'s ``moe_route`` wrapped; the counts stay on the card
    until the run ends): per layer, the kept choices per expert and the
    dropped choices, apart for prefill chunks and decode ticks (a tick
    routes the ``max_seqs`` slots as one group), and the run's tokens."""
    import torch
    from repro_torch.layers import moe as MOE
    mc = cfg.model
    L, E, R = mc.num_layers, mc.moe.num_experts, cfg.max_seqs
    layer_of = {params.router[i].data_ptr(): i for i in range(L)}
    kept = torch.zeros((2, L, E), dtype=torch.int64, device=dev)
    dropped = torch.zeros((2, L), dtype=torch.int64, device=dev)
    route = MOE.moe_route

    def counted(router, xt, c):
        rt = route(router, xt, c)
        l, tick = layer_of[router.data_ptr()], int(xt.shape[1] == R)
        kept[tick, l] += torch.bincount(rt.expert[rt.keep], minlength=E)
        dropped[tick, l] += (~rt.keep).sum()
        return rt
    MOE.moe_route = counted
    try:
        eng, done = serve(engine_cls, cfg, params, prompts, max_new,
                          "kernel", dev)
    finally:
        MOE.moe_route = route
    k, d = kept.tolist(), dropped.tolist()
    return {"top_k": mc.moe.num_experts_per_token, "experts": E,
            "prefill": {"kept_per_expert": k[0], "dropped": d[0]},
            "decode": {"kept_per_expert": k[1], "dropped": d[1]},
            "outputs": {r.arrival: r.output for r in done}}


def arch_kernel_shapes(arc: dict, kernel: str, archs=ARCH_KERNELS) -> dict:
    """One kernel's records at the archs (or vlm) phase's shapes for the
    kernels line: shape, times, bound, error and, for a served config, the
    launches of its serve run at that shape (by chunk shape for K2 and
    K3)."""
    from repro_torch.configs import get_config
    out = {}
    for arch, _ in archs:
        mc = get_config(arch)
        gq = mc.num_heads // mc.num_kv_heads
        shapes = {"K1": {"K1": None}, "K4": {"K4": None},
                  "K2": {"K2": f"GQ={128 * gq}", "K2_g": f"GQ={16 * gq}"},
                  "K3": {"K3": "S=128", "K3_g": "S=16"}}[kernel]
        for key, by in shapes.items():
            r = arc["records"][f"{arch} {key}"]
            launches = None
            if arch in arc:
                served = arc[arch]
                launches = served["launches"][r["name"]] if by is None \
                    else served["launches_by_shape"][r["name"]][by]
            out[f"{arch} {key}"] = {
                "launches": launches,
                **{k: r[k] for k in ("shape", "ms", "eager_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "max_abs_err")}}
    return out


def f64_check_prompts(short, other):
    """The prompts of ``f64_prefill_check``: the parity prompts ``short``
    (a big chunk of 128 tokens and a 12-token g-chunk), ``other`` (a
    second big chunk), and ``other`` followed by the g-chunk's tokens."""
    import numpy as np
    return [short[0], other, short[1], np.concatenate([other, short[1]])]


def parity_at_depth(mc, tk, prompts, short, dev):
    """``parity`` (prefill and decode held, the free-running pair left out)
    on ``mc`` cut to ``PARITY_LAYERS`` of its layers, with random weights
    from ``SEED``: the depth at which the backend-to-backend prefill
    comparison is held."""
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.models.lm import init_params
    from repro_torch.serving.engine import ThinKVEngine
    mcl = dataclasses.replace(mc, num_layers=PARITY_LAYERS)
    params = init_params(mcl, SEED, dev)
    par = parity(ThinKVEngine, ServeConfig(model=mcl, thinkv=tk, max_seqs=4),
                 params, prompts, short, ARCH_NEW, dev, free_running=False)
    del params
    gc.collect()                     # engines keep the weights in cycles
    torch.cuda.empty_cache()
    return par


def archs_phase(dev, tk) -> dict:
    """This slice's configs on the card.  First ``check_arch_kernels``;
    then qwen2-7b at full width and depth (28 layers, 28 q / 4 kv heads,
    qkv bias; random f32 weights from a seed, 30.3 GB) and mixtral-8x7b at
    full width and 4 of its 32 layers (8 experts, top 2; 24.3 GB), each
    serving the serve phase's traffic (4 prompts of 1100 tokens, 64 new,
    greedy) on the kernel backend with the serve phase's checks (K1 once
    per tick, K2 and K3 once per chunk and layer by shape, K4 once per
    commit); the kernel backend against the reference backend (the parity
    phase's checks, the free-running pair left out); for mixtral the
    routing per layer of a second run, whose tokens must equal the
    first's.

    At the served depth the decode comparison from identical state is
    held (tokens, logits within the bar, byte-identical pools), and so is
    each backend's prefill against the f64 run of the plain path that
    follows it (``prefill_vs_f64``, ``f64_check_prompts``: two big
    chunks, the 12-token g-chunk from an empty pool, and one after a big
    chunk, which reads the big chunk's codes through K2 and the merge).  The
    backend-to-backend prefill comparison of the parity phase's prompts (a
    big chunk and a 12-token g-chunk) is held at the parity phase's 4
    layers of the same width (``parity_at_depth``) and reported at 28:
    each backend rounds a g-chunk's keys and values to bf16 (the TBQ
    buffer, as the reference does) from its own f32 values
    (``prefill_vs_f64`` counts the stored values that differ from the f64
    run's own rounding and reports the distance of an f64 run that rounds
    its own)."""
    import numpy as np
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params
    from repro_torch.serving.engine import ThinKVEngine
    t_phase = time.perf_counter()
    recs = check_arch_kernels(dev, tk)
    out = {"phase": "archs", "kernels": {
        n: {k: r[k] for k in ("shape", "max_abs_err", "ms", "eager_ms",
                              "plain_ms", "bound_ms", "bound_by",
                              "library_ms")} for n, r in recs.items()},
        "kernels_s": time.perf_counter() - t_phase}
    failed = []
    for arch, layers in ARCH_SERVED:
        t1 = time.perf_counter()
        mc = get_config(arch)
        if layers:
            mc = dataclasses.replace(mc, num_layers=layers)
        cfg = ServeConfig(model=mc, thinkv=tk, max_seqs=4)
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, mc.vocab_size, ARCH_PROMPT)
                   for _ in range(4)]
        short = [rng.integers(0, mc.vocab_size, n) for n in (128, 12)]
        f64_prompts = f64_check_prompts(short, rng.integers(
            0, mc.vocab_size, 128))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(mc, SEED, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights_gb = sum(p.numel() * p.element_size()
                         for p in params.parameters()) / 1e9
        srv = serve_phase(ThinKVEngine, cfg, params, prompts, ARCH_NEW,
                          init_s, dev, phase=f"archs {arch}")
        rec = {k: v for k, v in srv.items() if k not in ("phase", "outputs",
                                                         "run")}
        rec.update(layers_of=get_config(arch).num_layers,
                   heads=mc.num_heads, kv_heads=mc.num_kv_heads,
                   qkv_bias=mc.qkv_bias, weights_gb=weights_gb)
        if mc.moe is not None:
            routing = moe_routing(ThinKVEngine, cfg, params, prompts,
                                  ARCH_NEW, dev)
            if routing.pop("outputs") != srv["outputs"]:
                failed.append(f"{arch}: the routing run's tokens differ "
                              f"from the timed run's")
            rec["moe"] = routing
        deep = mc.num_layers > PARITY_LAYERS
        par = parity(ThinKVEngine, cfg, params, prompts, short, ARCH_NEW,
                     dev, free_running=False,
                     hold=("decode",) if deep else ("prefill", "decode"))
        rec["parity"] = par
        failed += [f"{arch} parity: {f}" for f in par["failed"]]
        if deep and mc.moe is None:
            rec["prefill_vs_f64"] = f64_prefill_check(
                ThinKVEngine, cfg, params, f64_prompts, dev)
            failed += [f"{arch} prefill vs f64: {f}" for f in
                       f64_failures(rec["prefill_vs_f64"])]
        del params
        gc.collect()                 # engines keep the weights in cycles
        torch.cuda.empty_cache()
        if deep:
            rec["parity_4_layers"] = par4 = parity_at_depth(
                mc, tk, prompts, short, dev)
            failed += [f"{arch} 4-layer parity: {f}" for f in par4["failed"]]
        rec["seconds"] = time.perf_counter() - t1
        out[arch] = rec
    out["seconds"] = time.perf_counter() - t_phase
    out["failed"] = failed
    emit(out)
    if failed:
        raise AssertionError(f"archs phase failed: {failed}")
    out["records"] = recs
    return out


VLM_ARCH = "paligemma-3b"
VLM_KERNELS = ((VLM_ARCH, 18),)


def vlm_phase(dev, tk) -> dict:
    """The VLM family (paligemma-3b: head_dim 256, one kv head, GQ 8, tied
    embeddings scaled by sqrt(d_model), GeGLU) on the card.  First K1-K4
    at its full-width shapes (``check_arch_kernels``: K1 over a 4-slot
    tick at L 18, K2 at the big chunk's and the g-chunk's folded GQ 1024
    and 128, K3 at S 128 and a g-chunk of 11 valid keys with SDPA's time
    at D 256, K4 over one commit [18, 16, 1, 256]).  Then the full model
    (18 layers, random f32 weights from a seed, ~10 GB) serves the serve
    phase's traffic (4 x 1100 random tokens, 64 new, greedy; text only,
    as the engine serves the VLM) on the kernel backend with the serve
    phase's launch checks; the kernel backend against the reference
    backend from identical state (the parity phase's decode check held:
    tokens, logits within the bar, byte-identical pools; its prefill
    check reported, and held at 4 layers, ``parity_at_depth``, as for
    qwen2-7b in ``archs_phase``); both backends' prefill held within the
    bar of the f64 run of the plain path that follows it
    (``f64_prefill_check`` on ``f64_check_prompts``: big chunks, g-chunks
    over an empty pool and over a big chunk's codes); and the serve steps
    with an image prefix
    (``serve_step_phase`` with patches [4, 256, 1152] from numpy seed
    ``SEED``: 1356 rows of prefill, the ThinKV step's K1 at L 1, R 4,
    D 256)."""
    import numpy as np
    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params
    from repro_torch.serving.engine import ThinKVEngine
    t_phase = time.perf_counter()
    recs = check_arch_kernels(dev, tk, VLM_KERNELS)
    out = {"phase": "vlm", "kernels": {
        n: {k: r[k] for k in ("shape", "max_abs_err", "ms", "eager_ms",
                              "plain_ms", "bound_ms", "bound_by",
                              "library_ms")} for n, r in recs.items()},
        "kernels_s": time.perf_counter() - t_phase}
    mc = get_config(VLM_ARCH)
    cfg = ServeConfig(model=mc, thinkv=tk, max_seqs=4)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, mc.vocab_size, ARCH_PROMPT) for _ in range(4)]
    short = [rng.integers(0, mc.vocab_size, n) for n in (128, 12)]
    f64_prompts = f64_check_prompts(short, rng.integers(0, mc.vocab_size,
                                                         128))
    patches = torch.as_tensor(np.random.default_rng(SEED).standard_normal(
        (4, mc.num_image_tokens, mc.frontend_dim)).astype(np.float32),
        device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(mc, SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    srv = serve_phase(ThinKVEngine, cfg, params, prompts, ARCH_NEW, init_s,
                      dev, phase=f"vlm {VLM_ARCH}")
    rec = {k: v for k, v in srv.items()
           if k not in ("phase", "outputs", "run")}
    rec.update(heads=mc.num_heads, kv_heads=mc.num_kv_heads,
               head_dim=mc.head_dim, weights_gb=sum(
                   p.numel() * p.element_size()
                   for p in params.parameters()) / 1e9)
    par = parity(ThinKVEngine, cfg, params, prompts, short, ARCH_NEW, dev,
                 free_running=False, hold=("decode",))
    rec["parity"] = par
    failed = [f"parity: {f}" for f in par["failed"]]
    rec["prefill_vs_f64"] = f64_prefill_check(ThinKVEngine, cfg, params,
                                              f64_prompts, dev)
    failed += [f"prefill vs f64: {f}"
               for f in f64_failures(rec["prefill_vs_f64"])]
    out[VLM_ARCH] = rec
    out["records"] = recs
    gc.collect()
    torch.cuda.empty_cache()
    out["serve_step"] = serve_step_phase(params, mc, dev, prompts, patches,
                                         phase="vlm serve_step")
    del params
    gc.collect()                     # engines keep the weights in cycles
    torch.cuda.empty_cache()
    rec["parity_4_layers"] = par4 = parity_at_depth(mc, tk, prompts, short,
                                                    dev)
    failed += [f"4-layer parity: {f}" for f in par4["failed"]]
    out["seconds"] = time.perf_counter() - t_phase
    out["failed"] = failed
    emit({k: v for k, v in out.items() if k != "records"})
    if failed:
        raise AssertionError(f"vlm phase failed: {failed}")
    return out


# ---------------------------------------------------------------------------
# the hybrid (zamba2-7b) and encoder-decoder (whisper-medium) serve steps
# ---------------------------------------------------------------------------

STEPS_DECODE = 64        # FullKV decode steps from an empty state
STEPS_HELD = 16          # of them, the last held to the teacher-forced forward
HYBRID_ARCH, HYBRID_PROMPT = "zamba2-7b", 512
ENCDEC_ARCH, ENCDEC_PROMPT = "whisper-medium", 256


def steps_pool(mc, tk, tokens) -> dict:
    """The ThinKV step's batch for 4 requests at position
    ``STEPS_DECODE`` on ``mc``'s attention layers: the records' pool
    (``test_torch_steps_record.thinkv_batch`` from ``SEED``: bits 2/4/8
    mixed, slots VALID, evicted or free, bf16 buffers) moved to
    ``tokens``' device, fed ``tokens``."""
    import test_torch_steps_record as SR
    batch = {k: SR.to_torch(v, k, tokens.device) for k, v in
             SR.thinkv_batch(mc, tk, SEED, 4, STEPS_DECODE).items()}
    batch["tokens"] = tokens
    return batch


def fullkv_decode_run(mc, params, prompts, extra: dict):
    """``STEPS_DECODE`` FullKV decode steps from an empty state over the
    prompts' first tokens (``test_torch_steps_record.fullkv_steps``): the
    steps' logits [B, n, V], the final batch, the seconds and the step."""
    import torch
    import test_torch_steps_record as SR
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, fb, step = SR.fullkv_steps(mc, params,
                                       prompts[:, :STEPS_DECODE], extra)
    torch.cuda.synchronize()
    return logits, fb, time.perf_counter() - t0, step


def greedy_check(got, want):
    """Greedy tokens of two logits [B, V], request by request: a request
    is held (its tokens equal) where ``want``'s top-2 margin exceeds twice
    the request's own largest logit gap, and exempt otherwise.  Returns
    the held requests whose tokens differ and the exempt count."""
    gap = (got - want).abs().amax(-1)
    top2 = want.topk(2, -1).values
    held = (top2[:, 0] - top2[:, 1]) > 2 * gap
    differ = held & (got.argmax(-1) != want.argmax(-1))
    return differ.nonzero().flatten().tolist(), int((~held).sum())


def thinkv_step_check(mc, tk, params, batch, dev) -> dict:
    """The ThinKV step of a config on the card: launch counts zeroed just
    before the kernel backend's step and read just after (K1 once per
    attention layer, nothing else); held against the same step over K1's
    plain version (logits <= ATOL, greedy tokens equal, buffers within one
    bf16 step or ATOL, buf_len exact) and beside the reference backend
    from the same state (its pool dequantized to bf16 as the reference's:
    the logits gap and buffers reported, greedy tokens equal for every
    request whose top-2 margin there exceeds twice its own gap,
    ``greedy_check``); K1 at the step's shape against its plain version
    with its times and bound (``check_serve_step_k1``); the step's device
    time."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import serve_step as SS
    n_attn = mc.num_attention_layers()
    step_k = SS.make_decode_step_thinkv(mc, tk, backend="kernel")
    ops.reset_launches()
    out_k = step_k(params, batch)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    failed = []
    if launches["ct_paged_attention_fused"] != n_attn or any(
            launches[k] for k in launches if k != "ct_paged_attention_fused"):
        failed.append(f"launches {launches}, one K1 per attention layer "
                      f"({n_attn}) expected")
    with plain_k1():
        out_p = step_k(params, batch)
    out_r = SS.make_decode_step_thinkv(mc, tk, backend="reference")(
        params, batch)
    ref_differ, ref_exempt = greedy_check(out_k[0], out_r[0])
    rec = {"k1_launches": launches["ct_paged_attention_fused"],
           "launches": launches,
           "greedy_tokens": out_k[0].argmax(-1).tolist(),
           "logits_vs_plain_k1": max_err(out_k[0], out_p[0]),
           "tokens_equal_plain_k1": bool(torch.equal(
               out_k[0].argmax(-1), out_p[0].argmax(-1))),
           "buffers_vs_plain_k1": max(max_err(out_k[i], out_p[i])
                                      for i in (-3, -2)),
           "buffers_vs_plain_k1_over_bar": max(
               bf16_steps_over(out_k[i], out_p[i]) for i in (-3, -2)),
           "logits_vs_reference_backend": max_err(out_k[0], out_r[0]),
           "tokens_equal_reference_backend": bool(torch.equal(
               out_k[0].argmax(-1), out_r[0].argmax(-1))),
           "reference_tokens_differ_where_held": ref_differ,
           "reference_tokens_exempt": ref_exempt,
           "buffers_vs_reference_backend_over_bar": max(
               bf16_steps_over(out_k[i], out_r[i]) for i in (-3, -2))}
    if len(out_k) == 6:                 # the hybrid's states
        rec["states_vs_plain_k1"] = max(max_err(out_k[i], out_p[i])
                                        for i in (1, 2))
    if not all(torch.isfinite(t).all() for t in (out_k[0], out_r[0])):
        failed.append("non-finite ThinKV logits")
    if not rec["logits_vs_plain_k1"] <= ATOL:
        failed.append(f"logits {rec['logits_vs_plain_k1']} from the plain "
                      f"K1's > {ATOL}")
    if not rec["tokens_equal_plain_k1"]:
        failed.append("greedy tokens differ from the plain K1's")
    # the backends' logits differ by the reference's bf16 dequantization
    # (reported, not held to ATOL)
    if ref_differ:
        failed.append(f"greedy tokens of requests {ref_differ} differ from "
                      f"the reference backend's")
    if not rec["buffers_vs_plain_k1_over_bar"] <= 1:
        failed.append(f"buffers {rec['buffers_vs_plain_k1_over_bar']} x "
                      f"(one bf16 step or {ATOL}) from the plain K1's")
    if not torch.equal(out_k[-1], batch["buf_len"] + 1):
        failed.append(f"buf_len {out_k[-1]} after {batch['buf_len']}")
    prof = profile_window(lambda: step_k(params, batch))
    rec.update(thinkv_step_device_ms=prof["device_busy_ms"],
               thinkv_step_window_ms=prof["window_ms"],
               thinkv_step_k1_ms=prof["kernel_groups"]["K1"]["ms"],
               k1_serve_step=check_serve_step_k1(dev, mc, batch),
               failed=failed)
    return rec


def record_replay(name: str, dev) -> dict:
    """The JAX record of a family's serve steps
    (``tests/golden/torch_{name}_steps.npz``) on the kernel backend."""
    import test_torch_steps_record as SR
    res = SR.replay(SR.load(os.path.join(
        HERE, "tests", "golden", f"torch_{name}_steps.npz")), "kernel", dev)
    if res["failed"]:
        raise AssertionError(f"{name} record: {res['failed']}")
    return res


def check_d112_kernels(dev, tk) -> dict:
    """K2 and K3 at head_dim 112, zamba2-7b's shared-block shape (32 q / 32
    kv heads, GQ 1, blocks of ``tk.block_size``, the default budget's NB):
    K2 at a big chunk's 128 query rows and a g-chunk's G over one slot's
    pool, K3 at S 128 and at S G with 11 valid keys, each against its plain
    version (<= ``ATOL``) with its times, bound and, for K3, SDPA's time.
    No serving path of either package reaches them (the reference prefills
    zamba2 with plain attention, and no engine serves it)."""
    import torch
    from repro_torch.configs import get_config
    mc = get_config(HYBRID_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED + 112)
    H, D, BS, G = mc.num_kv_heads, mc.head_dim, tk.block_size, tk.group_size
    gq = mc.num_heads // H
    NB = int(tk.token_budget * 2) // BS
    c = pool_case(gen, dev, 1, 1, H, D, BS, NB, NB, G, gq)
    recs = {
        "big chunk": k2_record(gen, dev, c, 128 * gq, "zamba2 big chunk: "),
        "g-chunk": k2_record(gen, dev, c, G * gq, "zamba2 g-chunk: "),
        "K3 big chunk": k3_record(gen, dev, 128, None, mc.num_heads, H, D,
                                  "zamba2 big chunk: "),
        "K3 g-chunk": k3_record(gen, dev, G, 11, mc.num_heads, H, D,
                                "zamba2 g-chunk: ")}
    bad = {k: r["max_abs_err"] for k, r in recs.items()
           if not r["max_abs_err"] <= ATOL}
    over = [k for k, r in recs.items() if r["bound_share"] > 1]
    if bad or over:
        raise AssertionError(f"K2 / K3 at head_dim 112: errors over {ATOL} "
                             f"{bad}, a bound above the measured time "
                             f"{over}")
    return recs


def hybrid_phase(dev, tk) -> dict:
    """zamba2-7b (a Mamba-2 backbone of 81 layers, ONE shared attention
    block after every 6th: 13 invocations of 32 x 112 heads) at full width
    and depth, random f32 weights from ``SEED`` (~6.8 B parameters),
    through ``serving/serve_step.py``: the prefill step over 4 prompts of
    ``HYBRID_PROMPT`` tokens; ``STEPS_DECODE`` FullKV decode steps from an
    empty state over the prompts' first tokens, the last ``STEPS_HELD``
    held to the teacher-forced forward (rtol = atol = ``SSM_TOL``); the
    ThinKV step on a seeded pool with the FullKV run's Mamba-2 states
    (``thinkv_step_check``: K1 at D 112 once per invocation, 13 a step);
    the hybrid record on the kernel backend; first K2 and K3 at the shared
    block's head_dim 112 (``check_d112_kernels``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import factory, hybrid
    from repro_torch.serving import serve_step as SS
    t_phase = time.perf_counter()
    d112 = check_d112_kernels(dev, tk)
    mc = get_config(HYBRID_ARCH)
    model = factory.build_model(mc)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = torch.from_numpy(rng.integers(
        0, mc.vocab_size, (4, HYBRID_PROMPT))).to(dev)
    prefill = SS.make_prefill_step(model, mc)
    prefill(params, {"tokens": prompts[:, :16]})            # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    lg = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    failed = []
    if lg.shape != (4, mc.vocab_size) or not torch.isfinite(lg).all():
        failed.append(f"bad prefill logits {tuple(lg.shape)}")
    if any(ops.LAUNCHES.values()):
        failed.append(f"the prefill launched {ops.LAUNCHES}: no kernel "
                      f"expected (Mamba-2 and the prefill attention are "
                      f"plain torch, as in the reference)")
    st = hybrid.init_decode_state(mc, 4, dev)
    dec, fb, fullkv_s, step_f = fullkv_decode_run(
        mc, params, prompts, {"conv_state": st.conv, "ssm_state": st.h})
    tf, _ = hybrid.logits_fn(params, {"tokens": prompts[:, :STEPS_DECODE]},
                             mc)
    held = {"max_abs_diff": max_err(dec[:, -STEPS_HELD:],
                                    tf[:, -STEPS_HELD:]),
            "over_bar": over_bar(dec[:, -STEPS_HELD:], tf[:, -STEPS_HELD:],
                                 SSM_TOL),
            "tokens_equal": bool(torch.equal(dec.argmax(-1),
                                             tf.argmax(-1)))}
    if not held["over_bar"] <= 1:
        failed.append(f"FullKV decode vs the forward {held}")
    del tf
    last = {**fb, "tokens": dec[:, -1].argmax(-1),
            "positions": torch.full((4,), STEPS_DECODE - 1,
                                    dtype=torch.int32, device=dev),
            "cache_len": torch.full((4,), STEPS_DECODE - 1,
                                    dtype=torch.int32, device=dev)}
    fullkv_prof = profile_window(lambda: step_f(params, last))
    batch = steps_pool(mc, tk, dec[:, -1].argmax(-1))
    batch.update(conv_state=fb["conv_state"], ssm_state=fb["ssm_state"])
    del fb, last, dec
    chk = thinkv_step_check(mc, tk, params, batch, dev)
    failed += chk.pop("failed")
    state_mb = sum(t[0].numel() * t[0].element_size()
                   for t in (batch["conv_state"], batch["ssm_state"])) / 1e6
    kv = {"thinkv_pool": kv_bytes_per_request(batch)[0],
          "fullkv_bf16": fullkv_bytes(mc, HYBRID_PROMPT + STEPS_DECODE)}
    del batch
    out = {"phase": "hybrid", "model": mc.name, "layers": mc.num_layers,
           "attention_invocations": mc.num_attention_layers(),
           "heads": mc.num_heads, "head_dim": mc.head_dim,
           "init_s": init_s, "weights_gb": sum(
               p.numel() * p.element_size()
               for p in params.parameters()) / 1e9,
           "prefill": {"prompts": 4, "prompt_len": HYBRID_PROMPT,
                       "seconds": prefill_s,
                       "tok_s": 4 * HYBRID_PROMPT / prefill_s},
           "fullkv": {"steps": STEPS_DECODE, "seconds": fullkv_s,
                      "ms_per_step": 1e3 * fullkv_s / STEPS_DECODE,
                      "step_device_ms": fullkv_prof["device_busy_ms"],
                      "step_window_ms": fullkv_prof["window_ms"],
                      "held_last_16": held},
           "thinkv": chk, "kernels_d112": d112,
           "mamba_state_mb_per_request": state_mb,
           "kv_bytes_per_request": kv,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["record"] = record_replay("hybrid", dev)
    out["seconds"] = time.perf_counter() - t_phase
    out["failed"] = failed
    emit(out)
    if failed:
        raise AssertionError(f"hybrid phase failed: {failed}")
    return out


def encdec_phase(dev, tk) -> dict:
    """whisper-medium (24 encoder and 24 decoder layers, 16 x 64 heads,
    1500 stub frames) at full width and depth, random f32 weights from
    ``SEED``, through ``serving/serve_step.py``: the prefill step (the
    encoder over frames [4, 1500, 1024] from numpy seed ``SEED``, the
    decoder over 4 prompts of ``ENCDEC_PROMPT`` tokens); the cross KV from
    ``cross_caches`` TBQ'd at 4 bits through K4's direct entry
    (``ops.tbq_group_quant``, one launch) bit-exact to its plain version,
    timed against its bound; ``STEPS_DECODE`` FullKV decode steps from an
    empty self-cache with the f32 cross KV, the last ``STEPS_HELD`` held
    to the teacher-forced decoder (rtol = atol = ``SSM_TOL``); the ThinKV
    step on a seeded pool with the TBQ'd cross KV (``thinkv_step_check``:
    K1 at D 64 once per decoder layer); the encdec record on the kernel
    backend."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import encdec, factory
    from repro_torch.serving import serve_step as SS
    t_phase = time.perf_counter()
    mc = get_config(ENCDEC_ARCH)
    model = factory.build_model(mc)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(rng.standard_normal(
        (4, mc.encoder_seq, mc.d_model)).astype(np.float32)).to(dev)
    prompts = torch.from_numpy(rng.integers(
        0, mc.vocab_size, (4, ENCDEC_PROMPT))).to(dev)
    prefill = SS.make_prefill_step(model, mc)
    prefill(params, {"tokens": prompts[:, :16], "frames": frames})
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    lg = prefill(params, {"tokens": prompts, "frames": frames})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    failed = []
    if lg.shape != (4, mc.vocab_size) or not torch.isfinite(lg).all():
        failed.append(f"bad prefill logits {tuple(lg.shape)}")
    if any(ops.LAUNCHES.values()):
        failed.append(f"the prefill launched {ops.LAUNCHES}: no kernel "
                      f"expected")
    t0 = time.perf_counter()
    enc = encdec.encode(params, frames, mc)
    ck, cv = (c.transpose(0, 1).contiguous()
              for c in encdec.cross_caches(params, enc, mc))
    torch.cuda.synchronize()
    cross_s = time.perf_counter() - t0

    # K4's direct entry over the cross KV: [B·L·T·H, 64] f32 at 4 bits
    cross = {}
    ops.reset_launches()
    for n, c in (("k", ck), ("v", cv)):
        x = c.reshape(-1, mc.head_dim)
        codes, scales = ops.tbq_group_quant(x, 4)
        cross[f"cross_{n}_codes"] = codes.view(c.shape)
        cross[f"cross_{n}_scales"] = scales.view(*c.shape[:-1], -1)
    torch.cuda.synchronize()
    k4_launches = ops.LAUNCHES["group_quant"]
    if k4_launches != 2:
        failed.append(f"K4 launched {k4_launches} times for the cross KV, "
                      f"2 expected")
    x = ck.reshape(-1, mc.head_dim)
    assert_same_quant((cross["cross_k_codes"].reshape(x.shape),
                       cross["cross_k_scales"].reshape(x.shape[0], -1)),
                      ref.group_quant_ref(x, 4, 16), "cross KV")
    k4 = kernel_record(
        "group_quant", "group_quant.cu", "group_quant.py:70",
        f"whisper cross K: f32 [{x.shape[0]}, {x.shape[1]}] bits 4", 0.0,
        lambda: ops.tbq_group_quant(x, 4),
        lambda: ref.group_quant_ref(x, 4, 16),
        bound(nbytes(x) + x.numel() + x.numel() // 16 * 2, 0.0),
        plain_iters=1, launches=k4_launches)
    del x

    dec, fb, fullkv_s, step_f = fullkv_decode_run(
        mc, params, prompts, {"cross_k": ck, "cross_v": cv})
    tf = encdec.decode_train(params, prompts[:, :STEPS_DECODE], enc, mc)
    held = {"max_abs_diff": max_err(dec[:, -STEPS_HELD:],
                                    tf[:, -STEPS_HELD:]),
            "over_bar": over_bar(dec[:, -STEPS_HELD:], tf[:, -STEPS_HELD:],
                                 SSM_TOL),
            "tokens_equal": bool(torch.equal(dec.argmax(-1),
                                             tf.argmax(-1)))}
    if not held["over_bar"] <= 1:
        failed.append(f"FullKV decode vs the forward {held}")
    del tf, enc
    last = {**fb, "tokens": dec[:, -1].argmax(-1),
            "positions": torch.full((4,), STEPS_DECODE - 1,
                                    dtype=torch.int32, device=dev),
            "cache_len": torch.full((4,), STEPS_DECODE - 1,
                                    dtype=torch.int32, device=dev)}
    fullkv_prof = profile_window(lambda: step_f(params, last))
    del fb, last, ck, cv
    batch = steps_pool(mc, tk, dec[:, -1].argmax(-1))
    batch.update(cross)
    del dec, cross
    chk = thinkv_step_check(mc, tk, params, batch, dev)
    failed += chk.pop("failed")
    kv = {"thinkv_pool": kv_bytes_per_request(batch)[0],
          "fullkv_bf16": fullkv_bytes(mc, ENCDEC_PROMPT + STEPS_DECODE)}
    kv["cross_tbq"] = sum(batch[k][0].numel() * batch[k].element_size()
                          for k in ("cross_k_codes", "cross_v_codes",
                                    "cross_k_scales", "cross_v_scales"))
    kv["cross_f32"] = 2 * mc.num_layers * mc.encoder_seq * \
        mc.num_kv_heads * mc.head_dim * 4
    del batch
    out = {"phase": "encdec", "model": mc.name,
           "layers": [mc.encoder_layers, mc.num_layers],
           "heads": mc.num_heads, "head_dim": mc.head_dim,
           "frames": mc.encoder_seq, "init_s": init_s,
           "weights_gb": sum(p.numel() * p.element_size()
                             for p in params.parameters()) / 1e9,
           "prefill": {"prompts": 4, "prompt_len": ENCDEC_PROMPT,
                       "seconds": prefill_s,
                       "tok_s": 4 * ENCDEC_PROMPT / prefill_s},
           "cross_kv_s": cross_s, "k4_cross": k4,
           "fullkv": {"steps": STEPS_DECODE, "seconds": fullkv_s,
                      "ms_per_step": 1e3 * fullkv_s / STEPS_DECODE,
                      "step_device_ms": fullkv_prof["device_busy_ms"],
                      "step_window_ms": fullkv_prof["window_ms"],
                      "held_last_16": held},
           "thinkv": chk, "kv_bytes_per_request": kv,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["record"] = record_replay("encdec", dev)
    out["seconds"] = time.perf_counter() - t_phase
    out["failed"] = failed
    emit(out)
    if failed:
        raise AssertionError(f"encdec phase failed: {failed}")
    return out


# ---------------------------------------------------------------------------
# tp: tensor-parallel serving over kv heads, 2 gloo ranks on the one card
# ---------------------------------------------------------------------------

TP_RANKS = 2
TP_STEPS = 16            # greedy trips after inserting the portable prefix


def logits_digest(logits: dict) -> str:
    """sha256 of every request's recorded logits, in arrival order."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for a in sorted(logits):
        h.update(str(a).encode())
        h.update(np.ascontiguousarray(logits[a]).tobytes())
    return h.hexdigest()


def tp_run_record(eng, done, rank: int) -> dict:
    """A rank's ``run_record``: rank 0 carries the logits, every rank
    their digest."""
    rec = run_record(eng, done)
    rec["logits_sha256"] = logits_digest(rec["logits"])
    if rank:
        del rec["logits"]
    return rec


def tp_checks(got: dict, want: dict, what: str) -> list:
    """A rank's run against the one-process run: tokens, counters and
    audit equal, and the logits bit-identical (rank 0's compared, the
    others' digests)."""
    import numpy as np
    bad = [f"{what}: {k}" for k in ("outputs", "counters", "audit")
           if got[k] != want[k]]
    if got["logits_sha256"] != logits_digest(want["logits"]):
        diff = max((float(np.abs(got["logits"][a] - want["logits"][a]).max())
                    for a in want["logits"]), default=0.0) \
            if "logits" in got and set(got["logits"]) == \
            set(want["logits"]) else None
        bad.append(f"{what}: logits not bit-identical (max |diff| {diff})")
    return bad


def tp_serve_rank(mesh, mc, prompts, max_new) -> dict:
    """One rank of the serve leg: r1-llama-8b at full width and depth, the
    serve phase's traffic on its share of the kv heads (kernel backend),
    launch counts zeroed just before and read just after; then the
    entry-point audit, the time of the tick's one gather and the rank's
    peak memory."""
    import torch
    from repro_torch.config import ServeConfig, ThinKVConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.models.lm import init_params
    from repro_torch.serving.engine import ThinKVEngine
    dev = mesh.device
    t0 = time.perf_counter()
    params = init_params(mc, SEED, dev)
    init_s = time.perf_counter() - t0
    cfg = ServeConfig(model=mc, thinkv=ThinKVConfig(), max_seqs=4)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    SH.reset_collectives()
    eng, done = serve(ThinKVEngine, cfg, params, prompts, max_new, "kernel",
                      dev, mesh=mesh)
    launches = dict(ops.LAUNCHES)
    collectives = {f"{k}({d})": n for (k, d), n in SH.COLLECTIVES.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    m = eng.metrics
    rec = tp_run_record(eng, done, mesh.rank)
    rep = eng.audit_compiled()
    x = torch.randn((mc.num_layers, 4, mc.num_heads // mesh.size,
                     mc.head_dim), device=dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    SH.gather_heads(x, mesh, 2)
    sync()
    t0 = time.perf_counter()
    for _ in range(20):
        SH.gather_heads(x, mesh, 2)
        sync()
    gather_ms = (time.perf_counter() - t0) / 20 * 1e3
    rec.update(rank=mesh.rank, init_s=init_s, launches=launches,
               collectives=collectives, prefill_s=m["prefill_s"],
               decode_s=m["decode_s"], wall_s=m["wall_s"],
               ms_per_tick=1e3 * m["decode_s"] / m["ticks"],
               layers=mc.num_layers, prefill_chunks=m["prefill_chunks"],
               prefill_big_chunks=m["prefill_big_chunks"],
               peak_mem_gb=peak, gather_ms=gather_ms,
               gather_shape=list(x.shape), audit_ok=rep.ok,
               audit_launches={k: e.census.launches
                               for k, e in rep.entries.items()},
               audit_violations=[str(v) for v in rep.violations],
               host_syncs=rep.host_syncs())
    return rec


def tp_launch_failures(rec: dict, mc, prompts, max_new, G: int) -> list:
    """K1 once per tick, K2 and K3 once per layer per chunk, K4 once per
    commit, and the rank's entry-point audit clean."""
    launches, c = rec["launches"], rec["counters"]
    chunks = (rec["prefill_chunks"] + rec["prefill_big_chunks"]) \
        * mc.num_layers
    commits = sum((len(p) + max_new - 1) // G for p in prompts)
    want = {"ct_paged_attention_fused": c["ticks"],
            "ct_paged_attention_batched": chunks, "flash_prefill": chunks,
            "group_quant": commits}
    bad = [f"rank {rec['rank']}: {k} launched {launches.get(k, 0)}, want "
           f"{n}" for k, n in want.items() if launches.get(k, 0) != n]
    if not rec["audit_ok"]:
        bad.append(f"rank {rec['rank']}: audit {rec['audit_violations']}")
    return bad


def tp_pressure_rank(mesh, mc, prompts, priorities, pool_blocks, max_new,
                     prefix_prompt) -> dict:
    """One rank of the pressure leg: the pressure phase's traffic, pool and
    prefix cache at its depth on both backends, then a prefix prefilled on
    the kernel backend's engine and detached (its spill holds every
    head)."""
    from repro_torch.config import ServeConfig, ThinKVConfig
    from repro_torch.kernels import ops
    from repro_torch.models.lm import init_params
    from repro_torch.serving.engine import ThinKVEngine
    params = init_params(mc, SEED, mesh.device)
    cfg = ServeConfig(model=mc, thinkv=ThinKVConfig(
        token_budget=PRESSURE_BUDGET), max_seqs=4)
    out, engines = {}, {}
    for backend in ("kernel", "reference"):
        ops.reset_launches()
        eng = ThinKVEngine(cfg, params=params, backend=backend,
                           device=mesh.device, record_logits=True,
                           pool_blocks=pool_blocks, prefix_cache=True,
                           mesh=mesh)
        eng.submit(prompts, max_new_tokens=max_new, priorities=priorities)
        t0 = time.perf_counter()
        done = eng.run()
        rec = tp_run_record(eng, done, mesh.rank)
        rec.update(seconds=time.perf_counter() - t0,
                   launches=dict(ops.LAUNCHES),
                   ms_per_tick=1e3 * eng.metrics["decode_s"]
                   / max(eng.metrics["ticks"], 1))
        out[backend], engines[backend] = rec, eng
    eng = engines["kernel"]
    out["prefix"] = eng.detach_prefix(eng.prefill(prefix_prompt, 0))
    return out


def prefix_steps(eng, prefix, steps: int):
    """Insert a portable prefix into slot 1 of an idle engine and run
    ``steps`` greedy trips: (tokens, logits [steps, V]) of slot 1."""
    import numpy as np
    import torch
    if not eng.insert(prefix, 1):
        raise AssertionError("the portable prefix does not fit the pool")
    active = np.zeros(eng.cfg.max_seqs, bool)
    active[1] = True
    feed = torch.as_tensor(eng._feed, device=eng.device)
    toks, lgs = [], []
    for _ in range(steps):
        feed, lg = eng._trip(active, feed)
        toks.append(int(feed[1]))
        lgs.append(lg[1].float().cpu().numpy())
    eng.free_resource(1)
    eng._check_fails()
    eng.audit_pool()
    return toks, np.stack(lgs)


def spill_bits(st) -> dict:
    """A spill's cache fields and its planes over the mapped blocks (an
    unmapped block's planes are whatever physical block 0 held, and are
    never restored)."""
    import torch
    mapped = torch.as_tensor(st.mapped)
    out = {f: getattr(st.cache, f) for f in st.cache.FIELDS}
    out.update({f"view{i}": p[mapped] for i, p in enumerate(st.view)},
               mapped=mapped)
    return {k: (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
            for k, t in out.items()}


def tp_pressure_leg(engine_cls, params, mc, dev, prs) -> dict:
    """The pressure phase's traffic on 2 ranks (its depth, ``CUT_LAYERS``),
    both backends, each rank held bit-identical to the pressure phase's
    one-process run of that backend (its 18 preemptions, prefix hits and
    COW faults included); then a prefix detached on 2 ranks equals the one
    detached here on one rank, and inserted into this one-rank engine it
    decodes the same tokens and logits."""
    import torch
    from repro_torch.config import ServeConfig, ThinKVConfig
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    prompts, priorities, pool_blocks = prs["traffic"]
    ranks = run_ranks(tp_pressure_rank, TP_RANKS, dev.type, mc, prompts,
                      priorities, pool_blocks, 64, prompts[0], timeout=900)
    failed = []
    for r, got in enumerate(ranks):
        for backend in ("kernel", "reference"):
            failed += tp_checks(got[backend], prs["runs"][backend],
                                f"pressure {backend} rank {r}")
        k = got["kernel"]["launches"]
        if k["ct_paged_attention_fused"] != got["kernel"]["counters"][
                "ticks"] or k["group_quant"] != got["kernel"]["counters"][
                    "commits"]:
            failed.append(f"rank {r}: launches {k}")
    eng = engine_cls(ServeConfig(model=mc, thinkv=ThinKVConfig(
        token_budget=PRESSURE_BUDGET), max_seqs=4), params=params,
        backend="kernel", device=dev, pool_blocks=pool_blocks)
    one = eng.detach_prefix(eng.prefill(prompts[0], 0))
    two = ranks[0]["prefix"]
    want, got = spill_bits(one.state), spill_bits(two.state)
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad or one.first_token != two.first_token:
        failed.append(f"detached prefix differs: {bad}")
    t1, l1 = prefix_steps(eng, one, TP_STEPS)
    t2, l2 = prefix_steps(eng, two, TP_STEPS)
    if t1 != t2 or not (l1 == l2).all():
        failed.append("the 2-rank prefix decodes otherwise on one rank")
    r0 = ranks[0]
    return {"layers": mc.num_layers, "ranks": TP_RANKS,
            "counters": {b: {k: r0[b]["counters"][k] for k in (
                "preemptions", "resumes", "prefix_hits", "cow_faults",
                "ticks", "commits")} for b in ("kernel", "reference")},
            "seconds_per_run": {b: [g[b]["seconds"] for g in ranks]
                                for b in ("kernel", "reference")},
            "ms_per_tick": {b: [g[b]["ms_per_tick"] for g in ranks]
                            for b in ("kernel", "reference")},
            "launches": r0["kernel"]["launches"],
            "prefix_tokens": len(prompts[0]), "prefix_steps": TP_STEPS,
            "prefix_identical": t1 == t2, "failed": failed,
            "seconds": time.perf_counter() - t0}


def tp_serve_leg(mc, prompts, max_new, srv, dev) -> dict:
    """The serve phase's traffic on 2 ranks at full width and depth,
    each rank bit-identical to the serve phase's one-process run (tokens,
    every logit, counters, audit), with its launch contracts."""
    import torch
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    held_gb = torch.cuda.memory_allocated() / 1e9 \
        if dev.type == "cuda" else None
    ranks = run_ranks(tp_serve_rank, TP_RANKS, dev.type, mc, prompts,
                      max_new, timeout=900)
    failed = []
    for r, got in enumerate(ranks):
        failed += tp_checks(got, srv["run"], f"serve rank {r}")
        failed += tp_launch_failures(got, mc, prompts, max_new, 16)
    keys = ("init_s", "prefill_s", "decode_s", "wall_s", "ms_per_tick",
            "peak_mem_gb", "gather_ms", "collectives", "host_syncs")
    return {"layers": mc.num_layers, "ranks": TP_RANKS,
            "main_process_gb_on_card": held_gb,
            "per_rank": [{k: g[k] for k in keys} for g in ranks],
            "one_process_ms_per_tick": srv["ms_per_tick"],
            "one_process_peak_mem_gb": srv["peak_mem_gb"],
            "gather_shape": ranks[0]["gather_shape"],
            "launches": ranks[0]["launches"],
            "audit_launches": ranks[0]["audit_launches"],
            "failed": failed, "seconds": time.perf_counter() - t0}


def audit_phase(engine_cls, params, mc, dev) -> dict:
    """The entry-point audit (``analysis.audit_engine``) at the serve
    shapes, one rank, both backends, 8 ticks per dispatch and the drift
    probe on: launches per kernel held to the contracts (and on the card
    equal to ``ops.LAUNCHES``), no fp64, no collective; host syncs per
    entry point reported.  Then the kernel backend sampling as the
    ``sampled`` phase does: its tick and pack make fp64 only where their
    contracts name it (``SAMPLED_FP64``).  Also the standalone K3 entry."""
    from repro_torch.analysis import audit_engine
    from repro_torch.analysis.census import fp64_origin
    from repro_torch.analysis.contracts import (SAMPLED_FP64,
                                                audit_flash_prefill)
    from repro_torch.config import ServeConfig, ThinKVConfig
    t0 = time.perf_counter()
    out, failed = {}, []
    for backend, temp in (("kernel", 0.0), ("reference", 0.0),
                          ("kernel", SAMPLED_T)):
        eng = engine_cls(ServeConfig(model=mc, thinkv=ThinKVConfig(),
                                     max_seqs=4, temperature=temp,
                                     top_p=SAMPLED_TOP_P if temp else 1.0),
                         params=params, backend=backend, device=dev,
                         ticks_per_dispatch=8, drift_probe=True)
        rep = audit_engine(eng)
        del eng
        if temp:
            backend = "kernel_sampled"
            origins = {fp64_origin(e) for k in ("_tick_fn", "_megatick_fn")
                       for e in rep.entries[k].census.fp64}
            if origins != set(SAMPLED_FP64):
                failed.append(f"sampled fp64 from {sorted(origins)}")
        out[backend] = {
            "ok": rep.ok, "violations": [str(v) for v in rep.violations],
            "entries": {k: {"launches": e.census.launches,
                            "trips": e.census.trips,
                            "commits": e.census.commits,
                            "fp64": len(e.census.fp64),
                            "host_syncs": e.census.host_syncs}
                        for k, e in sorted(rep.entries.items())}}
        failed += [f"{backend}: {v}" for v in out[backend]["violations"]]
        failed += [f"{backend} {k}: dispatches {e.census.launches} but "
                   f"launches {e.census.device_launches}"
                   for k, e in rep.entries.items()
                   if e.census.launches != e.census.device_launches]
    fp = audit_flash_prefill(device=dev)
    if not fp.ok or fp.census.device_launches != {"flash_prefill": 1}:
        failed.append(f"flash_prefill: {fp.census.launches}")
    gc.collect()
    rec = {"phase": "audit", "layers": mc.num_layers, **out,
           "failed": failed, "seconds": time.perf_counter() - t0}
    emit(rec)
    emit({"host_syncs_per_entry_point": {
        b: {k: sum(e["host_syncs"].values())
            for k, e in out[b]["entries"].items()} for b in out}})
    if failed:
        raise AssertionError(f"audit phase failed: {failed}")
    return rec


TRAIN_ARCH = "r1-llama-8b"
TRAIN_LAYERS = 2           # of r1-llama-8b's 32: 1.487 G parameters
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8
TRAIN_RTOL = 1e-4          # step 1's loss and gradient norm vs the f64 run
TRAIN_GRAD_REL = 1e-4      # each gradient leaf, of that leaf's largest |g|
TRAIN_RESUME_RTOL = 1e-4   # the reference's bar (test_fault_tolerance.py)


def _train_shape(seq: int, batch: int):
    """An input shape of the train kind (``config.InputShape``)."""
    from repro_torch.config import InputShape
    return InputShape("train", seq, batch, "train")


def train_f64_errors(g32: dict, g64: dict) -> dict:
    """Per gradient leaf: max |g32 - g64| over the leaf's largest |g64|."""
    out = {}
    for k, w in g64.items():
        out[k] = float((g32[k].double() - w).abs().max()
                       / w.abs().max().clamp_min(1e-300))
    return out


def train_resume_check(dev, tmp: str) -> dict:
    """The reference's resume case at smoke size on the card: yi-6b smoke,
    8 steps with checkpoints every 2; a run failing at step 5 and restarted
    ends on the uninterrupted run's last loss within 1e-4 relative."""
    from repro_torch.config import OptimizerConfig, TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.ft.failures import FailureInjector, InjectedFailure
    from repro_torch.training.trainer import Trainer
    m = get_smoke_config("yi-6b")
    cfg = TrainConfig(model=m, optimizer=OptimizerConfig(
        lr=1e-3, warmup_steps=2, decay_steps=8), seq_len=16, global_batch=4,
        steps=8, checkpoint_every=2, keep_checkpoints=2,
        checkpoint_dir=os.path.join(tmp, "ckpt"))

    def data_fn(start):
        it = lm_batches(m.vocab_size, 4, 16, seed=7)
        for _ in range(start):
            next(it)
        return it
    ref = Trainer(dataclasses.replace(cfg, checkpoint_dir=os.path.join(
        tmp, "ref")), data_fn, device=dev).run()
    failed = False
    try:
        Trainer(cfg, data_fn, failure_injector=FailureInjector(
            fail_at_steps=(5,)), device=dev).run()
    except InjectedFailure:
        failed = True
    res = Trainer(cfg, data_fn, device=dev).run()
    return {"injected": failed, "resumed_from": res.resumed_from,
            "final_step": res.final_step, "last_loss": res.losses[-1],
            "uninterrupted_last_loss": ref.losses[-1],
            "rel_err": abs(res.losses[-1] - ref.losses[-1])
            / abs(ref.losses[-1])}


def train_phase(dev) -> dict:
    """Single-card training at r1-llama-8b's full width and 2 of its 32
    layers (random f32 weights from ``SEED``, TF32 off), ``lm_batches`` at
    batch 8 and sequence 512, remat on.  Step 1's loss, gradient norm and
    every gradient leaf held to the same step evaluated in f64 (an f64
    copy of the weights through the same code), and the step in two
    microbatches held to it too; then ``TRAIN_STEPS`` AdamW steps (default
    settings) timed; no kernel of the port may launch.  Then the JAX train
    record replayed, the resume check at smoke size and the train step's
    contract on the card (``audit_train_step``: no launch, no collective,
    no fp64)."""
    import tempfile

    import numpy as np
    import torch

    import test_torch_train_record as TRR
    from repro_torch.analysis import audit_train_step
    from repro_torch.config import OptimizerConfig
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.device import set_f32_numerics
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.factory import build_model
    from repro_torch.models.losses import chunk_size
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import (batch_grads,
                                                 make_train_step,
                                                 value_and_grad)
    from repro_torch.training.trainer import batch_to
    t0 = time.perf_counter()
    set_f32_numerics()
    mc = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    model = build_model(mc)
    params = model.init_params(SEED, dev).requires_grad_(True)
    n_params = sum(p.numel() for p in params.parameters())
    # parameters in products (the embedding is a gather, norms are scales)
    n_matmul = sum(p.numel() for n, p in params.named_parameters()
                   if p.dim() >= 2 and n != "embedding")
    data = lm_batches(mc.vocab_size, batch, seq, seed=SEED)
    batches = [batch_to(next(data), dev) for _ in range(TRAIN_STEPS)]
    loss_fn = lambda p, b: model.loss(p, b, mc, remat=True)  # noqa: E731
    failed = []
    launches0 = dict(ops.LAUNCHES)

    (l32, _), g32 = value_and_grad(loss_fn, params, batches[0])
    (lmb, _), gmb = batch_grads(loss_fn, params, batches[0], 2)
    p64 = lm.LM(mc, dev, torch.float64)
    with torch.no_grad():
        for k, x in p64.named_parameters():
            x.copy_(getattr(params, k))
    p64.requires_grad_(True)
    (l64, _), g64 = value_and_grad(loss_fn, p64, batches[0])
    del p64
    norm = lambda g: float(torch.sqrt(sum(  # noqa: E731
        (x.double() ** 2).sum() for x in g.values())))
    n32, nmb, n64 = norm(g32), norm(gmb), norm(g64)
    err32, errmb = train_f64_errors(g32, g64), train_f64_errors(gmb, g64)
    del g32, gmb, g64
    f64 = {"loss_f64": float(l64), "loss": float(l32),
           "loss_rel_err": abs(float(l32) - float(l64)) / abs(float(l64)),
           "grad_norm_f64": n64, "grad_norm": n32,
           "grad_norm_rel_err": abs(n32 - n64) / n64,
           "grad_max_rel_err": max(err32.values()),
           "grad_rel_err_by_leaf": err32,
           "microbatches_2": {
               "loss_rel_err": abs(float(lmb) - float(l64)) / abs(float(l64)),
               "grad_norm_rel_err": abs(nmb - n64) / n64,
               "grad_max_rel_err": max(errmb.values())}}
    for what, e in (("step 1", f64), ("microbatches=2",
                                      f64["microbatches_2"])):
        if not e["loss_rel_err"] <= TRAIN_RTOL:
            failed.append(f"{what} loss vs f64: {e['loss_rel_err']}")
        if not e["grad_norm_rel_err"] <= TRAIN_RTOL:
            failed.append(f"{what} grad norm vs f64: "
                          f"{e['grad_norm_rel_err']}")
        if not e["grad_max_rel_err"] <= TRAIN_GRAD_REL:
            failed.append(f"{what} gradients vs f64: "
                          f"{e['grad_max_rel_err']}")
    gc.collect()
    torch.cuda.empty_cache()

    opt = adamw_init(params)
    step = make_train_step(model.loss, mc, OptimizerConfig(), remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for b in batches:
        t = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        failed.append(f"losses {losses}")
    if abs(losses[0] - float(l32)) > TRAIN_RTOL * abs(float(l32)):
        failed.append(f"step 1's loss {losses[0]} vs {float(l32)}")
    launched = {k: n - launches0[k] for k, n in ops.LAUNCHES.items()
                if n != launches0[k]}
    if launched:
        failed.append(f"kernel launches in training: {launched}")
    del params, opt, batches
    gc.collect()
    torch.cuda.empty_cache()
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    tokens = batch * seq
    # 6·N·tokens: N the active parameters of the reference's count (the
    # embedding table among them), and N the parameters in products
    model_flops = RA.model_flops_for(mc, _train_shape(seq, batch), "train")
    product_flops = 6 * n_matmul * tokens

    rec = TRR.load(os.path.join(HERE, "tests", "golden",
                                "torch_train_steps.npz"))
    replay = TRR.mismatches(rec, TRR.replay(rec, dev))
    failed += [f"train record: {x}" for x in replay]
    with tempfile.TemporaryDirectory() as tmp:
        resume = train_resume_check(dev, tmp)
    contract = audit_train_step(TRAIN_ARCH, dev)
    if not contract.ok or contract.census.device_launches:
        failed.append(f"train step contract: {contract.violations}, "
                      f"launches {contract.census.device_launches}")
    if not (resume["injected"] and resume["resumed_from"] == 4
            and resume["final_step"] == 8
            and resume["rel_err"] <= TRAIN_RESUME_RTOL):
        failed.append(f"resume: {resume}")
    out = {"phase": "train", "arch": mc.name, "layers": mc.num_layers,
           "reduced": {"num_layers": f"{mc.num_layers} of 32"},
           "params": n_params, "matmul_params": n_matmul,
           "batch": batch, "seq": seq, "steps": TRAIN_STEPS, "remat": True,
           "loss_chunks": seq // chunk_size(batch, seq, mc.vocab_size),
           "ms_per_step": ms, "steady_ms_per_step": steady,
           "tokens_per_s": tokens / (steady / 1e3),
           "product_flops": product_flops,
           "mfu_f32": product_flops / (steady / 1e3) / F32_FLOPS,
           "model_flops": model_flops,
           "mfu_f32_6nd_ref": model_flops / (steady / 1e3) / F32_FLOPS,
           "hfu_f32_with_recompute": product_flops * 8 / 6 / (steady / 1e3)
           / F32_FLOPS,
           "peak_gb": peak_gb, "losses": losses, "f64_check": f64,
           "bars": {"loss_and_norm_rel": TRAIN_RTOL,
                    "grad_leaf_rel_of_max": TRAIN_GRAD_REL,
                    "resume_rel": TRAIN_RESUME_RTOL,
                    "record_rel": TRR.TRAIN_RTOL},
           "record_replay": "ok" if not replay else replay,
           "resume": resume, "kernel_launches": launched,
           "contract": {"ok": contract.ok,
                        "launches": contract.census.device_launches,
                        "fp64": len(contract.census.fp64),
                        "host_syncs": contract.census.host_syncs},
           "failed": failed, "seconds": time.perf_counter() - t0}
    emit(out)
    if failed:
        raise AssertionError(f"train phase failed: {failed}")
    return out


TM_ARCH = "r1-llama-8b"
TM_LAYERS = 2              # of r1-llama-8b's 32, as the train phase
TM_BATCH, TM_SEQ, TM_STEPS = 8, 512, 3
TM_DATA_STEPS = 2          # the data-2 leg's (its gloo traffic is 12x)
TM_MESH = "data=2,model=1"  # 2 gloo ranks on the one card
TM_MODEL_MESH = "data=1,model=2"  # the compute split over model
TM_SMOKE_MESH = "data=2,model=2"
TM_LOSS_RTOL = 2e-5        # the reference's sharded-step bars
TM_PARAM_RTOL, TM_PARAM_ATOL = 2e-4, 2e-5
TM_GRAD_REL = 1e-4         # each gradient leaf, of that leaf's largest |g|
TM_GNORM_RTOL = 1e-5       # the gradient norm against the one-rank step's
TM_SMOKE_WARMUP = 1        # smoke steps at the full lr: updates over the bar
TM_RING_ATOL, TM_PIPE_ATOL, TM_POD_REL, TM_MOE_ATOL = 3e-5, 2e-5, 0.02, 1e-5
# the SSM, hybrid and encoder-decoder leg (data 1 x model 2, full width):
# arch -> (decoder / backbone layers, encoder layers, batch, tokens)
TM_FAMILIES = {"falcon-mamba-7b": (2, 0, 4, 512),     # of 64 layers
               # one group of 6 Mamba-2 layers, the shared block, 1 tail
               "zamba2-7b": (7, 0, 4, 512),           # of 81 layers
               "whisper-medium": (2, 2, 4, 256)}      # of 24 + 24, 1500
TM_FAMILY_DEPTH = {"falcon-mamba-7b": "2 of 64 layers",
                   "zamba2-7b": "7 of 81 layers (one group of 6 Mamba-2 "
                                "layers, the shared block, 1 tail layer)",
                   "whisper-medium": "2 + 2 of 24 + 24 layers"}
TM_FAMILY_STEPS = 2


def _excess(got, want, rtol: float, atol: float) -> float:
    """max(|got - want| - (atol + rtol |want|)): <= 0 within the bar."""
    got, want = got.detach(), want.detach()
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def _grad_rel(got: dict, want: dict) -> dict:
    return {k: float((got[k] - w).abs().max()
                     / w.abs().max().clamp_min(1e-30))
            for k, w in want.items()}


def _one_rank_step(model, mc, batch) -> dict:
    """The one-rank step of ``SEED``'s weights on ``batch``: its loss, its
    gradient (a ``grad_transform`` that keeps it) and the new weights."""
    from repro_torch.config import OptimizerConfig
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step
    ref = {}

    def keep(g):
        ref["grads"] = {k: v.clone() for k, v in g.items()}
        return g
    p = model.init_params(SEED, batch["tokens"].device).requires_grad_(True)
    step = make_train_step(model.loss, mc, OptimizerConfig(), remat=True,
                           grad_transform=keep)
    _, _, m = step(p, adamw_init(p), batch)
    ref.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               params=p)
    return ref


def train_mesh_full_rank(mesh, dirs: Optional[dict] = None,
                         steps: int = TM_STEPS) -> dict:
    """One rank of a full-width r1-llama-8b leg of ``train_mesh_phase``
    (data 2, or data 1 x model 2): ``_full_leg`` of its model and
    batches; then, with ``dirs``, the card freed, the 2-rank part of (b)
    (``train_mesh_smoke_rank2``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.device import set_f32_numerics
    from repro_torch.training.trainer import batch_to
    set_f32_numerics()
    mc = dataclasses.replace(get_config(TM_ARCH), num_layers=TM_LAYERS)
    data = lm_batches(mc.vocab_size, TM_BATCH, TM_SEQ, seed=SEED)
    out = _full_leg(mesh, mc, [batch_to(next(data), mesh.device)
                               for _ in range(steps)])
    if dirs is not None:
        out["smoke2"] = train_mesh_smoke_rank2(mesh, dirs)
    return out


def _family_leg(arch: str, dev):
    """(the config cut to the leg's depth, its batches) of one of
    ``TM_FAMILIES``: tokens from ``SEED`` and, for the encoder-decoder,
    frames [batch, encoder_seq, d_model] from ``SEED``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.training.trainer import batch_to
    layers, enc_layers, batch, seq = TM_FAMILIES[arch]
    mc = dataclasses.replace(get_config(arch), num_layers=layers,
                             encoder_layers=enc_layers)
    data = lm_batches(mc.vocab_size, batch, seq, seed=SEED)
    g = torch.Generator().manual_seed(SEED)
    batches = []
    for _ in range(TM_FAMILY_STEPS):
        b = batch_to(next(data), dev)
        if enc_layers:
            b["frames"] = torch.randn(batch, mc.encoder_seq, mc.d_model,
                                      generator=g).to(dev)
        batches.append(b)
    return mc, batches


def train_mesh_families_rank(mesh) -> dict:
    """One rank of the SSM, hybrid and encoder-decoder leg of
    ``train_mesh_phase`` (data 1 x model 2): ``_full_leg`` of each of
    ``TM_FAMILIES`` in turn, its wall seconds beside it."""
    from repro_torch.device import set_f32_numerics
    set_f32_numerics()
    out = {}
    for arch in TM_FAMILIES:
        t = time.perf_counter()
        out[arch] = _full_leg(mesh, *_family_leg(arch, mesh.device))
        out[arch]["seconds"] = time.perf_counter() - t
    return out


def _full_leg(mesh, mc, batches: list) -> dict:
    """One rank's full-width sharded steps of ``mc`` on ``batches``.  Rank
    0 first runs the one-rank step of the same seeds on its own copy of
    the weights (``_one_rank_step``: its gradient and new parameters stay
    on the card), then both ranks run one sharded step per batch; step 1
    (with a ``grad_transform`` that reads the whole gradient) is held to
    the one-rank step on rank 0: its loss, gradient norm, gradient and
    gathered parameters.  Per step the collective bytes by (kind, axis,
    what) (``sharding.TRAFFIC``) beside the dry run's count of the same
    cell (``launch.dryrun.train_traffic``); the bytes held between steps,
    the peak of steps 2-, ms per step and the kernel launches."""
    import torch

    import repro_torch.training.train_step as TS
    from repro_torch.config import MeshConfig, OptimizerConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import train_traffic
    from repro_torch.models.factory import build_model
    from repro_torch.training.optimizer import adamw_init
    dev = mesh.device
    launches0 = dict(ops.LAUNCHES)
    model = build_model(mc)
    out = {"rank": mesh.rank}
    ref = _one_rank_step(model, mc, batches[0]) if mesh.rank == 0 else {}
    torch.cuda.empty_cache()
    SH.barrier(mesh)
    params = model.init_params(SEED, dev).requires_grad_(True)
    sp = TS.shard_params(params, mesh)
    opt = adamw_init(sp.blocks)
    held, errs = [], {}

    def check_grads(g):
        if "grads" in ref:
            errs["grad_rel"] = _grad_rel(g, ref.pop("grads"))
        return g

    first = TS.make_train_step(model.loss, mc, OptimizerConfig(),
                               remat=True, grad_transform=check_grads,
                               mesh=mesh, split=model.split)
    step = TS.make_train_step(model.loss, mc, OptimizerConfig(), remat=True,
                              mesh=mesh, split=model.split)
    layout = MeshConfig(mesh.shape, mesh.axis_names)
    nb, seq = batches[0]["tokens"].shape
    want = {gt: {"/".join(k): n for k, n in sorted(train_traffic(
        mc, layout, nb, seq, grad_transform=gt).items())}
        for gt in (True, False)}
    ms, losses, traffic = [], [], []
    for i, b in enumerate(batches):
        if i == 1:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        SH.reset_collectives()
        torch.cuda.synchronize()
        t = time.perf_counter()
        sp, opt, m = (first if i == 0 else step)(sp, opt, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        traffic.append({"/".join(k): n for k, n in sorted(
            SH.TRAFFIC.items())})
        held.append(_resident_bytes(sp, opt, params))
        if i == 0:
            worst = {}
            for k, blk in sp.blocks.items():   # every rank gathers
                full = SH.unshard(blk, sp.specs[k], mesh)
                if "params" in ref:
                    worst[k] = _excess(full, getattr(ref["params"], k),
                                       TM_PARAM_RTOL, TM_PARAM_ATOL)
                del full
            if "params" in ref:
                errs["param_excess"] = worst
                errs["loss_rel"] = abs(losses[0] - ref["loss"]) / \
                    abs(ref["loss"])
                errs["loss_one_rank"] = ref["loss"]
                errs["gnorm_rel"] = abs(float(m["grad_norm"])
                                        - ref["grad_norm"]) / \
                    ref["grad_norm"]
                del ref["params"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    del sp, opt, params, batches, model
    torch.cuda.empty_cache()
    out.update(losses=losses, ms_per_step=ms, held_bytes=max(held),
               peak_gb_steps_2_on=peak, traffic_per_step=traffic,
               traffic_dry_run={"step 1 (whole gradient)": want[True],
                                "steps 2-": want[False]},
               traffic_equals_dry_run=all(
                   t == want[i == 0] for i, t in enumerate(traffic)),
               model_param_gathers=sorted(
                   k for t in traffic for k in t
                   if k.split("/")[1:] == ["model", "param"]),
               kernel_launches={k: n - launches0[k]
                                for k, n in ops.LAUNCHES.items()
                                if n != launches0[k]}, **errs)
    return out


def _resident_bytes(sp, opt, model) -> int:
    """The bytes of every storage a rank's sharded state holds: the
    parameter blocks, m, v and the full-size model the blocks were cut
    from (a storage shared by several tensors counted once)."""
    stores = {}
    for t in [*sp.blocks.values(), *opt.m.values(), *opt.v.values(),
              *model.parameters()]:
        st = t.untyped_storage()
        stores[st.data_ptr()] = st.nbytes()
    return sum(stores.values())


def _smoke_batch(cfg, seed: int) -> dict:
    import numpy as np
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (8, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def train_mesh_smoke_step(mesh, arch: str, seed: int, dev=None):
    """One step of ``arch``'s smoke form from ``SEED``'s weights (on
    ``mesh`` when given, else on ``dev``) at the full learning rate: (loss,
    gradient norm, the new parameters as numpy)."""
    from repro_torch.config import OptimizerConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.factory import build_model
    from repro_torch.training.optimizer import adamw_init, named
    from repro_torch.training.train_step import make_train_step, \
        shard_params
    from repro_torch.training.trainer import batch_to
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    dev = mesh.device if mesh is not None else dev
    p = model.init_params(SEED, dev).requires_grad_(True)
    batch = batch_to(_smoke_batch(cfg, seed), dev)
    step = make_train_step(model.loss, cfg, OptimizerConfig(
        warmup_steps=TM_SMOKE_WARMUP), mesh=mesh, split=model.split)
    if mesh is None:
        _, _, m = step(p, adamw_init(p), batch)
        return float(m["loss"]), float(m["grad_norm"]), {
            k: v.detach().cpu().numpy() for k, v in named(p).items()}
    sp = shard_params(p, mesh)
    sp, _, m = step(sp, adamw_init(sp.blocks), batch)
    return float(m["loss"]), float(m["grad_norm"]), {
        k: SH.unshard(b, sp.specs[k], mesh).detach().cpu().numpy()
        for k, b in sp.blocks.items()}


def train_mesh_smoke_rank(mesh, want: dict) -> dict:
    """yi-6b and mixtral's smoke steps on this rank of (data 2, model 2),
    each held to the one-rank step on the card."""
    import numpy as np
    import torch
    out = {}
    for i, arch in enumerate(sorted(want)):
        loss, gnorm, params = train_mesh_smoke_step(mesh, arch, i)
        wl, wg, wp = want[arch]
        excess = max(_excess(torch.from_numpy(params[k]),
                             torch.from_numpy(w), TM_PARAM_RTOL,
                             TM_PARAM_ATOL) for k, w in wp.items())
        out[arch] = {"loss_rel": abs(loss - wl) / abs(wl),
                     "gnorm_rel": abs(gnorm - wg) / wg,
                     "param_excess": excess,
                     "finite": bool(np.isfinite(loss))}
    return out


def _tm_trainer(mesh, ckpt: str, steps: int, dev=None):
    from repro_torch.config import MeshConfig, OptimizerConfig, TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.training.trainer import Trainer
    layout = MeshConfig(mesh.shape, mesh.axis_names) if mesh is not None \
        else MeshConfig()
    cfg = TrainConfig(model=get_smoke_config("yi-6b"), mesh=layout,
                      optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                decay_steps=6),
                      seq_len=16, global_batch=4, steps=steps,
                      checkpoint_every=3, keep_checkpoints=2,
                      checkpoint_dir=ckpt)
    return Trainer(cfg, _tm_data, mesh=mesh, device=dev).run().losses


def _tm_data(start: int):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import lm_batches
    it = lm_batches(get_smoke_config("yi-6b").vocab_size, 4, 16, seed=7)
    for _ in range(start):
        next(it)
    return it


def train_mesh_patterns(mesh2) -> dict:
    """The mesh patterns over this rank's 2-rank meshes on card tensors,
    each against its one-rank formula: ring attention (out and the
    gradients of q, k, v against plain attention's), the pipeline against
    the stages in turn, the compressed cross-pod gradient against the
    exact mean gradient, the overlapped MoE FFN against each slab through
    its expert."""
    import torch

    from repro_torch.config import MeshConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.compression import make_cross_pod_grad_fn
    from repro_torch.distributed.overlap import overlapped_moe_ffn
    from repro_torch.distributed.ring_attention import ring_attention
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.layers.attention import dense_attention
    from repro_torch.training.pipeline import pipeline_apply
    dev = mesh2.device
    g = torch.Generator().manual_seed(SEED)
    rnd = lambda *s: torch.randn(s, generator=g).to(dev)  # noqa: E731
    out = {}
    mesh = make_mesh(MeshConfig((2,), ("model",)), mesh2.rank, dev.type)
    q, k, v, w = rnd(2, 256, 7, 32), rnd(2, 256, 1, 32), \
        rnd(2, 256, 1, 32), rnd(2, 256, 7, 32)
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = ring_attention(*qkv, mesh)
    (o * w).sum().backward()
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    plain = dense_attention(*ref, causal=True)
    (plain * w).sum().backward()
    out["ring_max_abs"] = float((o - plain).detach().abs().max())
    out["ring_grad_rel"] = max(
        float((a.grad - b.grad).abs().max() / b.grad.abs().max())
        for a, b in zip(qkv, ref))
    pod = make_mesh(MeshConfig((2,), ("pod",)), mesh2.rank, dev.type)
    ws, h0 = rnd(2, 16, 16) * 0.3, rnd(4, 2, 16)
    pipe = pipeline_apply(lambda w_, h: torch.tanh(h @ w_),
                          SH.shard_of(ws, ("pod",), pod), h0, pod,
                          num_microbatches=4, axis="pod")
    seq = h0
    for w_ in ws:
        seq = torch.tanh(seq @ w_)
    out["pipeline_max_abs"] = float((pipe - seq).abs().max())
    wp, bp = rnd(16), rnd(8, 16)
    loss = lambda p, b: torch.mean((b @ p) ** 2)  # noqa: E731
    blk = SH.shard_of(bp, ("pod",), pod)
    gc_, _ = make_cross_pod_grad_fn(loss, pod)(wp, blk, torch.zeros_like(wp))
    ge, _ = make_cross_pod_grad_fn(loss, pod, compress=False)(
        wp, blk, torch.zeros_like(wp))
    exact = 2 * bp.T @ (bp @ wp) / 8
    out["pod_compressed_rel"] = float((gc_ - ge).norm() / ge.norm())
    out["pod_exact_max_abs"] = float((ge - exact).abs().max())
    x, wu, wd = rnd(16, 8), rnd(2, 8, 12) * 0.2, rnd(2, 12, 8) * 0.2
    y = SH.unshard(overlapped_moe_ffn(
        SH.shard_of(x, ("model",), mesh), wu[mesh.rank], wd[mesh.rank],
        mesh, chunks=2), ("model",), mesh)
    # token j of rank i's block of 8 goes to expert j // 4
    want = torch.cat([torch.relu(x[r * 8 + e * 4:r * 8 + e * 4 + 4] @ wu[e])
                      @ wd[e] for r in range(2) for e in range(2)])
    out["moe_max_abs"] = float((y - want).abs().max())
    return out


def train_mesh_smoke_rank2(mesh, dirs: dict) -> dict:
    """On this rank of 2: the resume of a 1-rank run, a run saved for the
    1-rank resume, and the mesh patterns on card tensors."""
    from repro_torch.distributed import sharding as SH
    SH.reset_collectives()
    out = {"resume_1_to_2": _tm_trainer(mesh, dirs["from1"], 6),
           "saved_2": _tm_trainer(mesh, dirs["to1"], 3),
           "patterns": train_mesh_patterns(mesh)}
    out["collectives"] = {f"{k}({d})": n
                          for (k, d), n in SH.COLLECTIVES.items()}
    return out


def _full_leg_checks(name: str, full: list) -> list:
    """The failures of one full-width leg's ranks (``train_mesh_full_rank``
    results, rank 0 holding the one-rank comparison)."""
    failed, r0 = [], full[0]
    if not r0.get("loss_rel", 1.0) <= TM_LOSS_RTOL:
        failed.append(f"{name}: loss vs one rank {r0.get('loss_rel')}")
    if not max(r0.get("param_excess", {"": 1.0}).values()) <= 0:
        failed.append(f"{name}: parameters over the bar by "
                      f"{max(r0.get('param_excess', {'': 1.0}).values())}")
    if not r0.get("gnorm_rel", 1.0) <= TM_GNORM_RTOL:
        failed.append(f"{name}: gradient norm {r0.get('gnorm_rel')}")
    if not max(r0.get("grad_rel", {"": 1.0}).values()) <= TM_GRAD_REL:
        failed.append(f"{name}: gradients "
                      f"{max(r0.get('grad_rel', {'': 1.0}).values())}")
    for r in full:
        if r["kernel_launches"]:
            failed.append(f"{name}: rank {r['rank']} launched "
                          f"{r['kernel_launches']}")
        if r["losses"] != r0["losses"] or not all(
                x == x for x in r["losses"]):
            failed.append(f"{name}: rank {r['rank']} losses {r['losses']}")
        if not r["traffic_equals_dry_run"]:
            failed.append(f"{name}: rank {r['rank']} collective bytes "
                          f"{r['traffic_per_step']} vs the dry run's "
                          f"{r['traffic_dry_run']}")
        if r["model_param_gathers"]:
            failed.append(f"{name}: rank {r['rank']} gathered parameters "
                          f"over model: {r['model_param_gathers']}")
    return failed


def _full_leg_record(name: str, mesh: str, full: list, t0: float,
                     arch: str = TM_ARCH,
                     reduced: str = f"{TM_LAYERS} of 32 layers",
                     shape: tuple = (TM_BATCH, TM_SEQ)) -> dict:
    r0 = full[0]
    keys = ("losses", "ms_per_step", "held_bytes", "peak_gb_steps_2_on",
            "traffic_per_step", "traffic_equals_dry_run",
            "model_param_gathers", "kernel_launches")
    return {
        "phase": name, "nvidia_smi": nvidia_smi(),
        "arch": arch, "reduced": {"depth": reduced}, "mesh": mesh,
        "batch": shape[0], "seq": shape[1], "steps": len(r0["losses"]),
        "per_rank": [{k: r[k] for k in keys} for r in full],
        "traffic_dry_run": r0["traffic_dry_run"],
        "one_rank_check": {
            "loss_one_rank": r0.get("loss_one_rank"),
            "loss_rel": r0.get("loss_rel"),
            "param_max_excess": max(r0.get("param_excess",
                                           {"": None}).values()),
            "gnorm_rel": r0.get("gnorm_rel"),
            "grad_max_rel": max(r0.get("grad_rel", {"": None}).values())},
        "bars": {"loss_rtol": TM_LOSS_RTOL,
                 "param_rtol_atol": [TM_PARAM_RTOL, TM_PARAM_ATOL],
                 "grad_rel_of_max": TM_GRAD_REL,
                 "gnorm_rtol": TM_GNORM_RTOL},
        "seconds": time.perf_counter() - t0}


def families_leg(dev):
    """The SSM, hybrid and encoder-decoder leg of ``train_mesh_phase``
    (``train_mesh_families_rank`` on 2 gloo ranks, data 1 x model 2):
    (every rank's results, a record per model, emitted, and the
    failures)."""
    from repro_torch.launch.mesh import run_ranks
    t = time.perf_counter()
    fam = run_ranks(train_mesh_families_rank, TM_MODEL_MESH, dev.type,
                    timeout=900)
    recs, failed = {}, []
    for arch, (_, _, nb, seq) in TM_FAMILIES.items():
        legs = [r[arch] for r in fam]
        recs[arch] = _full_leg_record(
            f"train_mesh_{arch}", TM_MODEL_MESH, legs, t, arch,
            TM_FAMILY_DEPTH[arch], (nb, seq))
        recs[arch]["seconds"] = legs[0]["seconds"]
        emit(recs[arch])
        failed += _full_leg_checks(f"{arch} model 2", legs)
    return fam, recs, failed


def dry_run_wall() -> dict:
    """``python -m repro_torch.launch.dryrun`` over every cell at both
    production meshes, its wall time."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        env = dict(os.environ, PYTHONPATH=SRC)
        t = time.perf_counter()
        out = subprocess.run([sys.executable, "-m",
                              "repro_torch.launch.dryrun", "--out", tmp],
                             capture_output=True, text=True, env=env)
        wall = time.perf_counter() - t
        cells = len(os.listdir(tmp))
    return {"wall_s": wall, "cells": cells, "returncode": out.returncode,
            "last": out.stdout.strip().splitlines()[-1:]}


def train_mesh_phase(dev) -> dict:
    """Sharded training on gloo ranks sharing the one card
    (``launch.mesh.run_ranks``): (a) r1-llama-8b at full width and 2 of 32
    layers, batch 8 x 512 from ``SEED``, 2 ranks, twice: data 2 (2
    steps), and data 1 x model 2 (the compute split over ``model``, 3
    steps), then falcon-mamba-7b, zamba2-7b and whisper-medium at full
    width on data 1 x model 2 (``TM_FAMILIES``: depth cut, 2 steps each,
    one spawn).  Each: step
    1's loss, gradient and every parameter leaf held to the one-rank step
    of the same seeds (the reference's bars: loss rtol 2e-5, parameters
    2e-4 / 2e-5, gradient norm 1e-5; gradients 1e-4 of each leaf's
    largest |g|); per rank the bytes held between steps, the peak of
    steps 2-, ms per step, and per step the collective bytes by (kind,
    axis, what), equal to the dry run's count of the cell, none a
    parameter gathered over ``model``; no kernel launch.  (b) at smoke size: yi-6b and mixtral-8x7b on (data 2, model
    2) held to the one-rank step; the trainer saved on 1 rank and resumed
    on 2 and saved on 2 and resumed on 1 (the same 2 ranks as the data-2
    leg, after it), against the uninterrupted run (1e-4 relative); ring
    attention, the pipeline, the compressed cross-pod gradient and the
    overlapped MoE FFN over 2 ranks on card tensors against their
    one-rank formulas.  (c) the dry run at the production meshes, timed."""
    import shutil
    import tempfile

    from repro_torch.config import MeshConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh, run_ranks
    t0 = time.perf_counter()
    launches0 = dict(ops.LAUNCHES)
    failed = []
    tmp = tempfile.mkdtemp(prefix="train_mesh_")
    dirs = {k: os.path.join(tmp, k) for k in ("ref", "from1", "to1")}
    one = make_mesh(MeshConfig((1, 1), ("data", "model")), 0, dev.type)
    ref = _tm_trainer(None, dirs["ref"], 6, dev)
    saved_1 = _tm_trainer(one, dirs["from1"], 3)
    full = run_ranks(train_mesh_full_rank, TM_MESH, dev.type, dirs,
                     TM_DATA_STEPS, timeout=900)
    resume_2_to_1 = _tm_trainer(one, dirs["to1"], 6)
    shutil.rmtree(tmp, ignore_errors=True)
    rec_full = _full_leg_record("train_mesh_full", TM_MESH, full, t0)
    emit(rec_full)
    failed += _full_leg_checks("data 2", full)
    t1 = time.perf_counter()
    split = run_ranks(train_mesh_full_rank, TM_MODEL_MESH, dev.type,
                      timeout=900)
    rec_split = _full_leg_record("train_mesh_model2", TM_MODEL_MESH, split,
                                 t1)
    emit(rec_split)
    failed += _full_leg_checks("model 2", split)
    fam, rec_fam, fam_failed = families_leg(dev)
    failed += fam_failed

    two = [r["smoke2"] for r in full]
    rel = lambda a, b: max(abs(x - y) / abs(y)  # noqa: E731
                           for x, y in zip(a, b))
    resume = {"uninterrupted": ref, "saved_1": saved_1,
              "resume_1_to_2": two[0]["resume_1_to_2"],
              "saved_2": two[0]["saved_2"], "resume_2_to_1": resume_2_to_1}
    for what, got, want_ in (("saved_1", saved_1, ref[:3]),
                             ("saved_2", two[0]["saved_2"], ref[:3]),
                             ("resume_1_to_2", two[0]["resume_1_to_2"],
                              ref[3:]),
                             ("resume_2_to_1", resume_2_to_1, ref[3:])):
        if len(got) != len(want_) or rel(got, want_) > TRAIN_RESUME_RTOL:
            failed.append(f"{what}: {got} vs {want_}")
    for key, bar in (("ring_max_abs", TM_RING_ATOL),
                     ("ring_grad_rel", TM_GRAD_REL),
                     ("pipeline_max_abs", TM_PIPE_ATOL),
                     ("pod_compressed_rel", TM_POD_REL),
                     ("pod_exact_max_abs", 1e-6),
                     ("moe_max_abs", TM_MOE_ATOL)):
        for r in two:
            if not r["patterns"][key] <= bar:
                failed.append(f"patterns {key}: {r['patterns'][key]}")

    want = {a: train_mesh_smoke_step(None, a, i, dev)
            for i, a in enumerate(sorted(("yi-6b", "mixtral-8x7b")))}
    smoke = run_ranks(train_mesh_smoke_rank, TM_SMOKE_MESH, dev.type, want,
                      timeout=600)
    for r, res in enumerate(smoke):
        for arch, e in res.items():
            if not (e["loss_rel"] <= TM_LOSS_RTOL and e["param_excess"] <= 0
                    and e["gnorm_rel"] <= TM_GNORM_RTOL and e["finite"]):
                failed.append(f"smoke {arch} rank {r}: {e}")
    dry = dry_run_wall()
    if dry["returncode"] or not dry["cells"]:
        failed.append(f"dry run: {dry}")
    launched = {k: n - launches0[k] for k, n in ops.LAUNCHES.items()
                if n != launches0[k]}
    if launched:
        failed.append(f"kernel launches in the parent: {launched}")
    out = {**rec_full, "phase": "train_mesh", "model2": rec_split,
           "families_model2": rec_fam,
           "smoke_2x2": smoke[0], "resume": resume,
           "patterns": two[0]["patterns"],
           "collectives_rank0_smoke2": two[0]["collectives"],
           "dry_run": dry,
           "kernel_launches": {n: 0 for n in ops.LAUNCHES} | {
               k: v for r in full + split + [
                   leg for f in fam for leg in f.values()]
               for k, v in r["kernel_launches"].items()} | launched,
           "failed": failed, "seconds": time.perf_counter() - t0}
    emit(out)
    if failed:
        raise AssertionError(f"train_mesh phase failed: {failed}")
    return out


def ab(parent: str) -> int:
    """The parent tree (``parent``/src, its kernels built there) and this
    one, each in its own process, in turns: parent, this, this, parent;
    each runs the kernels, serve, prefill_profile and profile phases and
    falcon-mamba-7b's 4 x 1024-token prefill (``ssm_prefill``, full
    depth)."""
    runs = []
    for tree in (parent, HERE, HERE, parent):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--ab-run", "--src",
             os.path.join(os.path.abspath(tree), "src")],
            capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            print(out.stdout[-4000:], flush=True)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        emit(runs[-1])
    emit({"phase": "ab", "order": ["parent", "change", "change", "parent"],
          "runs": runs})
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if "--ab" in sys.argv:
        return ab(sys.argv[sys.argv.index("--ab") + 1])
    if "--families-leg" in sys.argv:
        # the train_mesh phase's families leg alone, on the port in SRC
        # (``--src DIR`` runs it on another tree, a parent's)
        _, _, failed = families_leg(torch.device("cuda", 0))
        print(nvidia_smi(), flush=True)
        emit({"ok": not failed, "failed": failed, "src": SRC})
        return 1 if failed else 0
    ab_run = "--ab-run" in sys.argv
    import numpy as np
    from repro_torch.config import ServeConfig, ThinKVConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.lm import init_params
    from repro_torch.serving.engine import ThinKVEngine

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "src": SRC})

    t0 = time.perf_counter()
    build.build_all()
    logs = build.build_logs()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "entry function" in ln]
                    for k, v in logs.items()}})

    mc = get_config("r1-llama-8b")
    tk = ThinKVConfig()
    t0 = time.perf_counter()
    recs = check_kernels(dev, mc, tk)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})
    com = commit_profile(dev, mc, tk)
    if not ab_run:
        trc = trace_phase(dev)

    # ---- serve: the main path at full width and depth ----
    cfg = ServeConfig(model=mc, thinkv=tk, max_seqs=4)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, mc.vocab_size, 1100) for _ in range(4)]
    max_new = 64
    t0 = time.perf_counter()
    params = init_params(mc, SEED, dev)
    init_s = time.perf_counter() - t0
    srv = serve_phase(ThinKVEngine, cfg, params, prompts, max_new, init_s,
                      dev)
    pre = profile_prefill(ThinKVEngine, cfg, params,
                          prompts[0][:PROFILED_PREFILL], dev)
    emit(pre)
    prof = profile_decode(ThinKVEngine, cfg, params, prompts, dev)
    emit(prof)
    if not ab_run:
        sst = serve_step_phase(params, mc, dev, prompts)
        audit_phase(ThinKVEngine, params, mc, dev)
    del params
    gc.collect()                      # engines keep the weights in cycles
    torch.cuda.empty_cache()
    if not ab_run:
        mcc = dataclasses.replace(mc, num_layers=CUT_LAYERS)
        params = init_params(mcc, SEED, dev)
        prs = pressure_phase(ThinKVEngine, params, mcc, dev)
        smp = sampled_phase(ThinKVEngine, params, mcc, prompts, dev)
        pol = policy_phase(ThinKVEngine, params, mcc, dev)
        tpp = tp_pressure_leg(ThinKVEngine, params, mcc, dev, prs)
        del params
        prs.pop("runs")
        gc.collect()
        torch.cuda.empty_cache()
        # two ranks of 32.1 GB of weights each: this process holds none
        tps = tp_serve_leg(mc, prompts, max_new, srv, dev)
        emit({"phase": "tp", "pressure": tpp, "serve": tps})
        srv.pop("run")
        if tpp["failed"] or tps["failed"]:
            raise AssertionError(f"tp phase failed: "
                                 f"{tpp['failed'] + tps['failed']}")
    if ab_run:
        _, ssm_params, _, ssm_pre = ssm_prefill(dev, rng)
        del ssm_params
        emit({"tree": SRC, "nvidia_smi": smi,
              "kernels": {n: {k: r[k] for k in ("shape", "ms", "eager_ms",
                                                "max_abs_err")}
                          for n, r in recs.items()},
              "serve": {**{k: srv[k] for k in ("prefill_s", "decode_s",
                                               "ms_per_tick", "wall_s",
                                               "commits")},
                        "k4_launches": srv["launches"]["group_quant"]},
              "commit_profile": {k: com[k] for k in (
                  "group_quant_launches", "device_ops", "device_busy_ms",
                  "window_ms", "ops")},
              "prefill_profile": {k: pre[k] for k in (
                  "window_ms", "device_busy_ms", "idle_share", "spans",
                  "kernel_groups", "prefill_s")},
              "profile": {"ticks": prof["ticks"],
                          "window_ms": prof["window_ms"],
                          "device_busy_ms": prof["device_busy_ms"],
                          "idle_share": prof["idle_share"],
                          "busy_ms_per_tick":
                              prof["device_busy_ms"] / prof["ticks"],
                          "k1_ms_per_tick":
                              prof["kernel_groups"]["K1"]["ms"]
                              / prof["ticks"],
                          "k1_launches": prof["kernel_groups"]["K1"]["count"]},
              "ssm_prefill": {k: ssm_pre[k] for k in (
                  "layers", "seconds", "tok_s", "busy_share", "k5_ms",
                  "k5_share")}})
        return 0

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

    del params4
    gc.collect()                      # engines keep the weights in cycles
    torch.cuda.empty_cache()          # the archs phase needs up to ~35 GB
    arc = archs_phase(dev, tk)
    torch.cuda.empty_cache()
    vlm = vlm_phase(dev, tk)
    torch.cuda.empty_cache()                 # the hybrid phase needs ~30 GB
    hyb = hybrid_phase(dev, tk)
    enc = encdec_phase(dev, tk)
    torch.cuda.empty_cache()                 # the ssm phase needs ~28 GB
    ssm = ssm_phase(dev, rng)
    torch.cuda.empty_cache()
    ctl = controller_phase(dev, mc, tk)
    exm = examples_phase()
    gc.collect()
    torch.cuda.empty_cache()
    train_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()                 # the ranks need ~60 GB
    tm = train_mesh_phase(dev)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_peak", "eager_ms")
    launches = srv["launches"]
    for n in ("K1", "K2", "K3", "K4"):
        recs[n]["launches"] = launches[recs[n]["name"]]
        recs[n]["launches_pressure"] = prs["launches"][recs[n]["name"]]
        recs[n]["launches_sampled"] = smp["runs"][1]["launches"][
            recs[n]["name"]]
        recs[n]["launches_tp"] = tps["launches"][recs[n]["name"]]
    for n, r in recs.items():
        r["launches_policy"] = {p: run["launches"].get(r["name"], 0)
                                for p, run in pol["runs"].items()}
    recs["K1"]["launches_serve_step"] = sst["k1_launches"]
    for n in ("K1", "K2", "K3", "K4"):
        recs[n]["launches_archs"] = {
            arch: arc[arch]["launches"][recs[n]["name"]]
            for arch, _ in ARCH_SERVED}
        recs[n]["launches_vlm"] = vlm[VLM_ARCH]["launches"][recs[n]["name"]]
        recs[n]["launches_trace"] = trc["launches_kernel_backend"][
            recs[n]["name"]]
    recs["K5"]["launches"] = ssm["prefill"]["launches"]["mamba_scan"]
    for n, r in recs.items():
        r["launches_train_mesh"] = tm["kernel_launches"].get(r["name"], 0)
    recs["wrapper"]["launches"] = ctl["wrapper_launches"]
    recs["K1"]["launches_vlm_serve_step"] = \
        vlm["serve_step"]["k1_launches"]
    recs["K1"]["launches_hybrid"] = hyb["thinkv"]["k1_launches"]
    recs["K1"]["launches_encdec"] = enc["thinkv"]["k1_launches"]
    recs["K4"]["launches_encdec"] = enc["k4_cross"]["launches"]
    for n, r in recs.items():
        r["launches_examples"] = {ex: launches.get(r["name"], 0)
                                  for ex, launches in exm["launches"].items()}
    extra = ("launches_pressure", "launches_sampled", "launches_tp",
             "launches_policy",
             "launches_serve_step", "launches_archs", "launches_vlm",
             "launches_vlm_serve_step", "launches_hybrid", "launches_encdec",
             "launches_trace", "launches_train_mesh", "launches_examples")
    lines = [{k: recs[n][k] for k in keys + tuple(
        k for k in extra if k in recs[n])}
        for n in ("K1", "K2", "K3", "K4", "K5", "wrapper")]
    # K1 at the serve step's shape beside its tick shape
    lines[0]["by_shape"] = {
        "tick": {k: recs["K1"][k] for k in ("launches", "ms", "bound_ms")},
        **{name: {"launches": st["k1_launches"],
                  **{k: st["k1_serve_step"][k] for k in (
                      "shape", "ms", "eager_ms", "plain_ms", "bound_ms",
                      "bound_by", "max_abs_err")}}
           for name, st in (("serve_step", sst),
                            ("vlm serve_step", vlm["serve_step"]),
                            ("hybrid serve_step, D 112", hyb["thinkv"]),
                            ("encdec serve_step", enc["thinkv"]))}}
    # K4 through its direct entry over whisper's cross KV
    lines[3]["by_shape"] = {"encdec cross KV": {
        k: enc["k4_cross"][k] for k in (
            "launches", "shape", "ms", "eager_ms", "plain_ms", "bound_ms",
            "bound_by", "max_abs_err")}}
    # K2 and K3 beside each shape of the serve phase: launches and times
    for line, name, shapes in (
            (lines[1], "ct_paged_attention_batched", ("K2", "K2_64")),
            (lines[2], "flash_prefill", ("K3", "K3_16"))):
        line["by_shape"] = {
            shape: {"launches": n, "ms": recs[key]["ms"],
                    "bound_ms": recs[key]["bound_ms"],
                    "library_ms": recs[key]["library_ms"]}
            for (shape, n), key in zip(
                srv["launches_by_shape"][name].items(), shapes)}
    # K2 and K3 at head_dim 112 (zamba2-7b's shared block), which no
    # serving path launches
    for line, prefix in ((lines[1], ""), (lines[2], "K3 ")):
        for chunk in ("big chunk", "g-chunk"):
            r = hyb["kernels_d112"][prefix + chunk]
            line["by_shape"][f"hybrid {chunk}, D 112"] = {
                "launches": 0, **{k: r[k] for k in (
                    "shape", "ms", "eager_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "max_abs_err")}}
    # K1-K4 at the archs, vlm (head_dim 256) and trace (head_dim 16)
    # phases' shapes: times, bounds and launches
    for line, kernel in zip(lines[:4], ("K1", "K2", "K3", "K4")):
        line["archs"] = arch_kernel_shapes(arc, kernel)
        line["vlm"] = arch_kernel_shapes(vlm, kernel, VLM_KERNELS)
        line["trace"] = {
            key: {k: r[k] for k in ("shape", "ms", "eager_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "max_abs_err")}
            for key, r in trc["records"].items()
            if key.split("_")[0] == kernel}
    emit({"phase": "done", "seconds": time.perf_counter() - t_all})
    emit({"kernels": lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
