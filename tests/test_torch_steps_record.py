"""Replay a recorded run of the serve steps of the hybrid or the
encoder-decoder family and hold it to the record.

A record is a numpy archive written from the JAX package's serve steps
(``tests/golden/torch_{hybrid,encdec}_steps.npz``, by
``tests/test_torch_trace_fixture.py``), on a smoke form of zamba2-7b or
whisper-medium.  Reading it, and making the weights and inputs it names,
takes numpy only, so a machine without JAX (the card's) holds the port's
serve steps to the JAX package's.  The run:

1. the prefill step over ``prompts [B, S]`` (with ``frames`` for the
   encoder-decoder): last-token logits;
2. S FullKV decode steps from an empty state, fed the prompts' tokens at
   positions 0..S-1 (caches of S rows; the hybrid's Mamba-2 state from
   zero, the encoder-decoder's cross keys and values from its own
   encoding): the logits of every step (the last one is the prefill's),
   and the hybrid's final conv and SSM states;
3. N ThinKV decode steps on a numpy-seeded pool (``thinkv_batch``: random
   codes, E4M3-valued scales, bits 2/4/8 mixed, some slots evicted, some
   free) and bf16 buffers, the hybrid's states being the FullKV run's
   final ones and the encoder-decoder's cross KV TBQ'd at 4 bits by the
   reference (``cross_{k,v}_{codes,scales}``), fed ``thinkv_tokens [N,
   B]`` (the JAX reference backend's greedy tokens), each step's buffers
   and lengths feeding the next: the logits of every step on both JAX
   backends (``reference``, and ``kernel`` through the Pallas kernel),
   and after the last step the kernel backend's buffers (and the hybrid's
   states).

Archive keys: ``settings`` (JSON: ``family``, ``arch``, ``overrides`` of
``reduced``, ``thinkv`` fields, ``params_seed``, ``batch_seed``, ``steps``);
the inputs ``prompts``, ``frames``, the ThinKV batch's planes (bf16 ones
as uint16 bits: ``BF16_KEYS``), ``thinkv_tokens``; the JAX results
``prefill_logits``, ``fullkv_logits``, ``fullkv_conv`` / ``fullkv_ssm``,
``thinkv_logits_reference``, ``thinkv_logits_kernel``, ``final_buf_k`` /
``final_buf_v`` / ``final_buf_len``, ``final_conv`` / ``final_ssm``.

The weights are not stored: ``numpy_params`` draws them from
``params_seed`` into the reference's parameter tree, for both packages.
This module imports neither JAX nor the JAX package, so ``chip_smoke.py``
(which puts ``tests/`` on its path) replays the records on the card and
builds its full-width ThinKV batches with ``thinkv_batch``; the FullKV
loop ``fullkv_steps`` serves both.  The tests at the end hold its numpy
helpers on the CPU.
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Union

import numpy as np
import pytest
import torch

from repro_torch.config import (ArchFamily, ModelConfig, ThinKVConfig,
                                reduced)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import ct_cache as CC
from repro_torch.kernels import ops
from repro_torch.models import encdec, hybrid
from repro_torch.serving import serve_step as SS

BF16_KEYS = ("k_scales", "v_scales", "buf_k", "buf_v", "cross_k_scales",
             "cross_v_scales", "final_buf_k", "final_buf_v")
# the ThinKV step's batch keys that a record stores as inputs
BATCH_KEYS = ("tokens", "positions", "k_codes", "v_codes", "k_scales",
              "v_scales", "slot_state", "slot_bits", "buf_k", "buf_v",
              "buf_len")
CROSS_KEYS = ("cross_k_codes", "cross_v_codes", "cross_k_scales",
              "cross_v_scales")
PREFILL_ATOL = FULLKV_ATOL = 1e-4
THINKV_ATOL = 1e-3
# the reference backend rounds queries and probabilities to bf16 (as the
# reference's does): from the record's state its first step is held to
# THINKV_ATOL, but along the chained steps an f32 ulp now and then flips a
# probability's rounding (one bf16 step, 2^-8 of it), which moves a logit
# by ~1e-3 (1.22e-3 at one step of the hybrid record on the CPU, the
# others within 4.1e-4): the chain is held to twice the bar
THINKV_CHAIN_ATOL = 2e-3

Device = Optional[Union[str, torch.device]]


def config(settings: dict) -> ModelConfig:
    return reduced(get_config(settings["arch"]), **settings["overrides"])


def thinkv_config(settings: dict) -> ThinKVConfig:
    tk = dict(settings["thinkv"])
    for k in ("retention_schedule", "precision", "sparsity_thresholds"):
        if k in tk:
            tk[k] = tuple(tk[k])
    return ThinKVConfig(**tk)


def _draw(rng, key: str, shape) -> np.ndarray:
    """One weight of the reference's tree by its leaf key: unit-ish norm
    scales, small biases, Mamba-2's decay, skip and step biases near the
    reference's init, N(0, 0.02) embeddings and positions, fan-in normal
    projections (the conv at std W ** -0.5, as the reference's)."""
    n = rng.standard_normal(shape)
    if key == "scale":
        a = 1 + 0.1 * n
    elif key in ("bias", "bq", "bk", "bv", "conv_b"):
        a = 0.02 * n
    elif key == "A_log":
        a = 0.5 * n
    elif key == "D":
        a = 1 + 0.1 * n
    elif key == "dt_bias":
        a = -3 + 0.5 * n
    elif key in ("embedding", "enc_pos", "dec_pos"):
        a = 0.02 * n
    elif key == "conv_w":
        a = n * shape[-1] ** -0.5
    else:
        a = n * shape[-2] ** -0.5
    return a.astype(np.float32)


def numpy_params(cfg: ModelConfig, seed: int) -> dict:
    """Weights for ``cfg`` from ``np.random.default_rng(seed)`` as the
    reference's parameter tree (nested dicts of f32 numpy arrays), drawn
    in the order of the port's parameter names."""
    cls = {ArchFamily.HYBRID: hybrid.HybridLM,
           ArchFamily.ENCDEC: encdec.EncDecLM}[cfg.family]
    model = cls(cfg, torch.device("meta"))
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for name in sorted(model.sources):
        path = model.sources[name]
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _draw(rng, path[-1],
                               tuple(getattr(model, name).shape))
    return tree


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> the bits of its bf16 rounding (to nearest, ties to even)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def from_bf16_bits(u: np.ndarray) -> np.ndarray:
    return (u.astype(np.uint32) << 16).view(np.float32)


def thinkv_batch(cfg: ModelConfig, tk: ThinKVConfig, seed: int, b: int,
                 start: int) -> Dict[str, np.ndarray]:
    """A ThinKV step's batch from ``np.random.default_rng(seed)``, numpy
    only: random codes; scales E4M3 values in [2^-6, 2^-4) (exact in bf16);
    VALID, evicted and free slots (60 / 20 / 20 %), bits 2, 4 or 8 per
    slot; bf16 buffers with ``buf_len`` 0 and 5 (then every 7th);
    positions ``start``; tokens 0 (the caller sets them).  bf16 planes as
    uint16 bits."""
    rng = np.random.default_rng(seed)
    dims = CC.make_dims(tk, cfg.num_attention_layers(), cfg.num_kv_heads,
                        cfg.head_dim)
    L, NB, BS, H, D, G = dims.L, dims.NB, dims.BS, dims.H, dims.D, dims.G
    shape = (b, L, NB, BS, H)

    def scales():
        m = rng.integers(8, 16, shape + (D // 16,))
        e = rng.integers(-9, -7, shape + (D // 16,))
        return bf16_bits(np.ldexp(m.astype(np.float32), e))
    u = rng.random((b, L, NB * BS))
    out = {
        "tokens": np.zeros(b, np.int32),
        "positions": np.full(b, start, np.int32),
        "k_codes": rng.integers(0, 256, shape + (D,), dtype=np.uint8),
        "v_codes": rng.integers(0, 256, shape + (D,), dtype=np.uint8),
        "k_scales": scales(), "v_scales": scales(),
        "slot_state": np.where(u < 0.6, 1, np.where(u < 0.8, 2, 0))
        .astype(np.uint8),
        "slot_bits": np.asarray([2, 4, 8], np.uint8)[
            rng.integers(0, 3, (b, L, NB * BS))],
        "buf_k": bf16_bits(rng.standard_normal((b, L, G, H, D))),
        "buf_v": bf16_bits(rng.standard_normal((b, L, G, H, D))),
        "buf_len": (np.arange(b) * 5 % 8).astype(np.int32)}
    return out


def load(path) -> dict:
    """The record at ``path``: ``settings`` and its arrays by key."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["settings"] = json.loads(str(arrays["settings"]))
    return arrays


def to_torch(a: np.ndarray, key: str, device) -> torch.Tensor:
    """A record array as a tensor: bf16 keys from their uint16 bits,
    integers as int32 or int64 (``tokens``), the rest as they are."""
    if key in BF16_KEYS:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16).to(device)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def _err(got: torch.Tensor, want: np.ndarray) -> float:
    g = got.detach().float().cpu()
    if not torch.isfinite(g).all():
        return float("inf")
    return float((g - torch.from_numpy(np.asarray(want, np.float32)))
                 .abs().max())


def bf16_steps_over(got: torch.Tensor, want_bits: np.ndarray,
                    floor: float = 1e-3) -> float:
    """max |got - want| / max(floor, one bf16 step at max(|got|, |want|)):
    <= 1 when every element is at most one rounding step (or ``floor``)
    apart."""
    g = got.detach().float().cpu()
    w = torch.from_numpy(from_bf16_bits(want_bits))
    big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return float(((g - w).abs() / step.clamp_min(floor)).max())


@torch.no_grad()
def fullkv_steps(cfg: ModelConfig, params, tokens: torch.Tensor,
                 extra: dict):
    """FullKV decode steps from an empty state over ``tokens [B, n]`` at
    positions 0..n-1, each feeding the next (f32 caches of n rows, as the
    weights; ``extra`` the family's other inputs: the hybrid's conv and
    SSM states, the encoder-decoder's cross keys and values).  Returns
    the steps' logits [B, n, V], the final batch and the step."""
    b, n = tokens.shape
    dev = tokens.device
    shape = (b, cfg.num_attention_layers(), n, cfg.num_kv_heads,
             cfg.head_dim)
    fb = {"k_cache": torch.zeros(shape, device=dev),
          "v_cache": torch.zeros(shape, device=dev), **extra}
    step = SS.make_decode_step_fullkv(cfg)
    logits = []
    for i in range(n):
        pos = torch.full((b,), i, dtype=torch.int32, device=dev)
        res = step(params, {**fb, "tokens": tokens[:, i], "positions": pos,
                            "cache_len": pos})
        if cfg.family == ArchFamily.HYBRID:
            lg, fb["conv_state"], fb["ssm_state"], fb["k_cache"], \
                fb["v_cache"] = res
        else:
            lg, fb["k_cache"], fb["v_cache"] = res
        logits.append(lg)
    return torch.stack(logits, 1), fb, step


@torch.no_grad()
def replay(rec: dict, backend: str = "kernel", device: Device = "cpu"
           ) -> dict:
    """Run the record's prefill, FullKV and ThinKV steps on the port (the
    ThinKV steps on ``backend``) and hold them to the record.  Returns
    the errors, the K1 launches of the ThinKV steps and ``failed`` (empty
    when every bar holds: logits within ``PREFILL_ATOL`` /
    ``FULLKV_ATOL``, the ThinKV logits within ``THINKV_ATOL`` on the
    kernel backend, on the reference backend at the first step (and
    within ``THINKV_CHAIN_ATOL`` along the chain), the hybrid's states
    within
    ``FULLKV_ATOL`` after the FullKV steps and ``THINKV_ATOL`` after the
    ThinKV steps (the layers after the first shared block read its
    attention), the final buffers within one bf16 step of the kernel
    backend's record, ``buf_len`` exact)."""
    st = rec["settings"]
    cfg, tk = config(st), thinkv_config(st)
    params = params_from_numpy(numpy_params(cfg, st["params_seed"]), cfg,
                               device)
    dev = params.embedding.device
    prompts = torch.from_numpy(rec["prompts"]).long().to(dev)
    b, s = prompts.shape
    out: dict = {"arch": cfg.name, "backend": backend}
    fam = cfg.family
    pre = {"tokens": prompts}
    if fam == ArchFamily.ENCDEC:
        pre["frames"] = to_torch(rec["frames"], "frames", dev)
    out["prefill"] = _err(SS.make_prefill_step(None, cfg)(params, pre),
                          rec["prefill_logits"])

    # FullKV: the prompts token by token from an empty state
    if fam == ArchFamily.HYBRID:
        zero = hybrid.init_decode_state(cfg, b, dev)
        extra = {"conv_state": zero.conv, "ssm_state": zero.h}
    else:
        enc = encdec.encode(params, pre["frames"], cfg)
        ck, cv = encdec.cross_caches(params, enc, cfg)
        extra = {"cross_k": ck.transpose(0, 1).contiguous(),
                 "cross_v": cv.transpose(0, 1).contiguous()}
    logits, fb, _ = fullkv_steps(cfg, params, prompts, extra)
    out["fullkv"] = _err(logits.transpose(0, 1), rec["fullkv_logits"])
    if fam == ArchFamily.HYBRID:
        out["fullkv_states"] = max(_err(fb["conv_state"], rec["fullkv_conv"]),
                                   _err(fb["ssm_state"], rec["fullkv_ssm"]))

    # ThinKV: the recorded batch and tokens, each step's buffers feeding
    # the next
    batch = {k: to_torch(rec[k], k, dev) for k in BATCH_KEYS}
    if fam == ArchFamily.HYBRID:
        batch["conv_state"] = to_torch(rec["fullkv_conv"], "", dev)
        batch["ssm_state"] = to_torch(rec["fullkv_ssm"], "", dev)
    else:
        batch.update({k: to_torch(rec[k], k, dev) for k in CROSS_KEYS})
    step_t = SS.make_decode_step_thinkv(cfg, tk, backend=backend)
    want = rec[f"thinkv_logits_{backend}"]
    errs, k1 = [], 0
    for i in range(rec["thinkv_tokens"].shape[0]):
        batch["tokens"] = to_torch(rec["thinkv_tokens"][i], "", dev)
        n0 = ops.LAUNCHES["ct_paged_attention_fused"]
        res = step_t(params, batch)
        k1 += ops.LAUNCHES["ct_paged_attention_fused"] - n0
        if fam == ArchFamily.HYBRID:
            lg, batch["conv_state"], batch["ssm_state"] = res[:3]
        else:
            lg = res[0]
        batch["buf_k"], batch["buf_v"], batch["buf_len"] = res[-3:]
        batch["positions"] = batch["positions"] + 1
        errs.append(_err(lg, want[i]))
    out["thinkv_first"], out["thinkv"] = errs[0], max(errs)
    out["k1_launches"] = k1
    out["buf_len_equal"] = bool(np.array_equal(
        batch["buf_len"].cpu().numpy(), rec["final_buf_len"]))
    failed = [f"{k} {out[k]}" for k, bar in (
        ("prefill", PREFILL_ATOL), ("fullkv", FULLKV_ATOL),
        ("fullkv_states", FULLKV_ATOL), ("thinkv_first", THINKV_ATOL),
        ("thinkv", THINKV_ATOL if backend == "kernel"
         else THINKV_CHAIN_ATOL)) if k in out and not out[k] <= bar]
    if not out["buf_len_equal"]:
        failed.append("buf_len")
    if backend == "kernel":
        out["buffers_over_bf16_step"] = max(
            bf16_steps_over(batch[k], rec[f"final_{k}"])
            for k in ("buf_k", "buf_v"))
        if not out["buffers_over_bf16_step"] <= 1:
            failed.append(f"buffers {out['buffers_over_bf16_step']}")
        if fam == ArchFamily.HYBRID:
            out["thinkv_states"] = max(
                _err(batch["conv_state"], rec["final_conv"]),
                _err(batch["ssm_state"], rec["final_ssm"]))
            if not out["thinkv_states"] <= THINKV_ATOL:
                failed.append(f"states {out['thinkv_states']}")
    out["failed"] = failed
    return out


# ---------------------------------------------------------------------------
# the numpy helpers on the CPU
# ---------------------------------------------------------------------------

def test_bf16_bits_round_as_torch_does():
    """``bf16_bits`` rounds f32 to bf16 as torch does (to nearest, ties to
    even) and ``to_torch`` reads the bits back as that bf16 value."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32),
                        np.float32([0.0, -0.0, 1.0 + 2.0 ** -8,
                                    1.0 + 3 * 2.0 ** -8, 3.0e38])])
    want = torch.from_numpy(x).to(torch.bfloat16)
    bits = bf16_bits(x)
    assert torch.equal(to_torch(bits, "buf_k", "cpu"), want)
    np.testing.assert_array_equal(from_bf16_bits(bits), want.float().numpy())


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-medium"])
def test_thinkv_batch_has_the_step_planes(arch):
    """``thinkv_batch`` on a family's smoke form: the step's planes shaped
    [B, L, NB, BS, H, ...] over the attention layers, every state and bit
    width drawn, scales exact E4M3 values in [2^-6, 2^-4), buf_len within
    the buffer, and the same seed giving the same batch."""
    cfg = reduced(get_config(arch))
    tk = ThinKVConfig()
    a = thinkv_batch(cfg, tk, 5, 3, 7)
    b = thinkv_batch(cfg, tk, 5, 3, 7)
    dims = CC.make_dims(tk, cfg.num_attention_layers(), cfg.num_kv_heads,
                        cfg.head_dim)
    assert a["k_codes"].shape == (3, dims.L, dims.NB, dims.BS, dims.H,
                                  dims.D)
    assert a["k_scales"].shape == a["k_codes"].shape[:-1] + (dims.D // 16,)
    assert a["slot_state"].shape == (3, dims.L, dims.NS)
    assert a["buf_k"].shape == (3, dims.L, dims.G, dims.H, dims.D)
    assert set(np.unique(a["slot_state"])) == {0, 1, 2}
    assert set(np.unique(a["slot_bits"])) == {2, 4, 8}
    sc = from_bf16_bits(a["k_scales"])
    assert sc.min() >= 2.0 ** -6 and sc.max() < 2.0 ** -4
    m = sc / np.exp2(np.floor(np.log2(sc)))          # mantissa in [1, 2)
    np.testing.assert_array_equal(m * 8, np.round(m * 8))   # 3 bits
    assert (a["buf_len"] < dims.G).all() and (a["positions"] == 7).all()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
