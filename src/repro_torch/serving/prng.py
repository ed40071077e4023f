"""The port's copy of the ``jax.random`` functions the serving engine's
sampler calls, bit for bit as jax 0.9.0 computes them under its defaults
(``jax_default_prng_impl == "threefry2x32"``, ``jax_threefry_partitionable
== True``, low-dynamic-range Gumbel).  The JAX package's sampled tokens
are a function of these bits, so the port gives the same tokens from the
same logits.

A key is a ``[..., 2]`` int64 tensor holding two uint32 words (the raw
``jax.random.PRNGKey``); every function takes a batch of keys and works row
by row, as ``jax.vmap`` does.  The arithmetic is int64 with ``& 0xFFFFFFFF``
masks: torch's ``uint32`` lacks shifts and adds on both devices.  Every
function is pure in (key, data): no ``torch.Generator`` and no global
state.

* :func:`threefry2x32` — ``jax._src.prng._threefry2x32_lowering`` (20
  rounds, a key injection every four);
* :func:`prng_key` — ``jax.random.PRNGKey`` (``threefry_seed``);
* :func:`fold_in` — ``threefry_fold_in``: the hash of the count
  ``(0, data)``;
* :func:`split` — ``_threefry_split_foldlike``: key ``i`` is the hash of
  the 64-bit count ``i`` as (hi, lo) words;
* :func:`random_bits` — ``_threefry_random_bits_partitionable`` at 32 bits:
  the two hashed words of a 64-bit iota, XORed;
* :func:`uniform` — ``jax.random.uniform`` (f32): mantissa bits
  ``>> 9 | 0x3F800000`` minus 1, scaled and shifted in one rounding (XLA's
  FMA) and clamped at ``minval``;
* :func:`gumbel` — ``jax.random.gumbel`` (mode "low"): ``-log(-log(u))``
  with ``u`` uniform on [tiny, 1).  ``log`` is the device's own: XLA's CPU
  ``log`` rounds about a fifth of its results one ulp away from torch's,
  so the noise may differ by an ulp and a draw can differ from JAX's only
  where its two best perturbed scores lie within that;
* :func:`categorical` — ``jax.random.categorical`` (with replacement):
  ``argmax(gumbel + logits)``, the first index on ties.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.spans import readback

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash of the count words ``(x0, x1)`` under ``key``
    ([..., 2]); the count words broadcast against ``key[..., 0]``.  Returns
    the two hashed words."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device: Optional[Union[str, torch.device]] = None
             ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in int32's range: the seed's
    high and low 32-bit words ([2])."""
    seed = int(seed)
    hi = (seed >> 32) & MASK if seed >= 0 else 0
    with readback():
        return torch.tensor([hi, seed & MASK], dtype=torch.int64,
                            device=device)


def _iota(key: torch.Tensor, n: int):
    """The hashed words of the counts ``0 .. n-1`` under every key: a
    64-bit iota's high words are 0 below 2**32."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., None, :], torch.zeros_like(lo), lo)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the count
    ``(0, data)``."""
    data = torch.full_like(key[..., 0], int(data) & MASK)
    return torch.stack(threefry2x32(key, torch.zeros_like(data), data), -1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: ``[..., n, 2]``, key ``i`` the hash of
    the count ``i``."""
    return torch.stack(_iota(key, n), -1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` at 32 bits: ``[..., n]`` int64 words."""
    y0, y1 = _iota(key, n)
    return y0 ^ y1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``:
    ``[..., n]`` f32."""
    bits = random_bits(key, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32) \
        .view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    span = torch.full((), maxval, dtype=torch.float32, device=key.device) - lo
    # XLA fuses the scale and shift into one FMA: the f64 product of two
    # f32 values is exact, so one rounding of the f64 sum matches it
    return torch.maximum(lo, (floats.double() * span.double()
                              + lo.double()).float())


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low")."""
    return -torch.log(-torch.log(uniform(key, n, TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis of
    ``logits [..., V]`` with one key per row (``key [..., 2]``)."""
    return (gumbel(key, logits.shape[-1]) + logits).argmax(-1)
