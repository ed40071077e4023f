"""TBQ data formats: FP8-E4M3 group scales over NVFP4, ternary and int8 codes.

Ports ``repro/core/quantization.py`` (the channel-group cache path):
``e4m3_round``, ``_e4m3_next_up``, ``_group_scale``, the nvfp4 / ternary /
int codecs, ``quantize_group``, ``dequantize_group`` and
``dequantize_by_bitcode``.  The results are bit-exact to the reference:
one uint8 code per element (low bits used) and E4M3-valued float32 scales,
one per ``g`` channels.  The KIVI per-channel, per-tensor FP8 and packing
helpers are not on the serving path and are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

F8 = torch.float8_e4m3fn
E4M3_MAX = 448.0
NVFP4_MAX = 6.0
NVFP4_THRESHOLDS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)
GROUP = 16
SCALE_EPS = 2 ** -16
QMAX = {2: 1.0, 4: NVFP4_MAX, 8: 127.0}


def e4m3_round(x: torch.Tensor) -> torch.Tensor:
    """Round ``x`` to the FP8-E4M3 grid (returned in f32)."""
    return x.clamp(-E4M3_MAX, E4M3_MAX).to(F8).to(torch.float32)


def _e4m3_next_up(s: torch.Tensor) -> torch.Tensor:
    """Next E4M3 value above ``s`` (positive, on the grid): an exact bit
    increment of the f8 pattern, correct in the subnormal range too."""
    bits = s.to(F8).view(torch.uint8)
    up = (bits + 1).view(F8).to(torch.float32)
    # the increment past the top of the grid is NaN: stay at the maximum
    return torch.where(s >= E4M3_MAX, torch.full_like(up, E4M3_MAX), up)


def _group_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """E4M3 group scale, bumped one grid step when round-to-nearest lands
    below ``amax / qmax`` so that ``|x| / s`` never exceeds ``qmax``."""
    raw = amax.clamp_min(SCALE_EPS) / qmax
    s = e4m3_round(raw)
    s = torch.where(s * qmax < amax, _e4m3_next_up(s), s)
    return s.clamp_min(SCALE_EPS)


def nvfp4_encode(x: torch.Tensor) -> torch.Tensor:
    """x (pre-scaled, |x| <= 6) -> uint8 codes ``s << 3 | mag_idx``."""
    sign = (x < 0).to(torch.uint8)
    mag = x.abs()
    idx = torch.zeros_like(sign)
    for t in NVFP4_THRESHOLDS:
        idx = idx + (mag >= t).to(torch.uint8)
    return (sign << 3) | idx


def nvfp4_decode(codes: torch.Tensor) -> torch.Tensor:
    c = codes.to(torch.int32)
    sign = 1.0 - 2.0 * ((c >> 3) & 1).to(torch.float32)
    idx = c & 7
    exp = (idx >> 1).to(torch.float32)
    man = (idx & 1).to(torch.float32)
    mag = torch.where(idx < 2, 0.5 * man,
                      (1.0 + 0.5 * man) * torch.exp2(exp - 1.0))
    return sign * mag


def ternary_encode(x: torch.Tensor) -> torch.Tensor:
    """x (pre-scaled, |x| <= 1) -> uint8 codes {0: zero, 1: +1, 3: -1}."""
    v = torch.round(x).clamp(-1, 1).to(torch.int32)
    return torch.where(v < 0, 3, v).to(torch.uint8)


def ternary_decode(codes: torch.Tensor) -> torch.Tensor:
    c = codes.to(torch.int32) & 3
    one = torch.ones((), dtype=torch.float32, device=codes.device)
    return torch.where(c == 3, -one, torch.where(c == 1, one, 0.0 * one))


def int_encode(x: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    v = torch.round(x).clamp(-qmax - 1, qmax).to(torch.int32)
    return (v & (2 ** bits - 1)).to(torch.uint8)


def int_decode(codes: torch.Tensor, bits: int) -> torch.Tensor:
    c = codes.to(torch.int32) & (2 ** bits - 1)
    return torch.where(c >= 2 ** (bits - 1), c - 2 ** bits, c).to(
        torch.float32)


def _groups(x: torch.Tensor, g: int) -> torch.Tensor:
    d = x.shape[-1]
    if d % g:
        raise ValueError(f"head_dim {d} not divisible by group {g}")
    return x.reshape(*x.shape[:-1], d // g, g)


def quantize_group(x: torch.Tensor, bits: int, g: int = GROUP
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along channel groups of ``g``: x [..., d] ->
    (codes uint8 [..., d], scales f32 [..., d // g] on the E4M3 grid)."""
    if bits not in QMAX:
        raise ValueError(f"unsupported bits={bits}")
    xg = _groups(x.to(torch.float32), g)
    amax = xg.abs().amax(dim=-1)
    scale = _group_scale(amax, QMAX[bits])
    y = xg / scale[..., None]
    if bits == 4:
        codes = nvfp4_encode(y)
    elif bits == 2:
        codes = ternary_encode(y)
    else:
        codes = int_encode(y, 8)
    return codes.reshape(x.shape), scale


def _decode(codes: torch.Tensor, bits: int) -> torch.Tensor:
    if bits == 4:
        return nvfp4_decode(codes)
    if bits == 2:
        return ternary_decode(codes)
    if bits == 8:
        return int_decode(codes, 8)
    raise ValueError(f"unsupported bits={bits}")


def dequantize_group(codes: torch.Tensor, scales: torch.Tensor, bits: int,
                     g: int = GROUP) -> torch.Tensor:
    vg = _groups(_decode(codes, bits), g)
    return (vg * scales[..., None].to(torch.float32)).reshape(codes.shape)


def dequantize_by_bitcode(codes: torch.Tensor, scales: torch.Tensor,
                          bits_arr: torch.Tensor, g: int = GROUP
                          ) -> torch.Tensor:
    """Dequantize with a per-element bit width in {2, 4, 8}; ``bits_arr``
    broadcasts against ``codes[..., :1]`` (e.g. one width per token)."""
    vals = torch.where(bits_arr == 2, ternary_decode(codes),
                       torch.where(bits_arr == 4, nvfp4_decode(codes),
                                   int_decode(codes, 8)))
    vg = _groups(vals, g)
    return (vg * scales[..., None].to(torch.float32)).reshape(codes.shape)
