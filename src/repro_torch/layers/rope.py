"""Rotary position embeddings, llama rotate-half convention (ports
``repro/layers/rope.py``).  The reference writes the rotation as a
reshape/stack only to dodge an XLA CPU miscompile; the numerics here are
the same (element ``i`` pairs with ``i + d/2``)."""
from __future__ import annotations

import torch


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float = 1e4):
    """positions [...] -> (cos, sin), each [..., head_dim // 2] f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    inv = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                 device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., heads, head_dim]; cos/sin broadcast against x[..., :d//2]
    (a missing heads axis is added)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == x.dim() - 1:
        cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rope_single(x: torch.Tensor, position: torch.Tensor, theta: float
                ) -> torch.Tensor:
    """x [heads, head_dim] at a scalar position."""
    cos, sin = rope_freqs(position, x.shape[-1], theta)
    return apply_rope(x, cos[None, :], sin[None, :])
