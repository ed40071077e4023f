"""Token embedding and output head (ports ``repro/layers/embedding.py``:
``embed`` / ``unembed``)."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig


def embed(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = p["embedding"][tokens]
    if cfg.tie_embeddings:
        x = x * cfg.d_model ** 0.5
    return x


def unembed(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    return h @ w.to(h.dtype)
