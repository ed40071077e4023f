"""Token embedding, output head and the frontend stub (ports
``repro/layers/embedding.py``: ``embed`` / ``unembed`` /
``frontend_stub``)."""
from __future__ import annotations

from typing import Dict, Tuple

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


def frontend_stub_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    """The stub frontend's weight: a linear projector from the precomputed
    modality embeddings (``frontend_dim`` wide, ``d_model`` when 0) into
    ``d_model``."""
    return {"proj": (cfg.frontend_dim or cfg.d_model, cfg.d_model)}


def frontend_stub(p: dict, feats: torch.Tensor) -> torch.Tensor:
    """Project precomputed patch (or frame) embeddings feats [..., F] into
    the model's width."""
    return feats @ p["proj"].to(feats.dtype)
