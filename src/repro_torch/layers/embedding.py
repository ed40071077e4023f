"""Token embedding, output head and the frontend stub (ports
``repro/layers/embedding.py``: ``embed`` / ``unembed`` /
``frontend_stub``), and the vocab-parallel embedding of the sharded train
step (``embed_split``)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding as SH


def embed(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = p["embedding"][tokens]
    if cfg.tie_embeddings:
        x = x * cfg.d_model ** 0.5
    return x


def embed_split(w: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
                mesh) -> torch.Tensor:
    """``embed`` from this rank's rows of the table, w [V/|model|, D]
    (rows ``[r·V/|model|, (r+1)·V/|model|)``, or the whole table): each
    rank looks up the ids in its range, writes zeros elsewhere, and the
    rows are summed over ``model`` (one term and zeros, so exactly the
    looked-up row)."""
    if w.shape[0] == cfg.vocab_size:
        return embed({"embedding": w}, tokens, cfg)
    lo = SH.model_index(mesh) * w.shape[0]
    t = tokens.long() - lo
    own = (t >= 0) & (t < w.shape[0])
    x = torch.where(own[..., None], w[t.clamp(0, w.shape[0] - 1)], 0.0)
    x = SH.from_model(x, mesh)
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
