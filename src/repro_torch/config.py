"""Typed configuration for the PyTorch port (ports ``repro/config/base.py``).

The port keeps its own copy of the dataclasses it needs, field for field,
so that a configuration built here describes exactly the model and cache
the JAX package builds from the same values: :class:`ModelConfig` (with
its ``moe`` and ``ssm`` fields, the hybrid's ``hybrid_attn_every``, the
encoder-decoder's ``encoder_layers``, ``encoder_seq`` and
``cross_attention``, the VLM's ``num_image_tokens`` and ``frontend_dim``,
and ``num_attention_layers``), :class:`MoEConfig`, :class:`SSMConfig`,
:class:`ThinKVConfig`, :class:`ServeConfig`, the enums, and
:func:`reduced` (the CPU smoke-size variant).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple


class ArchFamily(str, enum.Enum):
    """Model family: ``DENSE``, ``MOE`` and ``VLM`` are served by the ThinKV
    engine (text only for the VLM, as the reference's) and the serve steps;
    ``SSM``, ``HYBRID`` and ``ENCDEC`` by ``serving/serve_step.py`` only,
    as in the reference."""

    DENSE = "dense"
    MOE = "moe"
    VLM = "vlm"
    ENCDEC = "encdec"
    SSM = "ssm"
    HYBRID = "hybrid"


class PositionEmbedding(str, enum.Enum):
    ROPE = "rope"
    SINUSOIDAL = "sinusoidal"
    LEARNED = "learned"
    NONE = "none"


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN (``repro/config/base.py:40-48``): top-k
    routing over ``num_experts``, capacity ``capacity_factor`` per group
    of ``dispatch_group`` tokens.  ``router_jitter`` and
    ``aux_loss_weight`` are training settings the port keeps for field
    equality."""

    num_experts: int = 8
    num_experts_per_token: int = 2
    capacity_factor: float = 1.25
    dispatch_group: int = 256
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """State-space mixer geometry (``repro/config/base.py:52-59``); the
    ``head_dim``, ``ngroups`` and ``chunk_size`` fields are Mamba-2's."""

    state_size: int = 16          # N
    conv_width: int = 4
    expand: int = 2               # d_inner = expand * d_model
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)
    head_dim: int = 64
    ngroups: int = 1
    chunk_size: int = 128


@dataclass(frozen=True)
class ModelConfig:
    """Architecture definition; ``head_dim`` defaults to d_model // heads."""

    name: str
    family: ArchFamily
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 1e4
    position_embedding: PositionEmbedding = PositionEmbedding.ROPE
    sliding_window: int = 0
    act: str = "silu"
    mlp_gated: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): ONE shared attention block runs after every
    # ``hybrid_attn_every`` backbone layers; 0 disables
    hybrid_attn_every: int = 0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500
    cross_attention: bool = False
    # vlm (paligemma): stub image-patch tokens prepended, and the width of
    # the precomputed patch embeddings the stub frontend projects
    num_image_tokens: int = 0
    frontend_dim: int = 0
    logit_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def num_attention_layers(self) -> int:
        """Layer invocations that own a KV cache: none for the SSM, the
        shared block's invocations for the hybrid, the decoder's
        self-attention layers for the encoder-decoder."""
        if self.family == ArchFamily.SSM:
            return 0
        if self.family == ArchFamily.HYBRID:
            return self.num_layers // max(self.hybrid_attn_every, 1)
        return self.num_layers


class ThoughtType(enum.IntEnum):
    """Thought categories; integer order is importance order rho."""

    TRANSITION = 0
    EXECUTION = 1
    REASONING = 2


@dataclass(frozen=True)
class ThinKVConfig:
    """The paper's compression hyper-parameters (Sec. 6.1 defaults)."""

    enabled: bool = True
    num_thoughts: int = 3
    refresh_interval: int = 128                   # tau
    group_size: int = 16                          # g
    block_size: int = 16
    token_budget: int = 1024
    retention_schedule: Tuple[int, ...] = (64, 32, 16, 8, 4)
    min_retention: int = 4
    precision: Tuple[int, int, int] = (2, 4, 4)   # (T, E, R) bits
    sparsity_thresholds: Tuple[float, float] = (0.55, 0.80)
    num_calib_layers: int = 4                     # |L*|
    kmeans_iters: int = 8
    max_segments: int = 512
    quantize_cross_attention: bool = True


@dataclass(frozen=True)
class ServeConfig:
    model: ModelConfig
    thinkv: ThinKVConfig = ThinKVConfig()
    max_seqs: int = 32
    prefill_len: int = 128
    max_gen_len: int = 1024
    kv_seq_len: int = 0
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (the JAX package's
    ``reduced``)."""
    kw: Dict[str, Any] = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        name=cfg.name + "-smoke",
    )
    if cfg.moe is not None:
        kw["moe"] = replace(cfg.moe, num_experts=4, dispatch_group=64)
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, state_size=min(cfg.ssm.state_size, 16),
                            head_dim=16, chunk_size=16)
    if cfg.family == ArchFamily.ENCDEC:
        kw.update(encoder_layers=2, encoder_seq=16)
    if cfg.family == ArchFamily.HYBRID:
        kw["hybrid_attn_every"] = 2
    if cfg.family == ArchFamily.VLM:
        kw.update(num_image_tokens=4, frontend_dim=32)
    if cfg.family == ArchFamily.SSM:
        kw.update(num_heads=0, num_kv_heads=0, d_ff=0)
    kw.update(overrides)
    return replace(cfg, **kw)
