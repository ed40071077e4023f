"""Typed configuration for the PyTorch port (ports ``repro/config/base.py``).

The port keeps its own copy of the dataclasses it needs, field for field,
so that a configuration built here describes exactly the model and cache
the JAX package builds from the same values: :class:`ModelConfig` (with
its ``moe`` and ``ssm`` fields, the hybrid's ``hybrid_attn_every``, the
encoder-decoder's ``encoder_layers``, ``encoder_seq`` and
``cross_attention``, the VLM's ``num_image_tokens`` and ``frontend_dim``,
and the counters ``attention_free``, ``num_attention_layers``,
``param_count``, ``active_param_count`` and ``kv_bytes_per_token_fullkv``),
:class:`MoEConfig`, :class:`SSMConfig`, :class:`ThinKVConfig` (with
``max_blocks_per_seq_factor`` and ``avg_bits``), :class:`ServeConfig`, the
training settings (:class:`MeshConfig`, :class:`OptimizerConfig`,
:class:`TrainConfig`), the enums, the assigned input shapes
(:class:`InputShape`, :data:`SHAPES`, :func:`shape_cells`),
:func:`reduced` (the CPU smoke-size variant) and :func:`config_to_dict`.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import tempfile
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

    @property
    def attention_free(self) -> bool:
        return self.family == ArchFamily.SSM

    def num_attention_layers(self) -> int:
        """Layer invocations that own a KV cache: none for the SSM, the
        shared block's invocations for the hybrid, the decoder's
        self-attention layers for the encoder-decoder."""
        if self.family == ArchFamily.SSM:
            return 0
        if self.family == ArchFamily.HYBRID:
            return self.num_layers // max(self.hybrid_attn_every, 1)
        return self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count, the N of the roofline's 6·N·D (the
        reference's formula, family by family; it counts what the
        reference's formula counts, not the port's parameter tensors)."""
        d, h, kv, hd, ff, v = (self.d_model, self.num_heads,
                               self.num_kv_heads, self.head_dim,
                               self.d_ff, self.vocab_size)
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.qkv_bias:
            attn += (h + 2 * kv) * hd
        mlp = d * ff * (3 if self.mlp_gated else 2)
        if self.moe is not None:
            mlp = mlp * self.moe.num_experts + d * self.moe.num_experts
        per_layer = attn + mlp + 2 * d
        total = emb + self.num_layers * per_layer
        if self.family == ArchFamily.SSM:
            di = self.ssm.expand * d
            n = self.ssm.state_size
            dt_rank = self.ssm.dt_rank or -(-d // 16)
            per = (d * 2 * di + di * self.ssm.conv_width
                   + di * (dt_rank + 2 * n) + dt_rank * di + di + di * d
                   + 2 * d)
            total = emb + self.num_layers * per
        if self.family == ArchFamily.HYBRID:
            di = self.ssm.expand * d
            n = self.ssm.state_size
            nh = di // self.ssm.head_dim
            per = (d * (2 * di + 2 * self.ssm.ngroups * n + nh)
                   + di * self.ssm.conv_width + di + nh + di * d + 2 * d)
            shared = attn + d * ff * 3 + 2 * d       # the one shared block
            total = emb + self.num_layers * per + shared
        if self.family == ArchFamily.ENCDEC:
            # the encoder stack and the decoder's cross attention
            enc_per = attn + mlp + 2 * d
            cross = d * h * hd + 2 * d * kv * hd + h * hd * d + d
            total += self.encoder_layers * enc_per + self.num_layers * cross
        return int(total)

    def active_param_count(self) -> int:
        """Parameters one token meets (MoE: only its top-k experts)."""
        if self.moe is None:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        e, k = self.moe.num_experts, self.moe.num_experts_per_token
        inactive = self.num_layers * d * ff * 3 * (e - k)
        return int(self.param_count() - inactive)

    def kv_bytes_per_token_fullkv(self) -> int:
        """bf16 K+V bytes per generated token over every cached layer."""
        return 2 * 2 * self.kv_dim * self.num_attention_layers()


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

    @property
    def max_blocks_per_seq_factor(self) -> float:
        """Physical blocks per sequence over budget / block_size: slack for
        the in-flight unquantized group and the per-segment minimums."""
        return 1.5

    def avg_bits(self, thought_mix=(0.15, 0.45, 0.40)) -> float:
        """Mean KV precision in bits under a (T, E, R) thought mix."""
        t, e, r = thought_mix
        pt, pe, pr = self.precision
        return t * pt + e * pe + r * pr


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


@dataclass(frozen=True)
class MeshConfig:
    """Parallelism layout (``repro/config/base.py:231-256``): axis names
    and sizes; their product is the number of ranks."""

    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axis_names

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]

    @property
    def dp_degree(self) -> int:
        return self.axis_size("data") * self.axis_size("pod")


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW with linear warmup and cosine decay, global-norm clipping
    (``repro/config/base.py:260-269``)."""

    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


@dataclass(frozen=True)
class TrainConfig:
    """A training run (``repro/config/base.py:273-289``); checkpoints
    land in ``checkpoint_dir`` (by default under the temporary directory).
    ``remat`` checkpoints each layer body (the reference's ``"full"``; its
    trainer treats ``"dots"`` the same).  ``mesh`` is the layout: the train
    CLI starts its ranks from it, and ``Trainer(mesh=)`` refuses a
    ``TrainMesh`` of another shape or other axes.  Not ported: the reference's ``grad_compression`` and
    ``pipeline_stages``, which no code of the reference reads (compression
    is the trainer's ``grad_transform``)."""

    model: ModelConfig
    mesh: MeshConfig = MeshConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    seq_len: int = 4096
    global_batch: int = 256
    microbatches: int = 1                 # gradient accumulation steps
    remat: bool = True
    steps: int = 100
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class InputShape:
    """An input shape assigned to every architecture: ``kind`` is
    ``"train"``, ``"prefill"`` or ``"decode"``."""

    name: str
    seq_len: int
    global_batch: int
    kind: str


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_cells(arch_cfg: ModelConfig):
    """The shape cells of an architecture: all four for every arch
    (long_500k runs budget-bound under ThinKV for the attention archs)."""
    return [SHAPES[s] for s in ("train_4k", "prefill_32k", "decode_32k",
                                "long_500k")]


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


def config_to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
