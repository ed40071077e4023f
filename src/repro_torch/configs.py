"""Architecture registry of the port (ports ``repro/configs/__init__.py``
and, field for field, the modules under ``repro/configs/`` of the archs
below).

* ``r1-llama-8b``: the paper's own evaluation model,
  DeepSeek-R1-Distill-Llama-8B (the llama3.1-8B architecture), 32 layers,
  d_model 4096, 32 q heads, 8 kv heads, d_ff 14336, vocab 128256; served
  by the ThinKV engine.
* dense, served by the ThinKV engine: ``qwen2-7b`` (28 layers, d_model
  3584, 28 q / 4 kv heads, d_ff 18944, vocab 152064, qkv bias; the Qwen
  builds of the paper's reasoning models), ``yi-6b`` and ``yi-9b`` (32
  and 48 layers, d_model 4096, 32 q / 4 kv heads, d_ff 11008, vocab
  64000), ``mistral-large-123b`` (88 layers, d_model 12288, 96 q / 8 kv
  heads, d_ff 28672, vocab 32768);
* mixture of experts, served by the ThinKV engine: ``mixtral-8x7b`` (32
  layers, d_model 4096, 32 q / 8 kv heads, 8 experts of d_ff 14336, top
  2, vocab 32000, a 4096-token sliding window, which the ThinKV engine
  does not read, as the reference's does not) and
  ``llama4-scout-17b-a16e`` (48 layers, d_model 5120, 40 q / 8 kv heads,
  16 experts of d_ff 8192, top 1, vocab 202048; text backbone only).
* vision-language, served by the ThinKV engine (text only, as the
  reference's engine) and by the serve steps with the image prefix:
  ``paligemma-3b`` (18 layers, d_model 2048, 8 q / 1 kv head, head_dim
  256, GeGLU d_ff 16384, vocab 257216, tied embeddings scaled by
  sqrt(d_model), 256 stub image tokens of width 1152).
* ``falcon-mamba-7b``: attention-free Mamba-1, 64 layers, d_model 4096,
  vocab 65024, state 16, conv width 4, expand 2 (d_inner 8192), dt rank
  256, tied embeddings.  It has no KV cache, so ThinKV does not apply;
  it is served through ``serving/serve_step.py``.
* ``zamba2-7b``: hybrid, 81 Mamba-2 layers (d_model 3584, state 64,
  head_dim 64, 2 groups, expand 2, chunk 128) and ONE shared attention
  block (32 q / 32 kv heads of head_dim 112, SwiGLU d_ff 14336) after
  every 6th, 13 invocations; vocab 32000.  Served through
  ``serving/serve_step.py`` (ThinKV on the shared block's invocations).
* ``whisper-medium``: encoder-decoder, 24 encoder and 24 decoder layers,
  d_model 1024, 16 heads (MHA), plain GELU d_ff 4096, vocab 51865, 1500
  stub encoder frames, learned positions, tied embeddings (scaled by
  sqrt(d_model), as the reference scales every tied embedding).  Served
  through ``serving/serve_step.py`` (ThinKV on the decoder's
  self-attention, the cross KV TBQ'd at 4 bits).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.config import (ArchFamily, ModelConfig, MoEConfig,
                                PositionEmbedding, SSMConfig, reduced)

R1_LLAMA_8B = ModelConfig(
    name="r1-llama-8b",
    family=ArchFamily.DENSE,
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    act="silu",
    mlp_gated=True,
)

FALCON_MAMBA_7B = ModelConfig(
    name="falcon-mamba-7b",
    family=ArchFamily.SSM,
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    position_embedding=PositionEmbedding.NONE,
    ssm=SSMConfig(state_size=16, conv_width=4, expand=2, dt_rank=256),
    tie_embeddings=True,
)

QWEN2_7B = ModelConfig(
    name="qwen2-7b",
    family=ArchFamily.DENSE,
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    act="silu",
    mlp_gated=True,
)

YI_6B = ModelConfig(
    name="yi-6b",
    family=ArchFamily.DENSE,
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5e6,
    act="silu",
    mlp_gated=True,
)

YI_9B = ModelConfig(
    name="yi-9b",
    family=ArchFamily.DENSE,
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5e6,
    act="silu",
    mlp_gated=True,
)

MISTRAL_LARGE_123B = ModelConfig(
    name="mistral-large-123b",
    family=ArchFamily.DENSE,
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1e6,
    act="silu",
    mlp_gated=True,
)

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    family=ArchFamily.MOE,
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1e6,
    act="silu",
    mlp_gated=True,
    moe=MoEConfig(num_experts=8, num_experts_per_token=2),
)

LLAMA4_SCOUT_17B_A16E = ModelConfig(
    name="llama4-scout-17b-a16e",
    family=ArchFamily.MOE,
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=5e5,
    act="silu",
    mlp_gated=True,
    moe=MoEConfig(num_experts=16, num_experts_per_token=1),
)

# repro/configs/paligemma_3b.py: SigLIP + Gemma with the frontend a stub
# (precomputed patch embeddings, 224 px / 14 px -> 256 image tokens,
# linearly projected and prepended); head_dim 256, GeGLU, one kv head,
# embeddings tied and scaled by sqrt(d_model)
PALIGEMMA_3B = ModelConfig(
    name="paligemma-3b",
    family=ArchFamily.VLM,
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    tie_embeddings=True,
    act="gelu",
    mlp_gated=True,
    num_image_tokens=256,
    frontend_dim=1152,
)

# repro/configs/zamba2_7b.py: a Mamba-2 backbone and one shared attention
# block (attention + MLP, one weight copy) after every 6th layer
ZAMBA2_7B = ModelConfig(
    name="zamba2-7b",
    family=ArchFamily.HYBRID,
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    hybrid_attn_every=6,
    ssm=SSMConfig(state_size=64, conv_width=4, expand=2, head_dim=64,
                  ngroups=2, chunk_size=128),
)

# repro/configs/whisper_medium.py: the conv/mel frontend is a stub (the
# encoder takes precomputed frame embeddings, 1500 x d_model)
WHISPER_MEDIUM = ModelConfig(
    name="whisper-medium",
    family=ArchFamily.ENCDEC,
    num_layers=24,
    encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    cross_attention=True,
    position_embedding=PositionEmbedding.LEARNED,
    act="gelu",
    mlp_gated=False,
    tie_embeddings=True,
)

_CONFIGS: Dict[str, ModelConfig] = {
    c.name: c for c in (R1_LLAMA_8B, FALCON_MAMBA_7B, QWEN2_7B, YI_6B, YI_9B,
                        MISTRAL_LARGE_123B, MIXTRAL_8X7B,
                        LLAMA4_SCOUT_17B_A16E, PALIGEMMA_3B, ZAMBA2_7B,
                        WHISPER_MEDIUM)}
ARCHS: List[str] = sorted(_CONFIGS)


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCHS}")
    return _CONFIGS[arch]


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))
