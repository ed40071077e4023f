"""Architecture registry of the port (ports ``repro/configs/__init__.py``,
``repro/configs/r1_llama_8b.py`` and ``repro/configs/falcon_mamba_7b.py``).

* ``r1-llama-8b``: the paper's own evaluation model,
  DeepSeek-R1-Distill-Llama-8B (the llama3.1-8B architecture), 32 layers,
  d_model 4096, 32 q heads, 8 kv heads, d_ff 14336, vocab 128256; served
  by the ThinKV engine.
* ``falcon-mamba-7b``: attention-free Mamba-1, 64 layers, d_model 4096,
  vocab 65024, state 16, conv width 4, expand 2 (d_inner 8192), dt rank
  256, tied embeddings.  It has no KV cache, so ThinKV does not apply;
  it is served through ``serving/serve_step.py``.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.config import (ArchFamily, ModelConfig, PositionEmbedding,
                                SSMConfig, reduced)

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

_CONFIGS: Dict[str, ModelConfig] = {"r1-llama-8b": R1_LLAMA_8B,
                                    "falcon-mamba-7b": FALCON_MAMBA_7B}
ARCHS: List[str] = sorted(_CONFIGS)


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; the port serves {ARCHS} "
                       f"(other families: ROADMAP queue 1 item 15)")
    return _CONFIGS[arch]


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))
