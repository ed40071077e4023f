"""Architecture registry of the port (ports ``repro/configs/__init__.py``
and ``repro/configs/r1_llama_8b.py``).

The port serves the paper's own evaluation model only:
DeepSeek-R1-Distill-Llama-8B (the llama3.1-8B architecture), 32 layers,
d_model 4096, 32 q heads, 8 kv heads, d_ff 14336, vocab 128256.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.config import ArchFamily, ModelConfig, reduced

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

_CONFIGS: Dict[str, ModelConfig] = {"r1-llama-8b": R1_LLAMA_8B}
ARCHS: List[str] = sorted(_CONFIGS)


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; the port serves {ARCHS} "
                       f"(other families: ROADMAP queue 1 item 15)")
    return _CONFIGS[arch]


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))
