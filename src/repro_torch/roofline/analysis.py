"""Roofline terms and the analytic FLOP counts (ports
``repro/roofline/analysis.py``: ``RooflineTerms``, ``model_flops_for`` and
``attention_flops_for``).

Three terms per (arch x shape x variant x mesh), each a time per rank:

    compute    = flops per rank / peak FLOP/s
    memory     = bytes per rank / HBM bandwidth
    collective = collective bytes per rank / link bandwidth

**Hardware model: one NVIDIA H100 SXM 80 GB** (NVIDIA's H100 Tensor Core
GPU datasheet, SXM column), in place of the reference's TPU v5e:

* :data:`F32_FLOPS` 67 TFLOP/s, fp32 on the CUDA cores: the peak the
  port's f32 products run against (TF32 is off,
  ``device.set_f32_numerics``), so ``PEAK_FLOPS`` is this one;
* :data:`F64_TC_FLOPS` 67 TFLOP/s, fp64 on the tensor cores (the K2 and
  K3 products);
* :data:`HBM_BW` 3.35 TB/s, HBM3.

**The link is gloo through the host, not NVLink.**  The port's ranks
share one card and move every collective through gloo's host path
(NCCL refuses two ranks on one device), so :data:`LINK_BW` is the
fastest rate measured for the sharded train step's 5.95 GB gradient
all-reduce on the H100 machine: 0.72-0.99 GB/s (PERF.md, the
``train_mesh`` phase of ``chip_smoke.py``).  The fastest keeps the
collective term a least time.

Not ported: ``xla_cost_analysis``, ``collective_bytes_from_hlo`` and
``terms_from_compiled``, which read XLA's compiled artifacts (its cost
analysis, its optimized HLO text, its memory analysis); the port counts
its collective bytes in ``distributed.sharding`` and analytically in
``launch/dryrun.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

F32_FLOPS = 67e12            # FLOP/s, fp32 CUDA cores, H100 SXM
F64_TC_FLOPS = 67e12         # FLOP/s, fp64 tensor cores, H100 SXM
HBM_BW = 3.35e12             # bytes/s, HBM3, H100 SXM
LINK_BW = 0.99e9             # bytes/s, gloo through the host (measured)

PEAK_FLOPS = F32_FLOPS
#: peak by the units a product runs on: (FLOP/s, how the datasheet names it)
PEAKS = {"f32": (F32_FLOPS, "fp32 CUDA cores 67 TFLOP/s"),
         "f64tc": (F64_TC_FLOPS, "fp64 tensor cores 67 TFLOP/s")}


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    variant: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float              # 6ND train / 2ND inference (active)
    peak_mem_bytes: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The model FLOPs' time at peak over the binding term's time."""
        t_ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_ideal / t_bound if t_bound else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops_for(cfg, shape, variant: str) -> float:
    """6·N·D for training, 2·N_active·tokens for inference steps."""
    n_active = cfg.active_param_count()
    if variant == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if variant == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def attention_flops_for(cfg, shape, variant: str) -> float:
    """Analytic attention score and value FLOPs (work 6·N·D omits; at 32k
    prefill they dominate).  Causal: ~S/2 average context."""
    la = cfg.num_attention_layers()
    if la == 0 or cfg.num_heads == 0:
        return 0.0
    d_attn = cfg.num_heads * cfg.head_dim
    b, s = shape.global_batch, shape.seq_len
    bwd = 3.0 if variant == "train" else 1.0
    # encoder-decoder: the encoder's full T_enc^2 self-attention and each
    # decoder layer's cross attention (S x T_enc)
    extra = 0.0
    if cfg.family.value == "encdec":
        te = cfg.encoder_seq
        extra += 2.0 * 2.0 * b * te * te * d_attn * cfg.encoder_layers
        if variant != "train" and variant != "prefill":
            extra = 2.0 * 2.0 * b * te * d_attn * cfg.num_layers  # decode
        else:
            extra += 2.0 * 2.0 * b * s * te * d_attn * cfg.num_layers
    if variant in ("train", "prefill"):
        return bwd * 2.0 * 2.0 * b * s * (s / 2) * d_attn * la + bwd * extra
    # decode over a cache of seq_len (FullKV) or the budget (ThinKV)
    ctx = shape.seq_len if variant == "decode_fullkv" else 2048
    return 2.0 * 2.0 * b * ctx * d_attn * la + extra
