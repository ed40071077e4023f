"""A configuration file as the benchmark runs it, and its weights.

The file holds the published ``config.json``'s keys (changed ones listed in
``BENCHMARK.json``'s ``reduced``), ThinKV's settings (``thinkv``), the
serving settings (``serving``: slots, backend, prefill chunk, the weights'
dtype) and, for a mixture of experts, the routing the program applies
(``moe_routing``: a capacity factor of ``num_local_experts /
num_experts_per_tok`` gives every expert room for every row of a group, so
no choice is dropped, as the published model routes).  :func:`arch` reads the
model's shape from it (a plain dict, which the reference reads, as it
reads ``thinkv``), and :func:`port_config` builds the measured program's
configuration objects.

Weights are drawn on the device from the seed by one generator, one call
per stacked weight, in a fixed order: the program gets them in its own
parameter tensors (:func:`fill`), and the reference gets the same values
drawn again after the program is freed (:func:`draw`).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

MOE_ARCHS = ("MixtralForCausalLM",)
BIAS_ARCHS = ("Qwen2ForCausalLM",)


def arch(cfg: dict) -> dict:
    """The model's shape as the reference reads it."""
    kind = cfg["architectures"][0]
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    out = {"layers": cfg["num_hidden_layers"], "d_model": d,
           "heads": heads, "kv_heads": cfg["num_key_value_heads"],
           "head_dim": cfg.get("head_dim") or d // heads,
           "d_ff": cfg["intermediate_size"], "vocab": cfg["vocab_size"],
           "rope_theta": cfg["rope_theta"], "norm_eps": cfg["rms_norm_eps"],
           "qkv_bias": kind in BIAS_ARCHS}
    if kind in MOE_ARCHS:
        out.update(experts=cfg["num_local_experts"],
                   experts_per_token=cfg["num_experts_per_tok"],
                   capacity_factor=cfg["moe_routing"]["capacity_factor"],
                   dispatch_group=cfg["moe_routing"]["dispatch_group"])
    return out


def params_in_products(a: dict) -> int:
    """Parameters a token meets in products: attention, the MLP (for a
    mixture of experts the router and its experts per token) and the head;
    not the embedding table, biases or norms."""
    d, q = a["d_model"], a["heads"] * a["head_dim"]
    kv = a["kv_heads"] * a["head_dim"]
    attn = 2 * d * q + 2 * d * kv
    if "experts" in a:
        ffn = d * a["experts"] + a["experts_per_token"] * 3 * d * a["d_ff"]
    else:
        ffn = 3 * d * a["d_ff"]
    return a["layers"] * (attn + ffn) + d * a["vocab"]


def shapes(a: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every weight, in drawing order; init is
    ``fan_in`` (std = fan-in ** -0.5), ``ones`` or ``normal:<std>``."""
    L, d, ff, V = a["layers"], a["d_model"], a["d_ff"], a["vocab"]
    q, kv = a["heads"] * a["head_dim"], a["kv_heads"] * a["head_dim"]
    out = [("embedding", (V, d), "normal:0.02"),
           ("lm_head", (d, V), "fan_in"),
           ("final_norm", (d,), "ones"),
           ("wq", (L, d, q), "fan_in"), ("wk", (L, d, kv), "fan_in"),
           ("wv", (L, d, kv), "fan_in"), ("wo", (L, q, d), "fan_in"),
           ("norm1", (L, d), "ones"), ("norm2", (L, d), "ones")]
    if a["qkv_bias"]:
        out += [("bq", (L, q), "normal:0.05"), ("bk", (L, kv), "normal:0.05"),
                ("bv", (L, kv), "normal:0.05")]
    if "experts" in a:
        E = a["experts"]
        out += [("router", (L, d, E), "normal:0.02"),
                ("w_up", (L, E, d, ff), "fan_in"),
                ("w_gate", (L, E, d, ff), "fan_in"),
                ("w_down", (L, E, ff, d), "fan_in")]
    else:
        out += [("w_up", (L, d, ff), "fan_in"),
                ("w_gate", (L, d, ff), "fan_in"),
                ("w_down", (L, ff, d), "fan_in")]
    return out


def _init(t: torch.Tensor, how: str, gen: torch.Generator) -> None:
    if how == "ones":
        t.fill_(1.0)
    elif how == "fan_in":
        t.normal_(0.0, t.shape[-2] ** -0.5, generator=gen)
    else:
        t.normal_(0.0, float(how.split(":")[1]), generator=gen)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def fill(a: dict, seed: int, tensors: Dict[str, torch.Tensor]) -> None:
    """Draw every weight into ``tensors`` (by name, f32, on one device)."""
    dev = tensors["embedding"].device
    gen = generator(seed, dev)
    for name, shape, how in shapes(a):
        t = tensors[name]
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, the "
                             f"configuration gives {shape} float32")
        _init(t, how, gen)


def draw(a: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Fresh weights, equal to what :func:`fill` gives on this device."""
    out = {name: torch.empty(shape, dtype=torch.float32, device=device)
           for name, shape, _ in shapes(a)}
    fill(a, seed, out)
    return out


def port_config(cfg: dict, name: str, temperature: float = 0.0,
                top_p: float = 1.0, seed: int = 0):
    """The measured program's (ServeConfig, ThinKV engine keywords), its
    requests sampled at ``temperature`` and ``top_p`` (the mix's) on key
    streams rooted at ``seed``."""
    from repro_torch.config import (ArchFamily, ModelConfig, MoEConfig,
                                    ServeConfig, ThinKVConfig)
    a = arch(cfg)
    moe = None
    if "experts" in a:
        moe = MoEConfig(num_experts=a["experts"],
                        num_experts_per_token=a["experts_per_token"],
                        capacity_factor=a["capacity_factor"],
                        dispatch_group=a["dispatch_group"])
    mc = ModelConfig(
        name=name, family=ArchFamily.MOE if moe else ArchFamily.DENSE,
        num_layers=a["layers"], d_model=a["d_model"], num_heads=a["heads"],
        num_kv_heads=a["kv_heads"], d_ff=a["d_ff"], vocab_size=a["vocab"],
        head_dim=a["head_dim"], qkv_bias=a["qkv_bias"],
        norm_eps=a["norm_eps"], rope_theta=float(a["rope_theta"]),
        act=cfg["hidden_act"], mlp_gated=True, moe=moe,
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)))
    tk = cfg["thinkv"]
    tkc = ThinKVConfig(
        refresh_interval=tk["refresh_interval"], group_size=tk["group_size"],
        block_size=tk["block_size"], token_budget=tk["token_budget"],
        retention_schedule=tuple(tk["retention_schedule"]),
        min_retention=tk["min_retention"], precision=tuple(tk["precision"]),
        sparsity_thresholds=tuple(tk["sparsity_thresholds"]),
        num_calib_layers=tk["num_calib_layers"],
        kmeans_iters=tk["kmeans_iters"], max_segments=tk["max_segments"])
    sv = cfg["serving"]
    if sv["weights_dtype"] != "float32":
        raise ValueError(f"{name}: the program serves float32 weights, the "
                         f"configuration asks for {sv['weights_dtype']}")
    scfg = ServeConfig(model=mc, thinkv=tkc, max_seqs=sv["max_seqs"],
                       temperature=float(temperature), top_p=float(top_p),
                       seed=int(seed) % 2 ** 31)
    return scfg, {"backend": sv["backend"],
                  "prefill_chunk": sv["prefill_chunk"],
                  "policy": tk["policy"]}


def port_params(scfg, a: dict, seed: int, device):
    """The program's parameter object with the seeded weights in it."""
    from repro_torch.models.lm import LM
    lm = LM(scfg.model, torch.device(device))
    fill(a, seed, dict(lm.named_parameters()))
    return lm
