"""Serving steps (ports ``repro/serving/serve_step.py``, its SSM branches).

Each maker returns a function of ``(params, batch)``, as in the reference:

* ``make_prefill_step``: the full forward over the prompts, last-token
  logits ``[B, V]``; every layer's selective scan is one K5 launch for the
  whole batch (``kernels.ops.mamba_scan``);
* ``make_decode_step_fullkv``: ONE new token per request against the
  per-layer (conv window, SSM state), batch keys ``tokens [B]``,
  ``conv_state [B, L, W, di]`` and ``ssm_state [B, L, di, N]``, returning
  ``(logits, conv, h)``;
* ``make_decode_step_thinkv``: for the attention-free SSM family it is the
  fullkv step (ThinKV has no KV cache to compress there).

The other families' branches are not ported: the dense ThinKV and FullKV
decode steps belong to ROADMAP queue 1 item 12, the MoE, VLM,
encoder-decoder and hybrid families to item 15; each raises
NotImplementedError naming its item.  The reference jits these steps; the
port runs them eagerly.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.config import ArchFamily, ModelConfig, ThinKVConfig
from repro_torch.layers import embedding as E
from repro_torch.layers import ssm as S
from repro_torch.models import ssm_lm


def _not_ported(cfg: ModelConfig, step: str):
    item = "12" if cfg.family == ArchFamily.DENSE else "15"
    raise NotImplementedError(
        f"serve_step's {step} for the {cfg.family.value} family is not "
        f"ported yet (ROADMAP queue 1 item {item})")


def make_prefill_step(model, cfg: ModelConfig) -> Callable:
    """(params, batch) -> last-token logits [B, V]; ``batch["tokens"]``
    [B, S].  ``model`` is the factory's ``Model`` (unused, as in the
    reference)."""
    if cfg.family != ArchFamily.SSM:
        _not_ported(cfg, "prefill step")

    def step(params, batch):
        h = ssm_lm.hidden_fn(params, batch, cfg)
        return E.unembed(params.embed_params, h[:, -1], cfg)
    return step


def make_decode_step_fullkv(cfg: ModelConfig) -> Callable:
    """(params, batch) -> (logits [B, V], conv_state, ssm_state) for the
    batch keys ``tokens``, ``conv_state`` and ``ssm_state``."""
    if cfg.family != ArchFamily.SSM:
        _not_ported(cfg, "FullKV decode step")

    def step(params, batch):
        lg, new = ssm_lm.decode_step(
            params, batch["tokens"],
            S.Mamba1State(batch["conv_state"], batch["ssm_state"]), cfg)
        return lg, new.conv, new.h
    return step


def make_decode_step_thinkv(cfg: ModelConfig, tk: ThinKVConfig) -> Callable:
    """The ThinKV decode step; the SSM family is attention-free, so it is
    the fullkv step, as in the reference (whose ``backend`` option chooses
    the dense family's pool read, item 12)."""
    if cfg.family != ArchFamily.SSM:
        _not_ported(cfg, "ThinKV decode step")
    return make_decode_step_fullkv(cfg)
