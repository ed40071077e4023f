"""Token sampling shared by prefill and every decode trip (ports
``repro/serving/sampling.py``).

* ``temperature <= 0`` — greedy: ``argmax`` over the vocab (the first index
  on ties), the key untouched;
* ``temperature > 0, top_p >= 1`` — ``categorical(key, logits / T)``;
* ``top_p < 1`` — nucleus: in descending order of the scaled logits (a
  stable sort, ties in index order), a token survives while the softmax
  mass strictly before it is below ``top_p`` (the argmax always survives);
  the rest are masked to ``NEG_INF`` before the draw.

Every request owns a key stream: :func:`request_stream_key` folds its
arrival stamp into the engine seed, and :func:`stream_sample` splits the key
once per sampled token and draws from the subkey, so a request's tokens
depend only on its stream and its logits, never on the schedule.  The keys
and draws are JAX's own (``serving.prng``), so the tokens equal the JAX
package's from the same logits.  Every function works on a batch of rows
with one key per row, as the reference's ``jax.vmap`` over slots does.

Scaling by the temperature rounds as the reference's does at each call
site: its compiled tick (and every trip of a pack) multiplies by the f32
reciprocal ``1 / T`` (XLA rewrites division by a constant so), its eager
prefill divides; ``reciprocal`` picks the form.  Both go through device
tensors (torch computes ``x / python_float`` on the card as ``x * (1 /
T)`` in its own rounding).
"""
from __future__ import annotations

import torch

from repro_torch.serving import prng

NEG_INF = -1e30


def _top_p_filter(scaled: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask temperature-scaled logits ``[..., V]`` outside the top-p
    nucleus (see the module docstring)."""
    ordered, order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    probs = torch.softmax(ordered, dim=-1)
    keep_sorted = torch.cumsum(probs, dim=-1) - probs < top_p
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, scaled, NEG_INF)


def sample_tokens(key, logits: torch.Tensor, temperature: float,
                  top_p: float = 1.0, reciprocal: bool = False
                  ) -> torch.Tensor:
    """One token per row of ``logits [..., V]`` with the keys ``key
    [..., 2]`` (None when greedy)."""
    if temperature <= 0:
        return logits.argmax(-1)
    t = torch.full((), temperature, dtype=logits.dtype, device=logits.device)
    scaled = logits * (1.0 / t) if reciprocal else logits / t
    if top_p < 1.0:
        scaled = _top_p_filter(scaled, top_p)
    return prng.categorical(key, scaled)


def request_stream_key(seed: int, arrival: int, device=None) -> torch.Tensor:
    """The root of a request's stream ([2]): the engine seed folded with
    the request's arrival stamp."""
    return prng.fold_in(prng.prng_key(seed, device), arrival)


def stream_sample(key: torch.Tensor, logits: torch.Tensor,
                  temperature: float, top_p: float = 1.0,
                  reciprocal: bool = False):
    """Advance each row's stream by one draw: split the key, sample from
    the subkey; returns ``(tokens, next keys)``.  Greedy leaves the keys
    as they are."""
    if temperature <= 0:
        return sample_tokens(None, logits, temperature), key
    keys = prng.split(key, 2)
    return sample_tokens(keys[..., 1, :], logits, temperature, top_p,
                         reciprocal), keys[..., 0, :]
