"""Sequence-chunked cross entropy (ports ``repro/models/losses.py``:
``chunked_softmax_xent``) and the tail every family's ``loss_fn`` shares
(:func:`batch_nll`).

At a large vocabulary the full logits of a batch would not fit, so the loss
runs over chunks of the sequence (the reference's chunk rule: at most
``_MAX_CHUNK_ELEMS`` logits per chunk, the chunk stepped down until it
divides S), each chunk under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``): backward recomputes the chunk's unembed product
instead of keeping its logits.  The target's log-probability is read with
``gather``; the reference sums a one-hot mask over the vocabulary, which
gives the same value (one term and zeros) and the same gradient.  Not
ported: ``REPRO_TAKE_ALONG``, an XLA measurement toggle.

Under the sharded train step's compute split the head is vocab-parallel
(:func:`chunked_softmax_xent_split`): each rank keeps only its shard of a
chunk's logits, and the row max (a max over ``model``), the sum of the
exponentials and the target's logit (sums over ``model``) combine into
the NLL ``log Σ exp + max - logit[target]``; the chunks and their
checkpointing are the same.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as SH
from repro_torch.layers.common import wide

# max elements of one logits chunk (B * chunk * V)
_MAX_CHUNK_ELEMS = 1 << 28


def chunk_size(b: int, s: int, v: int) -> int:
    """Sequence positions per chunk for a batch of B, length S, vocab V."""
    chunk = max(1, min(s, _MAX_CHUNK_ELEMS // max(b * v, 1)))
    while s % chunk:
        chunk -= 1
    return chunk


def _chunk_nll(hb: torch.Tensor, w: torch.Tensor, tb: torch.Tensor,
               mb: torch.Tensor, softcap: float):
    """(sum of masked NLL, sum of the mask) over one chunk: hb [B, c, D],
    targets tb and mask mb [B, c]."""
    lg = hb @ w.to(hb.dtype)
    if softcap > 0:
        lg = softcap * torch.tanh(lg / softcap)
    lp = torch.log_softmax(wide(lg), dim=-1)
    nll = -lp.gather(-1, tb.long()[..., None])[..., 0]
    return (nll * mb).sum(), mb.sum()


def chunked_softmax_xent(h: torch.Tensor, unembed_w: torch.Tensor,
                         targets: torch.Tensor, mask: torch.Tensor,
                         softcap: float = 0.0) -> torch.Tensor:
    """h [B, S, D] -> the mean masked NLL (f32; f64 for f64 inputs) of
    targets [B, S] under the logits ``h @ unembed_w`` (``unembed_w`` [D,
    V]), softcapped when ``softcap`` > 0; chunked over S."""
    b, s, _ = h.shape
    chunk = chunk_size(b, s, unembed_w.shape[-1])
    tot = wide(h.new_zeros(()))
    cnt = torch.zeros_like(tot)
    mask = mask.to(tot.dtype)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        t, c = checkpoint(_chunk_nll, h[:, sl], unembed_w, targets[:, sl],
                          mask[:, sl], softcap, use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / cnt.clamp_min(1.0)


def _chunk_nll_split(hb: torch.Tensor, w: torch.Tensor, tb: torch.Tensor,
                     mb: torch.Tensor, softcap: float, mesh):
    """``_chunk_nll`` from this rank's columns w [D, V/|model|] of the
    head (see the module docstring)."""
    lg = hb @ w.to(hb.dtype)
    if softcap > 0:
        lg = softcap * torch.tanh(lg / softcap)
    lg = wide(lg)
    vl = lg.shape[-1]
    m = SH.all_reduce_max(lg.detach().amax(-1), mesh, SH.MODEL_AXIS)
    se = SH.from_model(torch.exp(lg - m[..., None]).sum(-1), mesh)
    t = tb.long() - SH.model_index(mesh) * vl
    own = (t >= 0) & (t < vl)
    tl = lg.gather(-1, t.clamp(0, vl - 1)[..., None])[..., 0]
    tl = SH.from_model(torch.where(own, tl, 0.0), mesh)
    nll = torch.log(se) + m - tl
    return (nll * mb).sum(), mb.sum()


def chunked_softmax_xent_split(h: torch.Tensor, w: torch.Tensor,
                               targets: torch.Tensor, mask: torch.Tensor,
                               softcap: float, vocab: int, mesh
                               ) -> torch.Tensor:
    """:func:`chunked_softmax_xent` of the replicated h [B, S, D] from this
    rank's columns w [D, V/|model|] of the head (a whole head: the plain
    one), chunked as one device chunks a vocabulary of ``vocab``."""
    if w.shape[-1] == vocab:
        return chunked_softmax_xent(h, w, targets, mask, softcap)
    b, s, _ = h.shape
    chunk = chunk_size(b, s, vocab)
    h = SH.to_model(h, mesh)
    tot = wide(h.new_zeros(()))
    cnt = torch.zeros_like(tot)
    mask = mask.to(tot.dtype)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        t, c = checkpoint(_chunk_nll_split, h[:, sl], w, targets[:, sl],
                          mask[:, sl], softcap, mesh, use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / cnt.clamp_min(1.0)


def batch_nll(h: torch.Tensor, unembed_w: torch.Tensor, batch: dict,
              softcap: float = 0.0, *, vocab: int = 0,
              mesh=None) -> torch.Tensor:
    """:func:`chunked_softmax_xent` of ``batch["targets"]`` [B, S] weighted
    by ``batch["loss_mask"]`` (all ones when the batch has none); with
    ``mesh``, the vocab-parallel :func:`chunked_softmax_xent_split` of a
    vocabulary of ``vocab``."""
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    if mesh is not None:
        return chunked_softmax_xent_split(h, unembed_w, targets, mask,
                                          softcap, vocab, mesh)
    return chunked_softmax_xent(h, unembed_w, targets, mask, softcap)
