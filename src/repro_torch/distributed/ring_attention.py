"""Ring (context-parallel) causal flash attention over a mesh axis (ports
``repro/distributed/ring_attention.py``: ``_flash_chunk``,
``ring_attention``).

When the query heads do not divide the ``model`` axis (or d_model/|model|
< 128), the reference shards attention over the SEQUENCE instead: each
device holds its q chunk and rotates the K/V chunks around the ring with
``ppermute``, accumulating flash statistics (m, l, acc); causality is
enforced per (q-chunk, kv-chunk) pair from global offsets, and a fully
masked pair still rotates but adds zeros.

In the port the ranks of one ``model`` group hold the same (replicated)
q, k and v, as the sharded train step computes them.  A rank takes its
sequence chunk, runs the ring over the group (a send to rank i-1 and a
receive from rank i+1 per step, ``sharding.permute``), and the chunks of
the output are all-gathered back.  Autograd runs through it: the chunk
slice's backward all-gathers the chunk gradients (each rank then holds
the whole gradient of the replicated input), the permute's backward is
the inverse permute (a K/V chunk's gradient returns to its owner), and
the output gather's backward takes this rank's chunk of the (replicated)
upstream gradient.  The reference permutes once more after the last
chunk and drops the result; the port skips that send.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as SH

NEG_INF = -1e30


def _flash_chunk(q, k, v, mask, m_prev, l_prev, acc):
    """One (q-chunk x kv-chunk) flash update.  q [B,Sq,H,G,d]; k/v
    [B,Sk,H,d]; mask [Sq,Sk] bool; f32 statistics."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k) / float(q.shape[-1]) ** 0.5
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(mask[None, None, None], p, 0.0)
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v)
    return m_new, l_new, acc


class _Chunk(torch.autograd.Function):
    """Forward: block ``i`` of ``dim`` (of ``n``).  Backward: the chunk
    gradients of every rank of the axis, gathered (the input is whole on
    every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return SH.shard_of(x, (None,) * dim + (axis,), mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return SH.all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, \
            None


class _Gather(torch.autograd.Function):
    """Forward: every rank's chunk along ``dim``, in block order.
    Backward: this rank's chunk of the (replicated) upstream gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return SH.all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return SH.shard_of(g, (None,) * ctx.dim + (ctx.axis,), ctx.mesh) \
            .contiguous(), None, None, None


def ring_attention(q, k, v, mesh, axis: str = "model"):
    """q [B,S,Hq,d], k/v [B,S,Hkv,d], whole on every rank of ``axis`` ->
    causal attention [B,S,Hq,d] in q's dtype, whole on every rank; the
    sequence is split over ``axis`` (S must divide).  GQA groups the q
    heads over the kv heads."""
    b, s_glob, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    size = SH.axes_size(mesh, axis)
    if s_glob % size:
        raise ValueError(f"ring attention over {size} ranks needs S "
                         f"divisible by {size} (got {s_glob})")
    if size == 1:
        ql, kl, vl = q, k, v
    else:
        ql, kl, vl = (_Chunk.apply(t, mesh, axis, 1) for t in (q, k, v))
    idx = SH.block_index(mesh, axis)
    sq = ql.shape[1]
    qh = ql.reshape(b, sq, hkv, g, d).float()
    rows = torch.arange(sq, device=q.device)
    m_a = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l_a = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    kc, vc = kl.float(), vl.float()
    for step in range(size):
        src = (idx + step) % size            # whose chunk we hold now
        mask = (idx * sq + rows)[:, None] >= (src * sq + rows)[None, :]
        m_a, l_a, acc = _flash_chunk(qh, kc, vc, mask, m_a, l_a, acc)
        if step + 1 < size:
            kc = SH.permute_grad(kc, mesh, axis, -1)
            vc = SH.permute_grad(vc, mesh, axis, -1)
    out = acc / l_a.clamp_min(1e-30)[..., None]
    # [B,H,G,Sq,d] -> [B,Sq,Hq,d]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    return out if size == 1 else _Gather.apply(out, mesh, axis, 1)
