"""ThinKV serving engine, first slice (ports ``repro/serving/engine.py`` for
a dense model served greedily on an unpressured pool).

Same dataflow as the reference (see its module docstring):

* the decode tick is the two-pass ATTENTION-LATE form — embed, a trunk
  pass over layers (qkv + RoPE, TBQ-buffer write, MLP residual), ONE fused
  attention over the stacked queries of every layer and slot, then the
  attention-output residuals, ``engine_advance`` per slot, logits and
  greedy sampling.  It is the reference's function, kept exactly;
* chunked prefill: 128-multiple big chunks (intra-chunk attention at full
  precision, one sparsity value per chunk, C/g commits in order), then
  g-sized chunks for the tail;
* group commit, budget eviction, thought refresh and TBE annealing on the
  shared paged pool.

Backends: ``kernel`` runs the hand-written CUDA kernels through
``kernels.ops`` (K1 fused decode attention per tick; K2 frozen-pool + K3
intra-chunk attention per prefill layer, big chunks and g-chunks alike;
K4 at every commit); ``reference`` runs the dense dequantize-and-softmax
path (the parity oracle).  ``auto`` is ``kernel`` on CUDA and
``reference`` on the CPU.  On the CPU the kernel backend's wrappers run
their plain versions.

Host control flow replaces ``lax.cond``: commits and refreshes are decided
from host mirrors of each slot's ``num_tokens`` / ``buf_len``, and the
sparsity probe runs only on ticks where some slot refreshes.

Not in this slice (each raises NotImplementedError naming the ROADMAP
item): an oversubscribed pool with preemption, the prefix cache / COW,
multi-tick dispatch, forks, sampling at temperature > 0, tensor
parallelism, the drift probe, other retention policies, MoE/VLM families.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.config import ArchFamily, ServeConfig
from repro_torch.core import ct_cache as CC
from repro_torch.core import quantization as Q
from repro_torch.core import thinkv as TV
from repro_torch.core.policy import get_policy
from repro_torch.core.thoughts import row_sparsity
from repro_torch.device import resolve_device, set_f32_numerics
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as KR
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers.common import softcap
from repro_torch.layers.mlp import mlp
from repro_torch.layers.norms import rmsnorm
from repro_torch.models.lm import LM, init_params
from repro_torch.serving.scheduler import Request, Scheduler

NEG_INF = -1e30


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 "
                              f"item {item})")


def _sample_slots(logits: torch.Tensor) -> torch.Tensor:
    """Every slot's next token from ``logits [R, V]``: greedy argmax (the
    first index on ties, as ``jnp.argmax``); sampling at temperature > 0
    is not ported yet (ROADMAP queue 1 item 11)."""
    return logits.argmax(-1)


def _joint_attend(q, k_pool, v_pool, valid_pool, buf_k, buf_v, buf_mask):
    """Dense joint attention over (pool ∪ buffer/chunk) with probs, batched
    over B request slots.

    q [B, T, Hq, D]; k_pool/v_pool [B, NS, H, D]; valid_pool [B, NS];
    buf_k/buf_v [B, G, H, D]; buf_mask [B, T, G].  Returns (out
    [B, T, Hq, D], probs [B, T, H, gq, NS+G], valid [B, T, NS+G]).
    """
    b, t, hq, hd = q.shape
    h = k_pool.shape[2]
    k = torch.cat([k_pool, buf_k.to(k_pool.dtype)], 1)
    v = torch.cat([v_pool, buf_v.to(v_pool.dtype)], 1)
    valid = torch.cat([valid_pool[:, None].expand(b, t, -1), buf_mask], 2)
    qh = q.reshape(b, t, h, hq // h, hd).float()
    s = torch.einsum("bthgd,bnhd->bthgn", qh, k.float()) / math.sqrt(hd)
    vm = valid[:, :, None, None, :]
    p = torch.softmax(torch.where(vm, s, NEG_INF), dim=-1)
    p = torch.where(vm, p, 0.0)
    out = torch.einsum("bthgn,bnhd->bthgd", p, v.float())
    return out.reshape(b, t, hq, hd).to(q.dtype), p, valid


def _probs_sparsity(p_t: torch.Tensor, valid_t: torch.Tensor) -> torch.Tensor:
    """Sparsity of one query's probs per slot: p_t [B, H, gq, N], valid_t
    [B, N] -> [B] (max-pool over the q group, renormalize, mean over
    heads)."""
    vm = valid_t[:, None, :]
    pooled = torch.where(vm, p_t.amax(dim=2), 0.0)
    pooled = pooled / pooled.sum(-1, keepdim=True).clamp_min(1e-30)
    return row_sparsity(pooled, vm.expand_as(pooled)).mean(-1)


@dataclasses.dataclass
class Prefix:
    """Result of :meth:`ThinKVEngine.prefill`: the KV lives in the pool
    under ``slot``'s block table (resident form only in this slice)."""

    length: int
    first_token: int
    logits: np.ndarray
    slot: int


@dataclasses.dataclass
class TickResult:
    """One decode tick: next tokens [R], validity [R], logits [R, V]."""

    tick: int
    tokens: np.ndarray
    valid: np.ndarray
    logits: np.ndarray
    alloc_fail: bool


class ThinKVEngine:
    """Greedy dense-LM serving with ThinKV on one card (or the CPU)."""

    def __init__(self, cfg: ServeConfig, params: Optional[LM] = None,
                 lstar: Optional[Sequence[int]] = None,
                 backend: str = "auto", pool_blocks: Optional[int] = None,
                 record_logits: bool = False,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 ticks_per_dispatch: int = 1, allow_forks: bool = False,
                 mesh=None, policy=None, drift_probe: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        if cfg.model.family == ArchFamily.SSM:
            raise ValueError(
                f"{cfg.model.name} is attention-free: it has no KV cache for "
                f"ThinKV to compress; serve it through serving/serve_step.py")
        if cfg.model.family != ArchFamily.DENSE:
            _not_ported(f"the {cfg.model.family.value} family", "15")
        if prefix_cache:
            _not_ported("the prefix cache", "10")
        if ticks_per_dispatch != 1:
            _not_ported("multi-tick dispatch", "11")
        if allow_forks:
            _not_ported("forked generation", "11")
        if cfg.temperature > 0:
            _not_ported("sampling at temperature > 0", "11")
        if mesh is not None:
            _not_ported("tensor-parallel serving", "13")
        if drift_probe:
            _not_ported("the drift probe", "12")
        if cfg.thinkv.refresh_interval % cfg.thinkv.group_size:
            raise ValueError("chunked prefill needs tau % g == 0")
        self.device = resolve_device(device)
        set_f32_numerics()
        if backend == "auto":
            backend = "kernel" if self.device.type == "cuda" else "reference"
        if backend not in ("kernel", "reference"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.cfg, self.mcfg, self.tk = cfg, cfg.model, cfg.thinkv
        self.policy = get_policy(policy)
        self.policy.validate(cfg.thinkv)
        self.model = params if params is not None else \
            init_params(cfg.model, cfg.seed, self.device)
        if self.model.embedding.device.type != self.device.type:
            raise ValueError(f"params on {self.model.embedding.device}, "
                             f"engine on {self.device}")
        mc = cfg.model
        self.dims = CC.make_dims(self.tk, mc.num_layers, mc.num_kv_heads,
                                 mc.head_dim)
        n_lstar = min(self.tk.num_calib_layers, mc.num_layers)
        self.lstar = tuple(int(x) for x in (
            lstar if lstar is not None else range(n_lstar)))
        R = cfg.max_seqs
        self.scheduler = Scheduler(R)
        self.num_pool_blocks = pool_blocks if pool_blocks is not None \
            else R * self.dims.NB
        if self.num_pool_blocks < R * self.dims.NB:
            _not_ported("an oversubscribed pool (pool_blocks < max_seqs * "
                        "NB) with preemption", "10")
        self.pool = CC.init_global_pool(self.dims, self.num_pool_blocks,
                                        self.device)
        self.tables = CC.init_block_table(self.dims, self.device, batch=R)
        self.caches = CC.init_cache(self.dims, self.device, batch=R)
        self._fresh = CC.init_cache(self.dims, self.device)
        if prefill_chunk is None:
            prefill_chunk = 128 if 128 % self.dims.G == 0 else 0
        if prefill_chunk and (prefill_chunk % 128 or
                              prefill_chunk % self.dims.G):
            raise ValueError("large prefill chunks must be 128-multiples "
                             "aligned with commits")
        self.prefill_chunk = prefill_chunk
        self.record_logits = record_logits
        self.request_logits: Dict[int, List[np.ndarray]] = {}
        self.metrics: Dict[str, float] = {
            "ticks": 0, "tokens": 0, "dispatches": 0, "prefill_tokens": 0,
            "prefill_chunks": 0, "prefill_big_chunks": 0,
            "admissions": 0, "queue_wait_ticks": 0,
            "prefill_s": 0.0, "decode_s": 0.0}
        self._queued_at: Dict[int, int] = {}
        # host mirrors of every slot's num_tokens / buf_len: commits and
        # refreshes are decided here, never read back from the card
        self._slot_ntok = np.zeros(R, np.int64)
        self._slot_buflen = np.zeros(R, np.int64)
        self._feed = np.zeros(R, np.int64)
        self._fails: List[torch.Tensor] = []     # commit-failure flags
        # worst-case fresh blocks one group commit claims per layer
        self._cc = -(-self.dims.G // self.dims.BS)

    # ------------------------------------------------------------------
    # attention helpers shared by tick + prefill
    # ------------------------------------------------------------------

    def _dense_layer(self, l: int, q, slots, k_buf, v_buf, buf_mask):
        """Reference attention of layer ``l`` for the given slots: gather
        each slot's view through its table, dense-dequantize, joint softmax
        with the buffer/chunk.  q [B, T, Hq, D]; slots [B] (long);
        k_buf/v_buf [B, G, H, D]; buf_mask [B, T, G]."""
        dims, pv = self.dims, self.pool.view
        table = self.tables[slots, l].clamp_min(0).long()       # [B, NB]
        b = table.shape[0]

        def flat(plane):
            return plane[l][table].reshape(b, dims.NS, *plane.shape[3:])
        bits = self.caches.slot_bits[slots, l].to(torch.int32)[..., None,
                                                               None]
        kd = Q.dequantize_by_bitcode(flat(pv.k_codes),
                                     flat(pv.k_scales).float(), bits)
        vd = Q.dequantize_by_bitcode(flat(pv.v_codes),
                                     flat(pv.v_scales).float(), bits)
        valid = self.caches.slot_state[slots, l] == CC.VALID
        return _joint_attend(q, kd, vd, valid, k_buf, v_buf, buf_mask)

    def _chunk_kernel(self, q, l: int, i: int, k_chunk, v_chunk,
                      n_valid: Optional[int]):
        """Kernel path of one prefill chunk of slot ``i``: every chunk query
        attends the frozen pool (K2, queries folded into the q-group axis),
        merged with the causal intra-chunk partition (K3; ``n_valid`` masks
        the padded keys of a g-sized chunk, None for a full big chunk)."""
        dims, pv = self.dims, self.pool.view
        c, hq, hd = q.shape
        h = k_chunk.shape[1]
        gq = hq // h
        qh = q.reshape(c, h, gq, hd).transpose(0, 1) \
            .reshape(1, h, c * gq, hd).float().contiguous()
        shp = (1, dims.NB, dims.BS)
        o_p, m_p, l_p = K.paged_decode_attention_batched(
            qh, pv.k_codes[l], pv.v_codes[l], pv.k_scales[l], pv.v_scales[l],
            self.caches.slot_state[i, l].reshape(shp),
            self.caches.slot_bits[i, l].reshape(shp),
            self.tables[i, l][None])

        def unfold(a):
            return a[0].reshape(h, c, gq, -1).transpose(0, 1) \
                .reshape(c, hq, -1)
        o_c, m_c, l_c = K.prefill_attention_stats(
            q.float().contiguous(), k_chunk.float().contiguous(),
            v_chunk.float().contiguous(), causal=True, n_valid=n_valid)
        return KR.merge_flash_ref(unfold(o_p), unfold(m_p), unfold(l_p),
                                  o_c, m_c, l_c).to(q.dtype)

    def _advance(self, i: int, sparsity, n_new: int) -> None:
        fail, self._slot_ntok[i], self._slot_buflen[i] = CC.engine_advance(
            self.tk, self.dims, self.pool, self.tables[i],
            self.caches.slot(i), sparsity,
            num_tokens=int(self._slot_ntok[i]),
            buf_len=int(self._slot_buflen[i]), n_new=n_new,
            policy=self.policy)
        if fail is not None:
            self._fails.append(fail)

    def _check_fails(self) -> None:
        """Assert no commit claim failed (one read-back per call)."""
        fails, self._fails = self._fails, []
        if fails and bool(torch.stack(fails).any()):
            raise AssertionError(
                "commit allocation failed on an unpressured pool (pool "
                "accounting bug — data would have been dropped)")

    # ------------------------------------------------------------------
    # decode tick
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _tick(self, active: np.ndarray):
        """One decode tick over every slot: returns (tokens [R], logits
        [R, V]) on the device; active slots' caches advance."""
        mc, tk, dims = self.mcfg, self.tk, self.dims
        R, L, dev = self.cfg.max_seqs, mc.num_layers, self.device
        m, caches = self.model, self.caches
        h = E.embed(m.embed_params, torch.as_tensor(self._feed, device=dev),
                    mc)                                          # [R, Dm]
        pos, buf_len = caches.num_tokens, caches.buf_len.long()
        ridx = torch.arange(R, device=dev)
        refresh_due = active & ((self._slot_ntok + 1)
                                % tk.refresh_interval == 0)

        # pass 1: qkv + buffer write + MLP trunk
        qs = []
        for l in range(L):
            lp = m.layer(l)
            x1 = rmsnorm(lp["norm1"], h, mc.norm_eps)
            q, k, v = A.qkv_decode(lp["attn"], x1, mc, pos)
            caches.buf_k[ridx, l, buf_len] = k.to(torch.bfloat16)
            caches.buf_v[ridx, l, buf_len] = v.to(torch.bfloat16)
            h = h + mlp(lp["mlp"], rmsnorm(lp["norm2"], h, mc.norm_eps),
                        mc.act, mc.mlp_gated)
            qs.append(q)
        qs = torch.stack(qs)                                     # [L,R,Hq,D]
        n_buf = caches.buf_len + 1

        def dense(l):
            mask = (torch.arange(dims.G, device=dev)[None]
                    < n_buf[:, None])[:, None]                   # [R, 1, G]
            o, p, valid = self._dense_layer(
                l, qs[l][:, None], ridx, caches.buf_k[:, l],
                caches.buf_v[:, l], mask)
            return o[:, 0], _probs_sparsity(p[:, 0], valid[:, 0])

        # pass 2: attention, once, over the stacked queries
        if self.backend == "kernel":
            pv = self.pool.view
            qh = qs.reshape(L, R, dims.H, -1, mc.head_dim).float()
            o_all = K.paged_decode_attention_fused(
                qh.contiguous(), pv.k_codes, pv.v_codes, pv.k_scales,
                pv.v_scales, CC.stacked_slot_plane(dims, caches.slot_state),
                CC.stacked_slot_plane(dims, caches.slot_bits), self.tables,
                CC.stacked_buffers(caches.buf_k),
                CC.stacked_buffers(caches.buf_v), n_buf)
            o_all = o_all.reshape(L, R, mc.num_heads, mc.head_dim) \
                .to(qs.dtype)
            if refresh_due.any():
                sparsity = torch.stack([dense(l)[1] for l in self.lstar]) \
                    .mean(0)
            else:
                sparsity = torch.zeros(R, device=dev)
        else:
            outs = [dense(l) for l in range(L)]
            o_all = torch.stack([o for o, _ in outs])
            sparsity = torch.stack([outs[l][1] for l in self.lstar]).mean(0)

        # pass 3: attention output residuals
        for l in range(L):
            h = h + A.out_proj(m.layer(l)["attn"], o_all[l])

        for i in np.nonzero(active)[0]:
            self._advance(int(i), sparsity[i], 1)

        h = rmsnorm({"scale": m.final_norm}, h, mc.norm_eps)
        logits = softcap(E.unembed(m.embed_params, h, mc), mc.logit_softcap)
        return _sample_slots(logits), logits

    # ------------------------------------------------------------------
    # chunked prefill
    # ------------------------------------------------------------------

    def _layer_qkv(self, lp, h, positions):
        mc = self.mcfg
        x1 = rmsnorm(lp["norm1"], h, mc.norm_eps)
        q, k, v = A._project_qkv(lp["attn"], x1, mc)
        q, k = A.rope_qk(q, k, positions, mc)
        return q, k, v

    def _layer_out(self, lp, h, o):
        mc = self.mcfg
        h = h + A.out_proj(lp["attn"], o)
        return h + mlp(lp["mlp"], rmsnorm(lp["norm2"], h, mc.norm_eps),
                       mc.act, mc.mlp_gated)

    def _logits(self, h):
        mc, m = self.mcfg, self.model
        h = rmsnorm({"scale": m.final_norm}, h, mc.norm_eps)
        return softcap(E.unembed(m.embed_params, h, mc), mc.logit_softcap)

    @torch.no_grad()
    def _prefill_chunk(self, i: int, tokens: np.ndarray):
        """Up to g prompt tokens of slot ``i`` in one forward (the buffer
        starts empty: chunks align with commits)."""
        mc, tk, dims, dev = self.mcfg, self.tk, self.dims, self.device
        C, n_valid = dims.G, len(tokens)
        start = int(self._slot_ntok[i])
        padded = np.zeros(C, np.int64)
        padded[:n_valid] = tokens
        positions = start + torch.arange(C, device=dev)
        tok_valid = torch.arange(C, device=dev) < n_valid
        refresh_due = (start + n_valid) % tk.refresh_interval == 0
        cache = self.caches.slot(i)
        slot = torch.tensor([i], device=dev)
        h = E.embed(self.model.embed_params,
                    torch.as_tensor(padded, device=dev), mc)
        causal = torch.arange(C, device=dev)[None] <= \
            torch.arange(C, device=dev)[:, None]
        buf_mask = (causal & tok_valid[None])[None]
        last = n_valid - 1
        spars = {}
        for l in range(mc.num_layers):
            lp = self.model.layer(l)
            q, k, v = self._layer_qkv(lp, h, positions)
            km = torch.where(tok_valid[:, None, None], k, 0.0) \
                .to(torch.bfloat16)
            vm = torch.where(tok_valid[:, None, None], v, 0.0) \
                .to(torch.bfloat16)
            cache.buf_k[l] = km
            cache.buf_v[l] = vm

            def dense():
                o, p, valid = self._dense_layer(l, q[None], slot, km[None],
                                                vm[None], buf_mask)
                return o[0], _probs_sparsity(p[:, last], valid[:, last])[0]

            if self.backend == "kernel":
                o = self._chunk_kernel(q, l, i, km, vm, n_valid)
                if l in self.lstar and refresh_due:
                    spars[l] = dense()[1]
            else:
                o, spars[l] = dense()
            h = self._layer_out(lp, h, o)
        sparsity = torch.stack([spars[l] for l in self.lstar]).mean() \
            if refresh_due else torch.zeros((), device=dev)
        self._advance(i, sparsity, n_valid)
        return self._logits(h[last])

    @torch.no_grad()
    def _prefill_big(self, i: int, tokens: np.ndarray):
        """``prefill_chunk`` tokens of slot ``i`` in one forward (intra-chunk
        attention at full precision, one sparsity value for the chunk), then
        C/g group commits in order."""
        mc, tk, dims, dev = self.mcfg, self.tk, self.dims, self.device
        C = self.prefill_chunk
        start = int(self._slot_ntok[i])
        positions = start + torch.arange(C, device=dev)
        has_refresh = any((start + t) % tk.refresh_interval == 0
                          for t in range(1, C + 1))
        slot = torch.tensor([i], device=dev)
        h = E.embed(self.model.embed_params,
                    torch.as_tensor(tokens, device=dev), mc)
        causal = (torch.arange(C, device=dev)[None] <=
                  torch.arange(C, device=dev)[:, None])[None]
        spars, ks, vs = {}, [], []
        for l in range(mc.num_layers):
            lp = self.model.layer(l)
            q, k, v = self._layer_qkv(lp, h, positions)

            def dense():
                o, p, valid = self._dense_layer(l, q[None], slot, k[None],
                                                v[None], causal)
                return o[0], _probs_sparsity(p[:, C - 1],
                                             valid[:, C - 1])[0]

            if self.backend == "kernel":
                o = self._chunk_kernel(q, l, i, k, v, None)
                if l in self.lstar and has_refresh:
                    spars[l] = dense()[1]
            else:
                o, spars[l] = dense()
            h = self._layer_out(lp, h, o)
            ks.append(k)
            vs.append(v)
        sparsity = torch.stack([spars[l] for l in self.lstar]).mean() \
            if has_refresh else torch.zeros((), device=dev)
        ks, vs = torch.stack(ks), torch.stack(vs)            # [L, C, H, D]
        cache = self.caches.slot(i)
        for g0 in range(0, C, dims.G):
            cache.buf_k.copy_(ks[:, g0:g0 + dims.G])
            cache.buf_v.copy_(vs[:, g0:g0 + dims.G])
            cache.buf_len.fill_(0)
            self._slot_buflen[i] = 0
            self._advance(i, sparsity, dims.G)
        return self._logits(h[C - 1])

    def _free_per_layer(self) -> np.ndarray:
        return self.pool.free.sum(1).cpu().numpy().astype(np.int64)

    def _prefill(self, i: int, prompt: np.ndarray) -> np.ndarray:
        """Chunked prefill of slot ``i``: 128-multiple big chunks first,
        then the tail in chunks of g; returns last-token logits."""
        dims, C, BC = self.dims, self.dims.G, self.prefill_chunk
        s0, logits = 0, None
        big_claims = (BC // C) * self._cc if BC else 0
        while BC and len(prompt) - s0 >= BC:
            # a big chunk commits C/g groups with no frees in between: it
            # runs only when the free list covers their worst-case claim
            mapped = (self.tables[i] >= 0).sum(1).cpu().numpy()
            need = np.minimum(big_claims, dims.NB - mapped)
            if (self._free_per_layer() < need).any():
                break
            logits = self._prefill_big(i, prompt[s0:s0 + BC])
            self.metrics["prefill_big_chunks"] += 1
            s0 += BC
        for s in range(s0, len(prompt), C):
            if int(self._free_per_layer().min()) < self._cc:
                _not_ported("preempting other slots for prefill headroom",
                            "10")
            logits = self._prefill_chunk(i, prompt[s:s + C])
            self.metrics["prefill_chunks"] += 1
        self._check_fails()
        self.metrics["prefill_tokens"] += len(prompt)
        return logits.float().cpu().numpy()

    # ------------------------------------------------------------------
    # the device-facing seam: prefill / insert / generate / consume
    # ------------------------------------------------------------------

    def submit(self, prompts: Sequence[np.ndarray], max_new_tokens: int,
               eos_token: Optional[int] = None,
               priorities: Optional[Sequence[int]] = None) -> None:
        for i, p in enumerate(prompts):
            req = Request(uid=i, prompt=np.asarray(p, np.int64),
                          max_new_tokens=max_new_tokens, eos_token=eos_token,
                          priority=0 if priorities is None
                          else int(priorities[i]))
            self.scheduler.submit(req)
            self._queued_at[req.arrival] = self.metrics["ticks"]

    def prefill(self, prompt: np.ndarray, slot_idx: int) -> Prefix:
        """Chunked prefill of ``prompt`` into ``slot_idx`` + greedy first
        token; the KV stays resident in the pool."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("thinkv.prefill"):
            logits = self._prefill(slot_idx, np.asarray(prompt))
        self.metrics["prefill_s"] += time.perf_counter() - t0
        return Prefix(length=len(prompt), first_token=int(np.argmax(logits)),
                      logits=logits, slot=slot_idx)

    def insert(self, prefix: Prefix, slot_idx: int) -> bool:
        """Seed the next-token feed of a resident prefix."""
        if prefix.slot != slot_idx:
            _not_ported("inserting a prefix into another slot (portable "
                        "prefixes)", "10")
        self._feed[slot_idx] = prefix.first_token
        return True

    def _ensure_decode_headroom(self) -> None:
        """The coming tick's commits must fit the free list; on this
        unpressured pool they always do (preemption is not ported)."""
        committing = sum(1 for s in self.scheduler.active_slots()
                         if (self._slot_ntok[s.idx] + 1) % self.dims.G == 0)
        if committing and int(self._free_per_layer().min()) < \
                committing * self._cc:
            _not_ported("preempting slots for decode headroom", "10")

    def generate(self) -> Optional[TickResult]:
        """One decode tick over every occupied slot (None if none)."""
        self._ensure_decode_headroom()
        active = np.array([not s.free for s in self.scheduler.slots])
        if not active.any():
            return None
        self.metrics["dispatches"] += 1
        t0 = time.perf_counter()
        with torch.profiler.record_function("thinkv.tick"):
            tokens, logits = self._tick(active)
        fails, self._fails = self._fails, []
        res = TickResult(
            tick=int(self.metrics["ticks"]) + 1, tokens=tokens.cpu().numpy(),
            valid=active, logits=logits.float().cpu().numpy(),
            alloc_fail=bool(fails and torch.stack(fails).any()))
        self.metrics["decode_s"] += time.perf_counter() - t0
        self.metrics["ticks"] += 1
        self.metrics["tokens"] += int(active.sum())
        return res

    def consume(self, res: TickResult) -> TickResult:
        if res.alloc_fail:
            raise AssertionError(
                "decode commit allocation failed on an unpressured pool "
                "(pool accounting bug — data would have been dropped)")
        return res

    def _release_slot(self, i: int) -> None:
        CC.release_blocks(self.pool, self.tables[i])
        self.tables[i].fill_(CC.UNMAPPED)
        self.caches.slot(i).copy_(self._fresh)
        self._slot_ntok[i] = 0
        self._slot_buflen[i] = 0

    def free_resource(self, slot_idx: int) -> None:
        """Release every pool reference of ``slot_idx`` and reset it."""
        self._release_slot(slot_idx)

    def audit_pool(self) -> Dict:
        return CC.check_pool_invariants(self.pool, self.tables)

    def slot_stats(self, i: int) -> Dict:
        comp = TV.compression_ratio(self.tk, self.dims, self.caches.slot(i),
                                    int(self._slot_ntok[i]))
        return {k: (v.tolist() if torch.is_tensor(v) else v)
                for k, v in comp.items()}

    # ------------------------------------------------------------------
    # synchronous host loop (the reference orchestrator's run_sync order)
    # ------------------------------------------------------------------

    def _record_logits(self, req: Request, logits: np.ndarray) -> None:
        if self.record_logits:
            self.request_logits.setdefault(req.arrival, []).append(logits)

    def _finish_token(self, slot, tok: int) -> None:
        req = slot.request
        req.output.append(tok)
        slot.tokens_out += 1
        self._feed[slot.idx] = tok
        if slot.tokens_out >= req.max_new_tokens or \
                (req.eos_token is not None and tok == req.eos_token):
            req.stats = self.slot_stats(slot.idx)
            self.scheduler.retire(slot)
            self.free_resource(slot.idx)

    def _watermark_blocks(self, req: Request) -> np.ndarray:
        """Per-layer block estimate for admitting ``req``: the budget bound
        ceil((budget + g) / BS) plus one commit's claim, capped by NB."""
        dims = self.dims
        cap = min(len(req.prompt) + int(req.max_new_tokens),
                  self.tk.token_budget + dims.G)
        return np.full(dims.L, min(dims.NB, -(-cap // dims.BS) + self._cc),
                       np.int64)

    def _admission_gate(self):
        running = sum(not s.free for s in self.scheduler.slots)
        state = {"reserved": np.full(self.dims.L, running * self._cc,
                                     np.int64),
                 "free": self._free_per_layer()}

        def gate(req: Request) -> bool:
            need = self._watermark_blocks(req)
            if np.all(state["free"] - state["reserved"] >= need):
                state["reserved"] = state["reserved"] + need
                return True
            return False
        return gate

    def _admit_and_prefill(self) -> None:
        sch = self.scheduler
        while sch.queue and any(s.free for s in sch.slots):
            newly = sch.admit(self._admission_gate())
            if not newly:
                break
            for slot in newly:
                req = slot.request
                self.metrics["admissions"] += 1
                self.metrics["queue_wait_ticks"] += \
                    self.metrics["ticks"] - self._queued_at.pop(
                        req.arrival, self.metrics["ticks"])
                prefix = self.prefill(req.prompt, slot.idx)
                self.insert(prefix, slot.idx)
                self._record_logits(req, prefix.logits)
                self._finish_token(slot, prefix.first_token)

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        """Serve everything submitted: admit + prefill, then tick, fan the
        tokens out, retire, admit — until the queue drains."""
        sch = self.scheduler
        t0 = time.perf_counter()
        self._admit_and_prefill()
        for _ in range(max_ticks):
            if not sch.busy():
                break
            if not sch.active_slots():
                self._admit_and_prefill()
                if sch.queue and not sch.active_slots():
                    raise RuntimeError(
                        "admission livelock: the pool cannot serve even one "
                        "queued request")
                continue
            res = self.consume(self.generate())
            for slot in sch.active_slots():
                self._record_logits(slot.request, res.logits[slot.idx])
                self._finish_token(slot, int(res.tokens[slot.idx]))
            self._admit_and_prefill()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.metrics["wall_s"] = time.perf_counter() - t0
        return sch.finished
