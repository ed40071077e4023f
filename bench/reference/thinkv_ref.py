"""Plain PyTorch reference of ThinKV serving, the yardstick that decides a
benchmark run's ``correct``.

It imports torch alone: nothing of the measured program.  What it needs of
ThinKV's arithmetic is written out here again from the paper's method as the
program's engine runs it (a frozen copy of the plain forms of
``repro_torch/core/quantization.py``, ``core/kmeans.py::kmeans_select``,
``core/thoughts.py``, ``core/policy.py`` (the ``thinkv`` policy),
``core/ct_cache.py`` (commit, budget eviction, TBE annealing, refresh) and
``serving/engine.py`` (the chunked prefill and the attention-late decode
tick), without the paged pool, the kernels or batching):

* one request at a time, on its own logical planes ``[L, NS, H, ...]``
  (a block table maps logical blocks to physical ones and so changes no
  value that attention reads);
* attention dequantizes the VALID slots and takes a dense softmax jointly
  with the TBQ buffer (or a prefill chunk);
* the decode tick is the engine's attention-late form: a trunk pass over
  the layers (q, k, v and the FFN residual, no attention), then every
  layer's attention, then the attention-output residuals.  The trunk of a
  token reads only its id and position, so it is computed apart
  (:meth:`Reference.trunk`); a mixture-of-experts trunk routes the rows of
  one engine tick together, as the engine does, so its caller hands it
  whole ticks.

``tf32=True`` is the control: every product's operands rounded to TF32
(10 mantissa bits, round to nearest) with f32 accumulation, the weights
once when the reference is built, the activations at each product.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

NEG = -1e30
FREE, VALID, EVICTED = 0, 1, 2
TRANSITION, EXECUTION, REASONING = 0, 1, 2
SEGMENT_CAP = 128          # tokens of one segment an anneal considers
SPARSITY_REL = 0.01        # a weight below 1 % of its row's maximum is small
E4M3_MAX = 448.0
SCALE_EPS = 2.0 ** -16
QMAX = {2: 1.0, 4: 6.0}
NVFP4_THRESHOLDS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)
LANES = 16                 # channels per scale


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to the nearest TF32 value (ties to even)."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


# ---------------------------------------------------------------------------
# TBQ codes: E4M3 group scales over NVFP4 (4 bits) and ternary (2 bits)
# ---------------------------------------------------------------------------

def _e4m3(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn) \
        .to(torch.float32)


def _e4m3_up(s: torch.Tensor) -> torch.Tensor:
    bits = s.to(torch.float8_e4m3fn).view(torch.uint8)
    up = (bits + 1).view(torch.float8_e4m3fn).to(torch.float32)
    return torch.where(s >= E4M3_MAX, torch.full_like(up, E4M3_MAX), up)


def group_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """The E4M3 scale of a 16-lane group, one grid step up where rounding
    to nearest would let |x| / s pass ``qmax``."""
    raw = amax.clamp_min(SCALE_EPS) / amax.new_full((), qmax)
    s = _e4m3(raw)
    s = torch.where(s * qmax < amax, _e4m3_up(s), s)
    return s.clamp_min(SCALE_EPS)


def quantize(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (uint8 codes [..., D], f32 scales [..., D / 16])."""
    xg = x.float().reshape(*x.shape[:-1], x.shape[-1] // LANES, LANES)
    scale = group_scale(xg.abs().amax(-1), QMAX[bits])
    y = xg / scale[..., None]
    if bits == 4:
        sign = (y < 0).to(torch.uint8)
        idx = torch.zeros_like(sign)
        for t in NVFP4_THRESHOLDS:
            idx = idx + (y.abs() >= t).to(torch.uint8)
        codes = (sign << 3) | idx
    else:
        v = torch.round(y).clamp(-1, 1).to(torch.int32)
        codes = torch.where(v < 0, 3, v).to(torch.uint8)
    return codes.reshape(x.shape), scale


def dequantize(codes: torch.Tensor, scales: torch.Tensor,
               bits: torch.Tensor) -> torch.Tensor:
    """codes [..., D], scales [..., D / 16], bits broadcasting against
    codes[..., :1] -> f32 values."""
    c = codes.to(torch.int32)
    sign = 1.0 - 2.0 * ((c >> 3) & 1).to(torch.float32)
    i = c & 7
    e, m = (i >> 1).to(torch.float32), (i & 1).to(torch.float32)
    fp4 = sign * torch.where(i < 2, 0.5 * m, (1.0 + 0.5 * m) *
                             torch.exp2(e - 1.0))
    t = c & 3
    ter = torch.where(t == 3, -1.0, torch.where(t == 1, 1.0, 0.0))
    vals = torch.where(bits == 2, ter, fp4)
    vg = vals.reshape(*codes.shape[:-1], codes.shape[-1] // LANES, LANES)
    return (vg * scales[..., None]).reshape(codes.shape)


# ---------------------------------------------------------------------------
# TBE token selection: k-means medoids
# ---------------------------------------------------------------------------

def kmeans_select(x: torch.Tensor, valid: torch.Tensor, keep: torch.Tensor,
                  k_max: int, iters: int) -> torch.Tensor:
    """Keep ``keep`` [B] medoids of the valid rows of x [B, n, d]
    (position-stratified start, ``iters`` Lloyd steps, medoid collisions
    padded with the lowest valid rows); returns the keep mask [B, n]."""
    b, n, _ = x.shape
    dev = x.device
    x = x.float()
    vi = valid.long()
    n_valid = vi.sum(-1)
    keep = torch.minimum(keep.long().clamp_min(1), n_valid.clamp_max(k_max))
    rank = vi.cumsum(-1) - 1
    j = torch.arange(k_max, device=dev)
    tgt = (j[None] * n_valid[:, None]) // keep.clamp_min(1)[:, None]
    rows = torch.arange(n, device=dev).expand(b, n)
    row_of_rank = torch.zeros((b, n + 1), dtype=torch.long, device=dev)
    row_of_rank.scatter_(1, torch.where(valid, rank, n), rows)
    start = row_of_rank[:, :n].gather(1, tgt.clamp(0, n - 1))
    c = x.gather(1, start[..., None].expand(-1, -1, x.shape[-1]))
    active = j[None] < keep[:, None]
    mask = valid[:, :, None] & active[:, None, :]
    vf = valid.float()[..., None]

    def sqdist(c):
        return ((x * x).sum(-1)[..., None] - 2.0 * (x @ c.transpose(1, 2))
                + (c * c).sum(-1)[:, None, :])

    for _ in range(iters):
        d2 = torch.where(mask, sqdist(c), 1e30)
        onehot = torch.nn.functional.one_hot(d2.argmin(-1), k_max).float() \
            * vf
        counts = onehot.sum(1)
        sums = onehot.transpose(1, 2) @ x
        c = torch.where(counts[..., None] > 0,
                        sums / counts.clamp_min(1)[..., None], c)
    d2 = torch.where(mask, sqdist(c), 1e30)
    member = (d2.argmin(-1)[..., None] == j) & valid[..., None]
    medoid = torch.where(member, d2, 1e30).argmin(1)
    fallback = torch.where(valid[..., None], d2, 1e30).argmin(1)
    medoid = torch.where(member.any(1) & active, medoid, fallback)
    hits = torch.zeros((b, n), dtype=torch.long, device=dev)
    hits.scatter_add_(1, medoid, active.long())
    kept = hits > 0
    deficit = keep - kept.sum(-1)
    idx = torch.arange(n, device=dev)
    order = torch.argsort(torch.where(valid & ~kept, idx, n + 1), dim=-1,
                          stable=True)
    pad = torch.zeros_like(kept).scatter_(1, order,
                                          idx[None] < deficit[:, None])
    return (kept | pad) & valid


def row_sparsity(p: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Share of the valid weights of each row below 1 % of its maximum."""
    rmax = torch.where(valid, p, -torch.inf).amax(-1, keepdim=True)
    small = (p < SPARSITY_REL * rmax) & valid
    return small.sum(-1) / valid.sum(-1).clamp_min(1)


def probs_sparsity(p: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One query's weights p [H, gq, N] (valid [N]): max-pooled over the q
    group, renormalized, each kv head's sparsity, their mean."""
    pooled = torch.where(valid[None], p.amax(1), 0.0)
    pooled = pooled / pooled.sum(-1, keepdim=True).clamp_min(1e-30)
    return row_sparsity(pooled, valid[None].expand_as(pooled)).mean()


def classify(s: float, thresholds: Sequence[float]) -> int:
    if s < thresholds[0]:
        return EXECUTION
    return REASONING if s < thresholds[1] else TRANSITION


# ---------------------------------------------------------------------------
# One request's compressed cache
# ---------------------------------------------------------------------------

class Cache:
    """Logical planes of one request: codes, scales, per-slot state,
    segment, position and bits, per-block thought, per-segment thought and
    retention level, the bf16 TBQ buffer and the host counters."""

    def __init__(self, tk: dict, L: int, H: int, D: int, dev):
        self.tk = tk
        self.G, self.BS = tk["group_size"], tk["block_size"]
        self.NB = max(int(tk["token_budget"] * 2.0) // self.BS, 4)
        self.NS, self.S = self.NB * self.BS, tk["max_segments"]
        NS, S = self.NS, self.S
        self.L, self.H, self.D, self.dev = L, H, D, dev
        self.k_codes = torch.zeros(L, NS, H, D, dtype=torch.uint8, device=dev)
        self.v_codes = torch.zeros_like(self.k_codes)
        self.k_scales = torch.zeros(L, NS, H, D // LANES, device=dev)
        self.v_scales = torch.zeros_like(self.k_scales)
        self.state = torch.zeros(L, NS, dtype=torch.uint8, device=dev)
        self.seg = torch.full((L, NS), -1, dtype=torch.long, device=dev)
        self.bits = torch.full((L, NS), 4, dtype=torch.long, device=dev)
        self.block_type = torch.full((L, self.NB), -1, dtype=torch.long,
                                     device=dev)
        self.seg_type = torch.full((S,), -1, dtype=torch.long, device=dev)
        self.seg_type[0] = REASONING
        self.seg_level = torch.zeros(L, S, dtype=torch.long, device=dev)
        self.buf_k = torch.zeros(L, self.G, H, D, dtype=torch.bfloat16,
                                 device=dev)
        self.buf_v = torch.zeros_like(self.buf_k)
        self.buf_len = 0
        self.num_tokens = 0
        self.cur_seg = 0
        self.cur_thought = REASONING

    def load(self, state: dict) -> "Cache":
        """Take a request's state as given (planes ``[L, NS, ...]``, the
        per-slot and per-segment tensors, the buffer and the counters, by
        this class's names)."""
        for name in ("k_codes", "v_codes", "state", "buf_k", "buf_v"):
            getattr(self, name).copy_(state[name])
        for name in ("k_scales", "v_scales"):
            getattr(self, name).copy_(state[name].float())
        for name in ("seg", "bits", "block_type", "seg_type", "seg_level"):
            getattr(self, name).copy_(state[name].long())
        for name in ("buf_len", "num_tokens", "cur_seg", "cur_thought"):
            setattr(self, name, int(state[name]))
        return self

    # -- read side --------------------------------------------------------

    def pool(self, l: int):
        """Layer l's VALID entries: (k, v [n, H, D] f32)."""
        idx = torch.nonzero(self.state[l] == VALID)[:, 0]
        bits = self.bits[l, idx][:, None, None]
        return (dequantize(self.k_codes[l, idx], self.k_scales[l, idx], bits),
                dequantize(self.v_codes[l, idx], self.v_scales[l, idx], bits))

    def valid_counts(self) -> torch.Tensor:
        return (self.state == VALID).sum(-1)

    # -- write side -------------------------------------------------------

    def commit(self) -> None:
        L, G, NS, BS = self.L, self.G, self.NS, self.BS
        t = self.cur_thought
        bits = self.tk["precision"][t]
        kc, ks = quantize(self.buf_k, bits)
        vc, vs = quantize(self.buf_v, bits)
        # slot choice: an evicted slot of a same-thought block, a free slot
        # of a partly filled same-thought block, a slot of an empty block,
        # an evicted slot of another thought's block; lowest address first
        btype = self.block_type.repeat_interleave(BS, 1)
        same = btype == t
        empty = (self.state.reshape(L, self.NB, BS) == FREE).all(-1) \
            .repeat_interleave(BS, 1)
        free, ev = self.state == FREE, self.state == EVICTED
        score = torch.zeros((L, NS), dtype=torch.long, device=self.dev)
        score = torch.where(empty, 2, score)
        score = torch.where(free & same & ~empty, 3, score)
        score = torch.where(ev & same, 4, score)
        score = torch.where(ev & ~same, 1, score)
        lin = torch.arange(NS, device=self.dev)
        _, idx = torch.topk(score * NS - lin, G, dim=1)
        ok = score.gather(1, idx) > 0
        rows = torch.arange(L, device=self.dev)[:, None].expand(L, G)
        li, si = rows[ok], idx[ok]
        self.k_codes[li, si] = kc[ok]
        self.v_codes[li, si] = vc[ok]
        self.k_scales[li, si] = ks[ok]
        self.v_scales[li, si] = vs[ok]
        self.state[li, si] = VALID
        self.seg[li, si] = self.cur_seg
        self.bits[li, si] = bits
        bidx = idx // BS
        claim = ok & (self.block_type.gather(1, bidx) == -1)
        self.block_type[rows[claim], bidx[claim]] = t
        self.buf_len = 0

    def _retention(self, level: torch.Tensor) -> torch.Tensor:
        sched = torch.tensor(self.tk["retention_schedule"], device=self.dev)
        return sched[level.clamp(0, len(sched) - 1)] \
            .clamp_min(self.tk["min_retention"])

    def anneal(self, seg: torch.Tensor, enable: torch.Tensor,
               mm) -> None:
        """Anneal segment seg[l] of every enabled layer l one retention
        level: keep the k-means medoids of its first 128 VALID slots."""
        L, NS = self.L, self.NS
        match = (self.seg == seg[:, None]) & (self.state == VALID)
        order = torch.where(match, torch.arange(NS, device=self.dev), NS + 1)
        idx = torch.argsort(order, dim=1, stable=True)[:, :SEGMENT_CAP]
        valid = match.gather(1, idx)
        level = self.seg_level.gather(1, seg[:, None])[:, 0]
        target = self._retention(level)
        count = valid.sum(-1)
        do = enable & (count > 0)
        rows = torch.arange(L, device=self.dev)[:, None]
        keys = dequantize(self.k_codes[rows, idx], self.k_scales[rows, idx],
                          self.bits.gather(1, idx)[..., None, None])
        keep = kmeans_select(mm.round(keys.reshape(L, idx.shape[1], -1)),
                             valid, target,
                             max(self.tk["retention_schedule"]),
                             self.tk["kmeans_iters"])
        evict = valid & ~keep & (do & (count > target))[:, None]
        st = self.state.gather(1, idx)
        self.state.scatter_(1, idx, torch.where(evict, EVICTED, st))
        new = torch.where(do, (level + 1).clamp_max(
            len(self.tk["retention_schedule"])), level)
        self.seg_level.scatter_(1, seg[:, None], new[:, None])

    def free_empty_blocks(self) -> None:
        by_block = self.state.view(self.L, self.NB, self.BS)
        empty = ~(by_block == VALID).any(-1)
        by_block.masked_fill_(empty[..., None], FREE)
        self.block_type.masked_fill_(empty, -1)

    def budget_evict(self, mm, rounds: int = 4) -> None:
        """Above the budget: anneal each over-budget layer's least
        important, oldest shrinkable segment, up to four rounds."""
        S, budget = self.S, self.tk["token_budget"]
        ids = torch.arange(S, device=self.dev)
        if self.num_tokens > budget:
            for _ in range(rounds):
                valid = self.state == VALID
                over = valid.sum(-1) > budget
                of = torch.where(valid, self.seg, S)
                counts = torch.zeros((self.L, S + 1), dtype=torch.long,
                                     device=self.dev)
                counts.scatter_add_(1, of, torch.ones_like(of))
                shrink = (counts[:, :S] > self.tk["min_retention"]) & \
                    (self.seg_type >= 0) & (ids < self.cur_seg)
                key = torch.where(shrink, self.seg_type * S + ids, 2 ** 30)
                self.anneal(key.argmin(-1), over & shrink.any(-1), mm)
        self.free_empty_blocks()

    def refresh(self, sparsity: float, mm) -> None:
        """Every tau tokens: the sparsity names the next thought; a
        transition segment that ends anneals every earlier segment; then
        the budget."""
        new = classify(sparsity, self.tk["sparsity_thresholds"])
        types = self.seg_type.tolist()
        ended = self.cur_seg
        if types[ended] == TRANSITION:
            on = torch.ones(self.L, dtype=torch.bool, device=self.dev)
            for s in range(min(ended, self.S)):
                if types[s] >= 0:
                    self.anneal(torch.full((self.L,), s, device=self.dev),
                                on, mm)
            self.free_empty_blocks()
        nxt = min(ended + 1, self.S - 1)
        self.cur_seg = nxt
        self.seg_type[nxt] = new
        self.cur_thought = new
        self.budget_evict(mm)

    def advance(self, n_new: int, sparsity: Optional[float], mm) -> None:
        """``n_new`` tokens entered the buffer: commit a full one (and
        enforce the budget), refresh every tau tokens."""
        self.buf_len += n_new
        self.num_tokens += n_new
        if self.buf_len >= self.G:
            self.commit()
            self.budget_evict(mm)
        if self.num_tokens % self.tk["refresh_interval"] == 0:
            self.refresh(float(sparsity), mm)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class Products:
    """Matrix products in f32, or with TF32-rounded operands (control)."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return tf32_round(x) if self.tf32 else x

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ b if self.tf32 else a @ b


class Reference:
    """A decoder (dense, or with a mixture-of-experts FFN) over weights by
    name (stacked ``[L, ...]``), served under ThinKV."""

    def __init__(self, arch: dict, tk: dict, weights: Dict[str, torch.Tensor],
                 tf32: bool = False):
        self.a, self.tk, self.w = arch, tk, weights
        self.mm = Products(tf32)
        if tf32:
            for name, t in weights.items():
                if t.dim() >= 2 and name not in ("embedding", "norm1",
                                                 "norm2", "bq", "bk", "bv"):
                    for part in t.view(-1, t.shape[-1]).split(1 << 14):
                        part.copy_(tf32_round(part))
        self.L, self.Hq, self.H = arch["layers"], arch["heads"], \
            arch["kv_heads"]
        self.D = arch["head_dim"]
        self.gq = self.Hq // self.H
        self.lstar = tuple(range(min(tk["num_calib_layers"], self.L)))
        half, dev = self.D // 2, weights["embedding"].device
        self.inv = torch.pow(
            torch.tensor(float(arch["rope_theta"]), device=dev),
            -torch.arange(0, half, dtype=torch.float32, device=dev) / half)

    # -- layers -------------------------------------------------------------

    def norm(self, x, w):
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.a["norm_eps"]) * w

    def rope(self, x, pos):
        """x [T, heads, D] at positions pos [T] (rotate half)."""
        ang = pos.float()[:, None] * self.inv
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        half = self.D // 2
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def qkv(self, l, h, pos):
        w, mm = self.w, self.mm
        x = self.norm(h, w["norm1"][l])
        q, k, v = mm(x, w["wq"][l]), mm(x, w["wk"][l]), mm(x, w["wv"][l])
        if "bq" in w:
            q, k, v = q + w["bq"][l], k + w["bk"][l], v + w["bv"][l]
        T = h.shape[0]
        q = self.rope(q.reshape(T, self.Hq, self.D), pos)
        k = self.rope(k.reshape(T, self.H, self.D), pos)
        return q, k, v.reshape(T, self.H, self.D)

    def ffn(self, l, h):
        """h + the FFN of its second norm."""
        w, mm = self.w, self.mm
        x = self.norm(h, w["norm2"][l])
        if "router" not in w:
            return h + mm(torch.nn.functional.silu(mm(x, w["w_gate"][l]))
                          * mm(x, w["w_up"][l]), w["w_down"][l])
        return h + self.moe(l, x)

    def moe(self, l, x):
        """The call's n rows routed in groups of ``group_of(n)``: top-k of
        the router's softmax (the lower expert first on ties), gates
        renormalized over the k; a choice whose place in its expert's queue
        (counted in (row, choice) order within the group) reaches the
        capacity is dropped.  Each kept choice's row goes to its expert's
        capacity buffer, the experts run as one batched product over the
        buffers, and a row's output is the gate-weighted sum of its kept
        choices (the program's form, so the products have its shapes)."""
        w, mm, a = self.w, self.mm, self.a
        E, k = a["experts"], a["experts_per_token"]
        n, d = x.shape
        group = group_of(n, a)
        ng = n // group
        xt = x.reshape(ng, group, d)
        probs = torch.softmax(mm(xt, w["router"][l]), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, expert = vals[..., :k], idx[..., :k]
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        cap = max(math.ceil(k * group / E * a["capacity_factor"]), 4)
        flat = expert.reshape(ng, group * k)
        seen = torch.nn.functional.one_hot(flat, E).cumsum(1)
        place = seen.gather(2, flat[..., None])[..., 0] \
            .reshape(ng, group, k) - 1
        keep = place < cap
        slot = torch.where(keep, place, cap)      # dropped: a spare row
        g_idx = torch.arange(ng, device=x.device)[:, None, None] \
            .expand_as(slot)
        xe = xt.new_zeros((ng, E, cap + 1, d))
        xe[g_idx, expert, slot] = xt[:, :, None].expand(*slot.shape, d)
        xe = mm.round(xe[:, :, :cap])
        he = torch.nn.functional.silu(
            torch.einsum("gecd,edf->gecf", xe, w["w_gate"][l])) * \
            torch.einsum("gecd,edf->gecf", xe, w["w_up"][l])
        ye = torch.einsum("gecf,efd->gecd", mm.round(he), w["w_down"][l])
        ye = torch.cat([ye, ye.new_zeros((ng, E, 1, d))], 2)
        picked = ye[g_idx, expert, slot]
        y = (picked * torch.where(keep, gate, 0.0)[..., None]).sum(2)
        return y.reshape(n, d)

    def logits(self, h):
        return self.mm(self.norm(h, self.w["final_norm"]), self.w["lm_head"])

    def attend(self, cache: Cache, l: int, q, kb, vb, mask):
        """q [T, Hq, D] over layer l's VALID entries and the buffer or chunk
        kb, vb [G, H, D] (f32) under mask [T, G]: (out [T, Hq, D], weights
        [T, H, gq, n + G], valid [T, n + G])."""
        kp, vp = cache.pool(l)
        T, n = q.shape[0], kp.shape[0]
        k = torch.cat([kp, kb.float()], 0)
        v = torch.cat([vp, vb.float()], 0)
        valid = torch.cat([torch.ones((T, n), dtype=torch.bool,
                                      device=q.device), mask], 1)
        qh = q.reshape(T, self.H, self.gq, self.D).permute(1, 0, 2, 3) \
            .reshape(self.H, T * self.gq, self.D)
        s = self.mm(qh, self.mm.round(k).permute(1, 2, 0)) / \
            math.sqrt(self.D)
        s = s.reshape(self.H, T, self.gq, -1).permute(1, 0, 2, 3)
        vm = valid[:, None, None, :]
        p = torch.where(vm, torch.softmax(torch.where(vm, s, NEG), -1), 0.0)
        o = self.mm(p.permute(1, 0, 2, 3).reshape(self.H, T * self.gq, -1),
                    self.mm.round(v).permute(1, 0, 2))
        o = o.reshape(self.H, T, self.gq, self.D).permute(1, 0, 2, 3)
        return o.reshape(T, self.Hq, self.D), p, valid

    def _sparsity(self, sps: List[torch.Tensor]) -> float:
        return float(torch.stack(sps).mean())

    # -- chunked prefill ----------------------------------------------------

    def prefill(self, cache: Cache, prompt: torch.Tensor, big: int = 128):
        """The engine's chunked prefill of ``prompt`` (ids on the device):
        ``big``-token chunks while that many remain (intra-chunk attention
        on the f32 keys, one sparsity for the chunk, its groups committed
        in order), then chunks of g; returns the last prompt token's
        logits."""
        s0, out = 0, None
        while big and len(prompt) - s0 >= big:
            out = self._big_chunk(cache, prompt[s0:s0 + big])
            s0 += big
        for s in range(s0, len(prompt), cache.G):
            out = self._g_chunk(cache, prompt[s:s + cache.G])
        return out

    def _big_chunk(self, cache, tokens):
        C, G, dev = len(tokens), cache.G, tokens.device
        start = cache.num_tokens
        pos = start + torch.arange(C, device=dev)
        causal = torch.arange(C, device=dev)[None] <= \
            torch.arange(C, device=dev)[:, None]
        h = self.w["embedding"][tokens]
        ks, vs, sps = [], [], []
        for l in range(self.L):
            q, k, v = self.qkv(l, h, pos)
            o, p, valid = self.attend(cache, l, q, k, v, causal)
            if l in self.lstar:
                sps.append(probs_sparsity(p[C - 1], valid[C - 1]))
            h = self.ffn(l, h + self.mm(o.reshape(C, -1), self.w["wo"][l]))
            ks.append(k)
            vs.append(v)
        sp = self._sparsity(sps)
        ks, vs = torch.stack(ks), torch.stack(vs)
        for g0 in range(0, C, G):
            cache.buf_k.copy_(ks[:, g0:g0 + G])
            cache.buf_v.copy_(vs[:, g0:g0 + G])
            cache.buf_len = 0
            cache.advance(G, sp, self.mm)
        return self.logits(h[C - 1])

    def _g_chunk(self, cache, tokens):
        G, dev = cache.G, tokens.device
        n = len(tokens)
        start = cache.num_tokens
        padded = torch.zeros(G, dtype=torch.long, device=dev)
        padded[:n] = tokens
        pos = start + torch.arange(G, device=dev)
        ok = torch.arange(G, device=dev) < n
        mask = (torch.arange(G, device=dev)[None] <=
                torch.arange(G, device=dev)[:, None]) & ok[None]
        refresh = (start + n) % self.tk["refresh_interval"] == 0
        h = self.w["embedding"][padded]
        sps = []
        for l in range(self.L):
            q, k, v = self.qkv(l, h, pos)
            kb = torch.where(ok[:, None, None], k, 0.0).to(torch.bfloat16)
            vb = torch.where(ok[:, None, None], v, 0.0).to(torch.bfloat16)
            cache.buf_k[l], cache.buf_v[l] = kb, vb
            o, p, valid = self.attend(cache, l, q, kb, vb, mask)
            if refresh and l in self.lstar:
                sps.append(probs_sparsity(p[n - 1], valid[n - 1]))
            h = self.ffn(l, h + self.mm(o.reshape(G, -1), self.w["wo"][l]))
        cache.advance(n, self._sparsity(sps) if refresh else None, self.mm)
        return self.logits(h[n - 1])

    # -- the attention-late decode tick -------------------------------------

    def trunk(self, tokens: torch.Tensor, pos: torch.Tensor):
        """The decode tick's trunk pass over one call's rows of (token,
        position): (q [L, T, Hq, D], k, v [L, T, H, D], h [T, d]).  The
        caller hands it the engine's tick shape (as many rows as slots), so
        the products have the program's shapes; a mixture of experts routes
        the call's rows together, as the engine routes a tick's slots."""
        h = self.w["embedding"][tokens]
        qs, ks, vs = [], [], []
        for l in range(self.L):
            q, k, v = self.qkv(l, h, pos)
            qs.append(q)
            ks.append(k)
            vs.append(v)
            h = self.ffn(l, h)
        return torch.stack(qs), torch.stack(ks), torch.stack(vs), h

    def decode(self, cache: Cache, q, k, v, h):
        """Decode a request's next tokens from their trunk rows (q, k, v
        [L, T, ...], h [T, d], in order, T of them): each tick writes its
        keys and values into the buffer, attends the pool and the buffer
        through every layer, adds the attention outputs and advances the
        cache; returns the logits [T, V]."""
        L, G, tau = self.L, cache.G, self.tk["refresh_interval"]
        out, t, T = [], 0, h.shape[0]
        while t < T:
            b0 = cache.buf_len
            n = min(G - b0, T - t)          # the ticks until the next commit
            rows = slice(t, t + n)
            for l in range(L):
                cache.buf_k[l, b0:b0 + n] = k[l, rows].to(torch.bfloat16)
                cache.buf_v[l, b0:b0 + n] = v[l, rows].to(torch.bfloat16)
            ar = torch.arange(G, device=h.device)
            mask = ar[None] <= (b0 + torch.arange(n, device=h.device))[:, None]
            last_refresh = (cache.num_tokens + n) % tau == 0
            hh, sps = h[rows].clone(), []
            for l in range(L):
                o, p, valid = self.attend(cache, l, q[l, rows],
                                          cache.buf_k[l], cache.buf_v[l],
                                          mask)
                if last_refresh and l in self.lstar:
                    sps.append(probs_sparsity(p[n - 1], valid[n - 1]))
                hh = hh + self.mm(o.reshape(n, -1), self.w["wo"][l])
            out.append(self.logits(hh))
            cache.advance(n, self._sparsity(sps) if last_refresh else None,
                          self.mm)
            t += n
        return torch.cat(out, 0)


def group_of(n: int, arch: dict) -> int:
    """A mixture of experts routes a call's n rows in groups of the largest
    divisor of n not above its dispatch group."""
    if "dispatch_group" not in arch:
        return n
    g = min(arch["dispatch_group"], n)
    while n % g:
        g -= 1
    return g

