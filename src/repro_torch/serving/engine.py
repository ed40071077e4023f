"""ThinKV serving engine (ports ``repro/serving/engine.py`` for a dense or a
mixture-of-experts decoder, on a shared pool that may be oversubscribed
and shared through a copy-on-write prefix cache or forked generation).

Same dataflow as the reference (see its module docstring):

* the decode tick is the two-pass ATTENTION-LATE form — embed, a trunk
  pass over layers (qkv + RoPE, TBQ-buffer write, MLP residual), ONE fused
  attention over the stacked queries of every layer and slot, then the
  attention-output residuals, ``engine_advance`` per slot, logits and
  sampling.  It is the reference's function, kept exactly;
* chunked prefill: 128-multiple big chunks (intra-chunk attention at full
  precision, one sparsity value per chunk, C/g commits in order), then
  g-sized chunks for the tail;
* group commit, budget eviction, thought refresh and TBE annealing on the
  shared paged pool.

Pool pressure, as in the reference: watermark admission (a budget-derived
block estimate per request, exact for a preempted one, shrunk by a prefix
hit); preemption ahead of need before every tick and prefill chunk whose
commits (fresh claims plus one COW claim per shared block) the free list
cannot back — prefix-cache entries decay first (LRU), then victims
(lowest priority, most private blocks) spill their private blocks,
metadata and buffer to host memory (:class:`PreemptedState`) and keep
their references to shared blocks; resume claims fresh blocks, scatters
the spill back and re-attaches the shared ones, bit-exact.  With
``prefix_cache=True`` prefill states are registered at commit-aligned
boundaries, a hit maps the cached blocks (refcount + 1) and prefills only
the tail, and a commit that changes a shared block COW-faults it.
``Prefix`` has the reference's resident and portable forms
(``detach_prefix`` / ``insert`` into any slot).  The host loop is
``serving.orchestrator``; ``run`` goes through it.

Backends: ``kernel`` runs the hand-written CUDA kernels through
``kernels.ops`` (K1 fused decode attention per tick; K2 frozen-pool + K3
intra-chunk attention per prefill layer, big chunks and g-chunks alike;
K4 at every commit); ``reference`` runs the dense dequantize-and-softmax
path (the parity oracle).  ``auto`` is ``kernel`` on CUDA and
``reference`` on the CPU.  On the CPU the kernel backend's wrappers run
their plain versions.

Sampling (``serving.sampling``): greedy at temperature 0; above it,
temperature and nucleus (top-p) sampling on one key stream per request,
seeded from (engine seed, arrival stamp) and split once per sampled token
(``_slot_keys`` [R, 2] on the device, spilled and restored with a
preempted request), on JAX's own threefry keys (``serving.prng``), so
sampled tokens equal the JAX engine's and do not depend on the schedule.

Multi-tick dispatch (``ticks_per_dispatch`` > 1): one ``generate`` runs a
PACK of trips over the same tick, each trip's sampled tokens feeding the
next trip's embedding on the device.  The reference's ``lax.while_loop``
becomes a host loop: the trip count is known before the pack, the
claim-safe cap (``_safe_decode_trips``) and the smallest remaining token
allowance of an active slot (the reference's loop stops after the first
trip on which a slot finishes), and only when some active request has an
eos token does each trip read one device flag (did a slot sample its
eos?) and stop after it.  COW counts and commit-failure flags are read
once per pack.  Host syncs left inside a trip: the refresh's and the pool
accounting's reads in ``ct_cache`` (ROADMAP queue 1 item 17).

Forks (``allow_forks``, ``fork_slot``): a child maps its parent's blocks
by reference (refcount + 1, no plane copy), copies the table and cache
rows and takes a fresh key stream from its own arrival stamp; the first
commit either side makes on a shared block COW-faults a private copy
(``fork_cow_faults``).

Host control flow replaces ``lax.cond``: commits and refreshes are decided
from host mirrors of each slot's ``num_tokens`` / ``buf_len``, and the
sparsity probe runs only on ticks where some slot refreshes.  The pool's
host accounting reads the refcounts back once per pass, and not at all
while no block can be shared, as the reference does.

Retention policies (``core/policy.py``: ``thinkv``, ``rkv``,
``uniform``) are strategy objects the cache calls; ``policy=`` reaches
every commit, anneal and eviction.  The logit-drift probe
(``drift_probe=True``, which records logits) replays each finished request
through the uncompressed dense forward and compares (``measure_drift``).

MoE layers route as the reference's trunk loops do (``models/lm.py``'s
``mlp_residual``): a decode tick routes the R slots as one call, inactive
slots included, in slot order; a prefill chunk routes its C rows as one
call, a g-chunk's padded rows included.  Which choices a capacity drops
therefore matches the reference's.  The drift probe's dense replay goes
through ``lm.backbone`` (the B·S padded tokens together, as the
reference's replay).  The serving path does not read mixtral's sliding
window, as the reference engine's does not; the dense replay does, as
the reference's does.

The VLM family (paligemma) is served as the reference engine serves it:
text only, through the dense paths (tied, scaled embeddings; no image
prefix reaches the engine).

The SSM, hybrid and encoder-decoder families are refused with a
ValueError, as the reference engine refuses them: they are served through
``serving/serve_step.py``.

Tensor-parallel serving (``mesh=``, a ``launch.mesh.ServeMesh``: one
process per rank, ``launch.mesh.run_ranks``), as the reference's (its
lines 139-170): each rank holds the pool planes ``[L, NP, BS, H/N, ...]``
and TBQ buffers ``[R, L, G, H/N, D]`` of its contiguous share of the kv
heads, and launches the same kernels over it (K1 once per tick, K2 and K3
once per layer of a chunk, K2 split as a one-rank launch is:
``split_heads``).  Everything head-agnostic is whole and identical on
every rank: weights, projections, MLP, residuals and logits, block tables,
refcounts, slot and segment metadata, the scheduler, the prefix cache and
every host decision.  Queries and keys are sliced to the rank's heads
(``kernels.ops.local_heads``) before the buffer write and the attention,
and only attention outputs are gathered back
(``distributed.sharding.gather_heads``); the cache's two cross-head
computations gather too (``core.ct_cache``).  No float reduction crosses
ranks, so N ranks are bit-identical to one: tokens, logits, counters and
audits.  A spill or a detached prefix holds the whole heads on the host
(each rank gathers its shares), and resume or ``insert`` takes this
rank's, so a spill moves between rank counts.  Every rank reports the
same; the launcher prints rank 0's.

The compiled-path checks (``analysis``): ``compiled_entry_points`` lists
the entry points the contracts pin, ``audit_compiled`` audits them and
``tick_launch_count`` / ``megatick_launch_count`` /
``prefill_launch_count`` read their launch counts, each by running the
entry point on a scratch request (the reference reads its jaxprs).
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
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as KR
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers.common import softcap
from repro_torch.layers.norms import rmsnorm
from repro_torch.models import lm
from repro_torch.models.lm import LM, init_params
from repro_torch.serving import prng
from repro_torch.serving import sampling as SMP
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import Request, Scheduler

NEG_INF = -1e30
# the drift probe pads prompt + output to a multiple of this length
DRIFT_PAD = 32


def _sample_slots(keys: torch.Tensor, logits: torch.Tensor,
                  temperature: float, top_p: float):
    """Every slot's next token from ``logits [R, V]`` with its stream key
    (``keys [R, 2]``); returns (tokens [R], advanced keys).  Greedy is the
    argmax (the first index on ties) and leaves every key as it is.  The
    temperature scales as in the reference's compiled tick (by the f32
    reciprocal)."""
    return SMP.stream_sample(keys, logits, temperature, top_p,
                             reciprocal=True)


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


def _probs_sparsity(p_t: torch.Tensor, valid_t: torch.Tensor,
                    mesh=None) -> torch.Tensor:
    """Sparsity of one query's probs per slot: p_t [B, H, gq, N], valid_t
    [B, N] -> [B] (max-pool over the q group, renormalize, mean over
    heads).  Per-head values are head-local; under ``mesh`` they are
    gathered to every head before the mean, never summed across ranks (a
    float sum would reorder)."""
    vm = valid_t[:, None, :]
    pooled = torch.where(vm, p_t.amax(dim=2), 0.0)
    pooled = pooled / pooled.sum(-1, keepdim=True).clamp_min(1e-30)
    per_head = row_sparsity(pooled, vm.expand_as(pooled))         # [B, H]
    return SH.gather_heads(per_head, mesh, 1).mean(-1)


@dataclasses.dataclass
class PreemptedState:
    """Host copy of a paused request's device state (the reference's).

    ``view`` holds the pool planes gathered through the request's table
    ([L, NB, BS, H, ...] CPU tensors, every kv head even on one rank of a
    mesh; bf16 stays torch bf16), ``mapped`` the PRIVATE logical blocks
    resume claims fresh blocks for, ``cache`` the request's metadata and
    TBQ buffer (CPU tensors, every kv head), ``shared_table`` the
    physical ids of the SHARED blocks whose reference the paused request
    keeps (re-attached verbatim on resume; -1 elsewhere), ``rng`` the
    request's sampling key at the spill ([2] int64), restored verbatim so
    a sampled request resumes its stream where it paused."""

    view: CC.PoolView
    mapped: np.ndarray              # [L, NB] bool
    cache: CC.CTCache
    tokens_out: int
    next_token: int
    shared_table: Optional[np.ndarray] = None
    rng: Optional[np.ndarray] = None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   [*self.view, *(getattr(self.cache, f)
                                  for f in CC.CTCache.FIELDS)])


@dataclasses.dataclass
class Prefix:
    """Result of :meth:`ThinKVEngine.prefill`, in one of two forms.

    RESIDENT (``slot >= 0``, ``state`` None): the KV lives in the pool under
    ``slot``'s block table; ``insert`` into that slot seeds the feed.
    PORTABLE (``state`` set by :meth:`ThinKVEngine.detach_prefix`, the
    spill format preemption uses): ``insert`` claims fresh blocks and
    scatters the planes into any slot of an engine with the same dims, on
    any number of ranks."""

    length: int
    first_token: int
    logits: Optional[np.ndarray]
    slot: int = -1
    state: Optional[PreemptedState] = None


class TickResult:
    """One decode tick: next tokens [R], logits [R, V], the commit-failure
    flag and the per-slot COW faults.  Holds the device tensors;
    :meth:`block` copies them to the host once (the orchestrator runs it
    off the event loop)."""

    packed = False

    def __init__(self, tick: int, tokens: torch.Tensor, logits: torch.Tensor,
                 flags: torch.Tensor, t0: float):
        self.tick, self.t0 = tick, t0
        self._dev = (tokens, logits, flags)
        self._host = None

    def block(self) -> "TickResult":
        if self._host is None:
            tokens, logits, flags = self._dev
            flags = flags.cpu().numpy()
            self._host = (tokens.cpu().numpy(), logits.float().cpu().numpy(),
                          bool(flags[-1]), flags[:-1])
        return self

    @property
    def tokens_host(self) -> np.ndarray:
        return self.block()._host[0]

    @property
    def logits_host(self) -> np.ndarray:
        return self.block()._host[1]

    @property
    def alloc_fail_host(self) -> bool:
        return self.block()._host[2]

    @property
    def cow_per_slot_host(self) -> np.ndarray:
        return self.block()._host[3]


class MultiTickResult:
    """One pack of ``trips`` decode trips (the reference's
    ``MultiResultTokens``): per-trip tokens [N, R], slot validity [N, R]
    and logits [N, R, V] with N = ``ticks_per_dispatch`` (rows from
    ``trips`` on are zero and invalid), the per-slot COW faults and the
    commit-failure flag of the whole pack.  ``requested`` is the claim-safe
    trip cap; fewer trips executed means a slot finished inside the pack.
    Holds the device tensors; :meth:`block` copies them to the host once."""

    packed = True

    def __init__(self, base_tick: int, n: int, requested: int,
                 tokens: List[torch.Tensor], valid: List[np.ndarray],
                 logits: List[torch.Tensor], flags: torch.Tensor, t0: float):
        self.base_tick, self.tick = base_tick, base_tick + 1
        self.n, self.requested, self.t0 = n, requested, t0
        self.trips_host = len(tokens)
        self._dev = (tokens, valid, logits, flags)
        self._host = None

    def block(self) -> "MultiTickResult":
        if self._host is None:
            tokens, valid, logits, flags = self._dev
            trips, R = self.trips_host, len(valid[0])
            toks = np.zeros((self.n, R), np.int64)
            toks[:trips] = torch.stack(tokens).cpu().numpy()
            val = np.zeros((self.n, R), bool)
            val[:trips] = np.stack(valid)
            lg = torch.stack(logits).float().cpu().numpy()
            lgs = np.zeros((self.n,) + lg.shape[1:], np.float32)
            lgs[:trips] = lg
            flags = flags.cpu().numpy()
            self._host = (toks, val, lgs, bool(flags[-1]), flags[:-1])
        return self

    @property
    def tokens_host(self) -> np.ndarray:
        return self.block()._host[0]

    @property
    def valid_host(self) -> np.ndarray:
        return self.block()._host[1]

    @property
    def logits_host(self) -> np.ndarray:
        return self.block()._host[2]

    @property
    def alloc_fail_host(self) -> bool:
        return self.block()._host[3]

    @property
    def cow_per_slot_host(self) -> np.ndarray:
        return self.block()._host[4]


class ThinKVEngine:
    """Dense-, MoE- and VLM-backbone LM serving with ThinKV on one card (or
    the CPU), or on one rank of a tensor-parallel mesh."""

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
        if cfg.model.family not in (ArchFamily.DENSE, ArchFamily.MOE,
                                    ArchFamily.VLM):
            raise ValueError(
                f"{cfg.model.name}: the engine serves dense, MoE and VLM "
                f"decoders, as the reference's does; serve the "
                f"{cfg.model.family.value} family through "
                f"serving/serve_step.py")
        if int(ticks_per_dispatch) < 1:
            raise ValueError(f"ticks_per_dispatch {ticks_per_dispatch} < 1")
        if cfg.thinkv.refresh_interval % cfg.thinkv.group_size:
            raise ValueError("chunked prefill needs tau % g == 0")
        # tensor-parallel sharding over the kv-head axis (module
        # docstring): this rank's share of the pool planes, buffers and
        # attention; everything head-agnostic whole
        self.mesh = mesh
        n = 1 if mesh is None else int(mesh.size)
        if not SH.head_shardable(cfg.model.num_kv_heads, n):
            raise ValueError(
                f"mesh['{SH.SERVE_HEAD_AXIS}']={n} cannot shard "
                f"{cfg.model.num_kv_heads} kv heads (head sharding needs "
                f"kv_heads % mesh size == 0)")
        self._nshard, self._rank = n, 0 if mesh is None else int(mesh.rank)
        if mesh is not None:
            want = mesh.device if device is None else torch.device(device)
            if want.type != mesh.device.type or want.index not in (
                    None, mesh.device.index):
                raise ValueError(f"engine on {device}, its mesh rank on "
                                 f"{mesh.device}")
            device = mesh.device
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
        # the geometry of this rank's planes and buffers
        self.ldims = self.dims._replace(H=self.dims.H // n)
        n_lstar = min(self.tk.num_calib_layers, mc.num_layers)
        self.lstar = tuple(int(x) for x in (
            lstar if lstar is not None else range(n_lstar)))
        R = cfg.max_seqs
        self.scheduler = Scheduler(R)
        self.num_pool_blocks = pool_blocks if pool_blocks is not None \
            else R * self.dims.NB
        self.pool = CC.init_global_pool(self.ldims, self.num_pool_blocks,
                                        self.device)
        self.tables = CC.init_block_table(self.dims, self.device, batch=R)
        self.caches = CC.init_cache(self.ldims, self.device, batch=R)
        self._fresh = CC.init_cache(self.ldims, self.device)
        if prefill_chunk is None:
            prefill_chunk = 128 if 128 % self.dims.G == 0 else 0
        if prefill_chunk and (prefill_chunk % 128 or
                              prefill_chunk % self.dims.G):
            raise ValueError("large prefill chunks must be 128-multiples "
                             "aligned with commits")
        self.prefill_chunk = prefill_chunk
        # the drift probe compares against the logits the serving path
        # recorded, so it records them
        self.drift_probe = bool(drift_probe)
        self.record_logits = record_logits or self.drift_probe
        self.request_logits: Dict[int, List[np.ndarray]] = {}
        self.metrics: Dict[str, float] = {
            "ticks": 0, "tokens": 0, "dispatches": 0, "prefill_tokens": 0,
            "prefill_chunks": 0, "prefill_big_chunks": 0,
            "preemptions": 0, "resumes": 0, "admissions": 0,
            "queue_wait_ticks": 0, "prefix_hits": 0,
            "prefix_tokens_skipped": 0, "cow_faults": 0, "forks": 0,
            "fork_cow_faults": 0, "peak_refcount": 0,
            "early_exit_finish": 0, "early_exit_headroom": 0,
            "cancellations": 0, "drift_probes": 0, "drift_max_abs": 0.0,
            "commits": 0, "spill_bytes": 0,
            "spill_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0}
        # no block can be shared without the prefix cache or forks: the
        # COW compare runs only with one of them
        self._track_cow = bool(prefix_cache) or bool(allow_forks)
        self.ticks_per_dispatch = int(ticks_per_dispatch)
        self.prefix_cache = PrefixCache(self.dims) if prefix_cache else None
        self._spilled: Dict[int, PreemptedState] = {}   # arrival -> spill
        self._queued_at: Dict[int, int] = {}            # arrival -> tick
        # host mirrors of every slot's num_tokens / buf_len: commits and
        # refreshes are decided here, never read back from the card
        self._slot_ntok = np.zeros(R, np.int64)
        self._slot_buflen = np.zeros(R, np.int64)
        self._feed = np.zeros(R, np.int64)
        # per-slot sampling keys: the reference's placeholder split until
        # prefill and fork reseed a slot from (seed, arrival); resume
        # restores a spilled key
        self._slot_keys = prng.split(prng.prng_key(cfg.seed, self.device), R)
        # slots whose blocks a fork may share (their COW faults are
        # counted apart, as fork_cow_faults)
        self._forked = np.zeros(R, bool)
        # commit-failure flags and (slot, COW-fault count) pairs of the
        # calls since the last read-back
        self._fails: List[torch.Tensor] = []
        self._cows: List[tuple] = []
        self.last_orchestrator = None
        self._retrace_guard = None     # an analysis.RetraceGuard, installed
        # worst-case fresh blocks one group commit claims per layer
        self._cc = -(-self.dims.G // self.dims.BS)

    # ------------------------------------------------------------------
    # attention helpers shared by tick + prefill
    # ------------------------------------------------------------------

    def _local(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's share of a head axis (all of it on one rank)."""
        return K.local_heads(x, dim, self._rank, self._nshard)

    def _whole(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """A head axis gathered from every rank's share."""
        return SH.gather_heads(x, self.mesh, dim)

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
            self.tables[i, l][None], split_heads=dims.H)

        def unfold(a):
            return a[0].reshape(h, c, gq, -1).transpose(0, 1) \
                .reshape(c, hq, -1)
        o_c, m_c, l_c = K.prefill_attention_stats(
            q.float().contiguous(), k_chunk.float().contiguous(),
            v_chunk.float().contiguous(), causal=True, n_valid=n_valid)
        return KR.merge_flash_ref(unfold(o_p), unfold(m_p), unfold(l_p),
                                  o_c, m_c, l_c).to(q.dtype)

    def _advance(self, i: int, sparsity, n_new: int) -> None:
        if self._slot_buflen[i] + n_new >= self.dims.G:
            self.metrics["commits"] += 1
        fail, cow, self._slot_ntok[i], self._slot_buflen[i] = \
            CC.engine_advance(
                self.tk, self.dims, self.pool, self.tables[i],
                self.caches.slot(i), sparsity,
                num_tokens=int(self._slot_ntok[i]),
                buf_len=int(self._slot_buflen[i]), n_new=n_new,
                track_cow=self._track_cow, policy=self.policy,
                mesh=self.mesh)
        if fail is not None:
            self._fails.append(fail)
            self._cows.append((i, cow))

    def _flags(self) -> torch.Tensor:
        """Per-slot COW faults [R] and the commit-failure flag of the calls
        since the last read, packed as one int64 tensor [R + 1] on the
        device; the lists are emptied."""
        R, dev = self.cfg.max_seqs, self.device
        flags = torch.zeros(R + 1, dtype=torch.int64, device=dev)
        for i, cow in self._cows:
            flags[i] += cow
        if self._fails:
            flags[R] = torch.stack(self._fails).any()
        self._fails, self._cows = [], []
        return flags

    def _check_fails(self) -> None:
        """Fold the COW faults into the metrics and assert that no commit
        claim failed (one read-back per call)."""
        if not self._fails:
            return
        flags = self._flags().cpu().numpy()
        self.metrics["cow_faults"] += int(flags[:-1].sum())
        if flags[-1]:
            raise AssertionError(
                "prefill commit allocation failed despite headroom checks "
                "(pool accounting bug — data would have been dropped)")

    # ------------------------------------------------------------------
    # decode tick
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _tick(self, active: np.ndarray, feed: torch.Tensor) -> torch.Tensor:
        """One decode tick over every slot from the tokens ``feed`` ([R] on
        the device): returns the logits [R, V]; active slots' caches
        advance.  Queries, keys and values are sliced to this rank's heads
        and the attention outputs gathered back, once per tick."""
        mc, tk, dims = self.mcfg, self.tk, self.ldims
        R, L, dev = self.cfg.max_seqs, mc.num_layers, self.device
        m, caches = self.model, self.caches
        h = E.embed(m.embed_params, feed, mc)                    # [R, Dm]
        pos, buf_len = caches.num_tokens, caches.buf_len.long()
        ridx = torch.arange(R, device=dev)
        refresh_due = active & ((self._slot_ntok + 1)
                                % tk.refresh_interval == 0)

        # pass 1: qkv + buffer write + FFN trunk (MoE: the R slots route
        # together)
        qs = []
        for l in range(L):
            lp = m.layer(l)
            x1 = rmsnorm(lp["norm1"], h, mc.norm_eps)
            q, k, v = A.qkv_decode(lp["attn"], x1, mc, pos)
            caches.buf_k[ridx, l, buf_len] = self._local(k, 1) \
                .to(torch.bfloat16)
            caches.buf_v[ridx, l, buf_len] = self._local(v, 1) \
                .to(torch.bfloat16)
            h = lm.mlp_residual(lp, h, mc)
            qs.append(self._local(q, 1))
        qs = torch.stack(qs)                             # [L, R, Hq/N, D]
        n_buf = caches.buf_len + 1

        def dense(l):
            """Layer l's attention and, for a calibration layer, its
            sparsity (None elsewhere)."""
            mask = (torch.arange(dims.G, device=dev)[None]
                    < n_buf[:, None])[:, None]                   # [R, 1, G]
            o, p, valid = self._dense_layer(
                l, qs[l][:, None], ridx, caches.buf_k[:, l],
                caches.buf_v[:, l], mask)
            return o[:, 0], _probs_sparsity(p[:, 0], valid[:, 0], self.mesh) \
                if l in self.lstar else None

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
            o_all = o_all.reshape(qs.shape).to(qs.dtype)
            if refresh_due.any():
                sparsity = torch.stack([dense(l)[1] for l in self.lstar]) \
                    .mean(0)
            else:
                sparsity = torch.zeros(R, device=dev)
        else:
            outs = [dense(l) for l in range(L)]
            o_all = torch.stack([o for o, _ in outs])
            sparsity = torch.stack([outs[l][1] for l in self.lstar]).mean(0)
        o_all = self._whole(o_all, 2)                     # [L, R, Hq, D]

        # pass 3: attention output residuals
        for l in range(L):
            h = h + A.out_proj(m.layer(l)["attn"], o_all[l])

        for i in np.nonzero(active)[0]:
            self._advance(int(i), sparsity[i], 1)

        h = rmsnorm({"scale": m.final_norm}, h, mc.norm_eps)
        return softcap(E.unembed(m.embed_params, h, mc), mc.logit_softcap)

    def _trip(self, active: np.ndarray, feed: torch.Tensor):
        """One tick, then every slot's draw from its key stream: (tokens
        [R], logits [R, V]) on the device."""
        with torch.profiler.record_function("thinkv.tick"):
            logits = self._tick(active, feed)
            tokens, self._slot_keys = _sample_slots(
                self._slot_keys, logits, self.cfg.temperature,
                self.cfg.top_p)
        return tokens, logits

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
        """A chunk's attention-output and FFN residuals (MoE: the chunk's C
        rows, padded ones included, route together)."""
        return lm.mlp_residual(lp, h + A.out_proj(lp["attn"], o), self.mcfg)

    def _logits(self, h):
        mc, m = self.mcfg, self.model
        h = rmsnorm({"scale": m.final_norm}, h, mc.norm_eps)
        return softcap(E.unembed(m.embed_params, h, mc), mc.logit_softcap)

    @torch.no_grad()
    def _prefill_chunk(self, i: int, tokens: np.ndarray):
        """Up to g prompt tokens of slot ``i`` in one forward (the buffer
        starts empty: chunks align with commits).  Each layer's attention
        runs over this rank's heads; its output is gathered back."""
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
            q, k, v = (self._local(t, 1) for t in (q, k, v))
            km = torch.where(tok_valid[:, None, None], k, 0.0) \
                .to(torch.bfloat16)
            vm = torch.where(tok_valid[:, None, None], v, 0.0) \
                .to(torch.bfloat16)
            cache.buf_k[l] = km
            cache.buf_v[l] = vm

            need = l in self.lstar and refresh_due

            def dense():
                o, p, valid = self._dense_layer(l, q[None], slot, km[None],
                                                vm[None], buf_mask)
                return o[0], _probs_sparsity(p[:, last], valid[:, last],
                                             self.mesh)[0] if need else None

            if self.backend == "kernel":
                o = self._chunk_kernel(q, l, i, km, vm, n_valid)
                if need:
                    spars[l] = dense()[1]
            else:
                o, spars[l] = dense()
            h = self._layer_out(lp, h, self._whole(o, 1))
        sparsity = torch.stack([spars[l] for l in self.lstar]).mean() \
            if refresh_due else torch.zeros((), device=dev)
        self._advance(i, sparsity, n_valid)
        return self._logits(h[last])

    @torch.no_grad()
    def _prefill_big(self, i: int, tokens: np.ndarray):
        """``prefill_chunk`` tokens of slot ``i`` in one forward (intra-chunk
        attention at full precision, one sparsity value for the chunk), then
        C/g group commits in order.  Attention runs over this rank's heads
        and the buffers take its keys and values."""
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
            q, k, v = (self._local(t, 1) for t in (q, k, v))

            need = l in self.lstar and has_refresh

            def dense():
                o, p, valid = self._dense_layer(l, q[None], slot, k[None],
                                                v[None], causal)
                return o[0], _probs_sparsity(
                    p[:, C - 1], valid[:, C - 1], self.mesh)[0] \
                    if need else None

            if self.backend == "kernel":
                o = self._chunk_kernel(q, l, i, k, v, None)
                if need:
                    spars[l] = dense()[1]
            else:
                o, spars[l] = dense()
            h = self._layer_out(lp, h, self._whole(o, 1))
            ks.append(k)
            vs.append(v)
        sparsity = torch.stack([spars[l] for l in self.lstar]).mean() \
            if has_refresh else torch.zeros((), device=dev)
        ks, vs = torch.stack(ks), torch.stack(vs)        # [L, C, H/N, D]
        cache = self.caches.slot(i)
        for g0 in range(0, C, dims.G):
            cache.buf_k.copy_(ks[:, g0:g0 + dims.G])
            cache.buf_v.copy_(vs[:, g0:g0 + dims.G])
            cache.buf_len.fill_(0)
            self._slot_buflen[i] = 0
            self._advance(i, sparsity, dims.G)
        return self._logits(h[C - 1])

    # ------------------------------------------------------------------
    # oversubscribed-pool admission + preemption (host side)
    # ------------------------------------------------------------------

    def _free_per_layer(self) -> np.ndarray:
        return (self.pool.refcount == 0).sum(1).cpu().numpy().astype(np.int64)

    def _host_pool(self):
        """(refcounts [L, NP], every slot's table [R, L, NB]) on the host:
        one read-back of each, shared by a whole pass."""
        return self.pool.refcount.cpu().numpy(), self.tables.cpu().numpy()

    @staticmethod
    def _split_table(table_np: np.ndarray, rc: np.ndarray):
        """``[L, NB]`` (private, shared) masks of a block table against the
        refcounts: a block is PRIVATE iff this table holds its only
        reference.  Releasing the table frees exactly its private blocks;
        only its shared blocks can demand COW claims."""
        mapped = table_np >= 0
        rc_at = np.take_along_axis(rc, np.clip(table_np, 0, None), axis=1)
        private = mapped & (rc_at == 1)
        return private, mapped & ~private

    def _split_held(self, i: int, rc: np.ndarray, tables: np.ndarray):
        """Per-layer (private, shared) mapped-block counts of slot ``i``."""
        private, shared = self._split_table(tables[i], rc)
        return (private.sum(axis=1).astype(np.int64),
                shared.sum(axis=1).astype(np.int64))

    def _commit_due(self, i: int) -> bool:
        """Does slot ``i``'s next written token trigger a group commit?"""
        return (self._slot_ntok[i] + 1) % self.dims.G == 0

    def _cow_demand(self, i: int, host) -> int:
        """Worst-case extra fresh blocks slot ``i``'s next commit can claim
        through COW faults: one per shared block it maps.  ``host`` is the
        caller's ``_host_pool()``; None means no block can be shared."""
        return int(self._split_held(i, *host)[1].max()) if host is not None \
            else 0

    def _sharing_possible(self) -> bool:
        """Can any refcount exceed 1?  False while no fork landed, the
        prefix cache holds no entry, no hit ever mapped shared blocks and
        no spill keeps shared references: the headroom paths then read no
        refcounts."""
        if self.metrics["forks"] > 0:
            return True
        return self.prefix_cache is not None and (
            bool(self.prefix_cache.entries)
            or self.metrics["prefix_hits"] > 0
            or any(st.shared_table is not None
                   and (st.shared_table >= 0).any()
                   for st in self._spilled.values()))

    def _decay_prefix_cache(self, needed, free: np.ndarray = None) -> bool:
        """Evict prefix-cache entries until every layer's free count reaches
        ``needed``, the cache is empty, or no cached block can free; runs
        before any preemption.  The victim is the LRU entry that frees a
        block now (the most recently used one is spared while another
        remains); plain LRU order breaks chains of overlapping entries.
        Returns True if an entry was evicted."""
        if self.prefix_cache is None:
            return False
        if free is None:
            free = self._free_per_layer()
        if not (self.prefix_cache.entries and (free < needed).any()):
            return False
        # one refcount read per call; evictions are mirrored on the host
        rc = self.pool.refcount.cpu().numpy().copy()
        cache_refs = np.zeros_like(rc)
        for t in self.prefix_cache.cached_tables():
            for l in range(self.dims.L):
                np.add.at(cache_refs[l], t[l][t[l] >= 0], 1)
        evicted = False
        while self.prefix_cache.entries and (free < needed).any():
            if not ((cache_refs > 0) & (cache_refs == rc)).any():
                break            # nothing decay could ever free
            lru = self.prefix_cache.lru_entries()
            cand = lru[:-1] if len(lru) > 1 else lru   # spare the MRU
            pick = next((e for e in cand
                         if self._split_table(e.table, rc)[0].any()),
                        cand[0])
            for l in range(self.dims.L):
                ids = pick.table[l][pick.table[l] >= 0]
                np.subtract.at(rc[l], ids, 1)
                np.subtract.at(cache_refs[l], ids, 1)
            self.prefix_cache.evict_entry(self.pool, pick)
            evicted = True
            free = (rc == 0).sum(axis=1).astype(np.int64)
        return evicted

    def _demote_spilled_shared(self) -> bool:
        """Last-resort valve: turn every spill's retained shared references
        into private spill state (decref them, fold them into ``mapped``),
        so decay can free blocks a cache entry and a spill co-hold.  Sound
        because the spill snapshots every mapped block and shared content
        is immutable.  Returns True if a reference was released."""
        changed = False
        for st in self._spilled.values():
            if st.shared_table is None or not (st.shared_table >= 0).any():
                continue
            CC.release_blocks(self.pool, torch.as_tensor(
                st.shared_table, device=self.device))
            st.mapped = st.mapped | (st.shared_table >= 0)
            st.shared_table = None
            changed = True
        return changed

    def _watermark_blocks(self, req: Request) -> np.ndarray:
        """Per-layer block estimate for admitting ``req`` ([L]): a preempted
        request's spilled private mapping plus one commit's claim; a fresh
        one's budget bound ceil((budget + g) / BS) plus one commit's claim,
        capped by NB and by its own length, less a prefix hit's blocks
        (floored at one commit's claim)."""
        dims = self.dims
        st = self._spilled.get(req.arrival)
        if st is not None:
            return st.mapped.sum(axis=1).astype(np.int64) + self._cc
        cap = min(len(req.prompt) + int(req.max_new_tokens),
                  self.tk.token_budget + dims.G)
        est = np.full(dims.L, min(dims.NB, -(-cap // dims.BS) + self._cc),
                      np.int64)
        if self.prefix_cache is not None:
            # a probe (record=False) still freshens the entry, so decay
            # takes the entry this estimate relies on last
            hit = self.prefix_cache.lookup(req.prompt, record=False)
            if hit is not None:
                est = np.maximum(est - hit.blocks_per_layer, self._cc)
        return est

    def _admission_gate(self):
        """Watermark gate for one admission sweep: admit while every
        layer's free count covers the request's estimate after reserving
        one commit's claim per running slot; each admission reserves its
        estimate; a refusal first decays unreferenced cache entries.  One
        free-count read per sweep, re-read only after a decay."""
        running = sum(not s.free for s in self.scheduler.slots)
        state = {"reserved": np.full(self.dims.L, running * self._cc,
                                     np.int64),
                 "free": self._free_per_layer()}

        def gate(req: Request) -> bool:
            need = self._watermark_blocks(req)
            while True:
                if np.all(state["free"] - state["reserved"] >= need):
                    state["reserved"] = state["reserved"] + need
                    return True
                if not self._decay_prefix_cache(need + state["reserved"]):
                    return False
                state["free"] = self._free_per_layer()
        return gate

    def _victim_exclude(self) -> tuple:
        """Slots admitted this sweep whose prefill has not run: they hold
        no blocks and have nothing to spill."""
        return tuple(s.idx for s in self.scheduler.active_slots()
                     if self._slot_ntok[s.idx] == 0)

    def _select_victim(self, exclude: tuple):
        """The scheduler's victim (lowest priority, most private blocks,
        youngest) and its private blocks per layer, from one read-back."""
        host = self._host_pool()
        victim = self.scheduler.select_victim(
            lambda i: int(self._split_held(i, *host)[0].max()),
            exclude=exclude)
        held = None if victim is None else \
            self._split_held(victim.idx, *host)[0]
        return victim, held

    def _spill(self, i: int, mapped: np.ndarray, tokens_out: int,
               next_token: int, shared_table=None) -> PreemptedState:
        """Slot ``i``'s planes (gathered through its table), cache and
        sampling key, copied to host memory, every head whole (each rank
        gathers its shares)."""
        t0 = time.perf_counter()
        view, _ = CC.extract_request(self.pool, self.tables[i])
        cpu = torch.device("cpu")
        st = PreemptedState(
            view=CC.PoolView(*(self._whole(p, SH.PLANE_HEAD_DIM).to(cpu)
                               for p in view)), mapped=mapped,
            cache=CC.CTCache(**{f: self._cache_field(
                f, getattr(self.caches, f)[i], self._whole).to(
                cpu, copy=True) for f in CC.CTCache.FIELDS}),
            tokens_out=tokens_out, next_token=next_token,
            shared_table=shared_table,
            rng=self._slot_keys[i].to(cpu, copy=True).numpy())
        self.metrics["spill_s"] += time.perf_counter() - t0
        self.metrics["spill_bytes"] += st.nbytes
        return st

    @staticmethod
    def _cache_field(name: str, t: torch.Tensor, heads) -> torch.Tensor:
        """One request's cache field, its TBQ buffers passed through
        ``heads`` (a rank's share, or every rank's gathered)."""
        return heads(t, SH.BUF_HEAD_DIM) if name in ("buf_k", "buf_v") \
            else t

    def _preempt(self, slot) -> None:
        """Pause a running request: spill its PRIVATE blocks, table and
        cache to host memory and decref them; its SHARED blocks (refcount
        > 1) free nothing and are immutable, so it keeps those references
        and re-attaches them on resume."""
        i, req = slot.idx, slot.request
        assert self._slot_ntok[i] > 0, \
            "preempting a slot that never started (nothing to spill)"
        table_np = self.tables[i].cpu().numpy()
        private, shared = self._split_table(
            table_np, self.pool.refcount.cpu().numpy())
        self._spilled[req.arrival] = self._spill(
            i, private, slot.tokens_out, int(self._feed[i]),
            np.where(shared, table_np, -1).astype(np.int32))
        self._release_slot(i, torch.as_tensor(
            np.where(private, table_np, -1).astype(np.int32),
            device=self.device))
        self.scheduler.preempt(slot)
        self._queued_at[req.arrival] = self.metrics["ticks"]
        self.metrics["preemptions"] += 1

    def _resume(self, slot, st: PreemptedState) -> bool:
        """Re-admit a preempted request through :meth:`insert`; False (pool
        and slot untouched) when the free list cannot back its mapping."""
        prefix = Prefix(length=int(st.cache.num_tokens),
                        first_token=st.next_token, logits=None, state=st)
        if not self.insert(prefix, slot.idx):
            return False
        slot.tokens_out = st.tokens_out
        self.metrics["resumes"] += 1
        return True

    def _ensure_decode_headroom(self) -> None:
        """Preempt ahead of need so the coming tick's commits cannot fail:
        each committing slot claims at most ceil(g/BS) fresh blocks per
        layer plus one per shared block it maps.  Cache entries decay
        first; then victims, until the free list covers the committing
        slots (preempting the last one zeroes the demand)."""
        sch = self.scheduler
        committing = {s.idx for s in sch.active_slots()
                      if self._commit_due(s.idx)}
        if not committing:
            return
        host = self._host_pool() if self._sharing_possible() else None
        demand = {i: self._cc + self._cow_demand(i, host)
                  for i in committing}
        need = sum(demand.values())
        free = (host[0] == 0).sum(axis=1).astype(np.int64) \
            if host is not None else self._free_per_layer()
        if self._decay_prefix_cache(need, free=free):
            free = self._free_per_layer()
        while need > 0 and int(free.min()) < need:
            victim, held = self._select_victim(self._victim_exclude())
            assert victim is not None    # a committing slot always remains
            free = free + held
            if victim.idx in committing:
                committing.discard(victim.idx)
                need -= demand.pop(victim.idx)
            self._preempt(victim)

    def _safe_decode_trips(self, cap: int, active_idx) -> int:
        """Largest trip count ``T <= cap`` whose worst-case commit claims
        the free list covers: over T ticks slot ``i`` commits
        ``(ntok_i % G + T) // G`` times, ceil(G/BS) fresh blocks per layer
        each, plus at most one COW claim per shared block it maps.  Frees
        only add mid-pack, so today's free count suffices.  One trip is
        always safe (``_ensure_decode_headroom`` just ran)."""
        if cap <= 1:
            return 1
        host = self._host_pool() if self._sharing_possible() else None
        free = (host[0] == 0).sum(axis=1).astype(np.int64) \
            if host is not None else self._free_per_layer()
        budget = int(free.min())
        cow_extra = sum(self._cow_demand(i, host) for i in active_idx)
        G, trips = self.dims.G, 1
        for T in range(2, cap + 1):
            claims = sum((int(self._slot_ntok[i]) % G + T) // G
                         for i in active_idx) * self._cc + cow_extra
            if claims > budget:
                break
            trips = T
        return trips

    def _ensure_prefill_headroom(self, idx: int, n_blocks: int) -> None:
        """Free headroom for one prefill-chunk commit of slot ``idx`` (COW
        claims included): decay cache entries, then preempt OTHER slots.
        Raises only when nothing is preemptible and the pool still cannot
        back the commit."""
        host = self._host_pool() if self._sharing_possible() else None
        n_blocks = n_blocks + self._cow_demand(idx, host)
        free = (host[0] == 0).sum(axis=1).astype(np.int64) \
            if host is not None else self._free_per_layer()
        if self._decay_prefix_cache(n_blocks, free=free):
            free = self._free_per_layer()
        while int(free.min()) < n_blocks:
            victim, held = self._select_victim((idx,) +
                                               self._victim_exclude())
            if victim is None:
                if self._demote_spilled_shared():
                    self._decay_prefix_cache(n_blocks)
                    free = self._free_per_layer()
                    if int(free.min()) >= n_blocks:
                        break
                raise RuntimeError(
                    f"pool exhausted: {self.num_pool_blocks} physical "
                    f"blocks cannot back one prefill commit ({n_blocks} "
                    f"blocks/layer) for the only block-holding request — "
                    f"nothing is preemptible")
            free = free + held
            self._preempt(victim)

    def _release_slot(self, i: int, table: Optional[torch.Tensor] = None
                      ) -> None:
        """Decref ``table`` (default: everything slot ``i`` maps; a
        preemption passes its private mapping) and reset the slot."""
        CC.release_blocks(self.pool, self.tables[i] if table is None
                          else table)
        self.tables[i].fill_(CC.UNMAPPED)
        self.caches.slot(i).copy_(self._fresh)
        self._slot_ntok[i] = 0
        self._slot_buflen[i] = 0
        self._forked[i] = False

    def audit_pool(self) -> Dict:
        """Assert the refcount invariants across every holder: slot tables,
        prefix-cache entries and spills' retained shared tables."""
        extra = [st.shared_table for st in self._spilled.values()
                 if st.shared_table is not None]
        if self.prefix_cache is not None:
            extra += self.prefix_cache.cached_tables()
        return CC.check_pool_invariants(self.pool, self.tables, extra)

    # ------------------------------------------------------------------
    # prefill with the prefix cache
    # ------------------------------------------------------------------

    def _prefill(self, i: int, prompt: np.ndarray) -> torch.Tensor:
        """Chunked prefill of slot ``i``; returns the last-token logits.

        A prefix-cache hit maps the cached blocks (one more reference),
        restores the snapshot and skips the covered chunks (an exact
        full-prompt hit runs no forward).  Then 128-multiple big chunks,
        each only while the free list covers its worst-case claims (C/g
        commits with no frees between, plus one COW claim per shared
        block), then chunks of g, each after ``_ensure_prefill_headroom``.
        Commit-aligned boundaries and the end of the prompt are registered
        in the cache.  The slot's rows change in place; preempting other
        slots for headroom never touches them."""
        dims, C, BC = self.dims, self.dims.G, self.prefill_chunk
        pc = self.prefix_cache
        s0, logits = 0, None
        hit = pc.lookup(prompt) if pc is not None else None
        if hit is not None:
            table = torch.as_tensor(hit.table, device=self.device)
            CC.incref_blocks(self.pool, table)
            self.tables[i].copy_(table)
            self.caches.slot(i).copy_(hit.cache)
            s0 = hit.length
            # a boundary entry's buffer is empty, a full_only one holds
            # the prompt's last partial chunk
            self._slot_ntok[i], self._slot_buflen[i] = s0, s0 % C
            logits = hit.logits
            self.metrics["prefix_hits"] += 1
            self.metrics["prefix_tokens_skipped"] += s0

        def register(boundary: int) -> None:
            if pc is not None and boundary > 0:
                pc.register(self.pool, prompt, boundary, self.tables[i],
                            self.caches.slot(i), logits,
                            full_only=boundary % C != 0)

        big_claims = (BC // C) * self._cc if BC else 0
        while BC and len(prompt) - s0 >= BC:
            t_np = self.tables[i].cpu().numpy()
            rc = self.pool.refcount.cpu().numpy()   # one read per chunk
            shared = self._split_table(t_np, rc)[1]
            need = np.minimum(big_claims, dims.NB - (t_np >= 0).sum(1)) + \
                shared.sum(1)
            free = (rc == 0).sum(axis=1).astype(np.int64)
            if self._decay_prefix_cache(need, free=free):
                free = self._free_per_layer()
            if (free < need).any():
                break            # tight pool: g-sized chunks from here on
            logits = self._prefill_big(i, prompt[s0:s0 + BC])
            self.metrics["prefill_big_chunks"] += 1
            s0 += BC
            register(s0)
        for s in range(s0, len(prompt), C):
            self._ensure_prefill_headroom(i, self._cc)
            chunk = prompt[s:s + C]
            logits = self._prefill_chunk(i, chunk)
            self.metrics["prefill_chunks"] += 1
            register(s + len(chunk))
        self._check_fails()
        self.metrics["prefill_tokens"] += len(prompt) - (
            hit.length if hit is not None else 0)
        return logits

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

    def prefill(self, prompt: np.ndarray, slot_idx: int,
                arrival: Optional[int] = None) -> Prefix:
        """Chunked prefill of ``prompt`` into ``slot_idx`` (prefix-cache hits
        and headroom preemption of other slots happen inside), then the
        first token: the first draw of the request's key stream, seeded
        from ``arrival`` (the slot index when None, for callers without a
        scheduler); returns the RESIDENT prefix."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("thinkv.prefill"):
            logits = self._prefill(slot_idx, np.asarray(prompt)).float()
            key = SMP.request_stream_key(
                self.cfg.seed, slot_idx if arrival is None else arrival,
                self.device)
            tok, self._slot_keys[slot_idx] = SMP.stream_sample(
                key, logits, self.cfg.temperature, self.cfg.top_p)
            first, logits = int(tok), logits.cpu().numpy()
        self.metrics["prefill_s"] += time.perf_counter() - t0
        return Prefix(length=len(prompt), first_token=first, logits=logits,
                      slot=slot_idx)

    def detach_prefix(self, prefix: Prefix) -> Prefix:
        """RESIDENT -> PORTABLE: spill the slot's planes and cache to host
        memory and release every pool reference it held.  Shared blocks
        are spilled like private ones (the spill snapshots every mapped
        block), so the portable prefix pins nothing here."""
        if prefix.state is not None or prefix.slot < 0:
            raise ValueError("detach_prefix needs a resident prefix")
        i = prefix.slot
        prefix.state = self._spill(i, self.tables[i].cpu().numpy() >= 0, 0,
                                   prefix.first_token)
        self._release_slot(i)
        prefix.slot = -1
        return prefix

    def insert(self, prefix: Prefix, slot_idx: int) -> bool:
        """Materialize ``prefix`` in slot ``slot_idx``.  A resident prefix
        only seeds the feed.  A portable one (a detached prefill or a
        spill) claims fresh blocks for its mapping, scatters the planes
        back, re-attaches retained shared blocks and restores the cache:
        reads go through the table in logical order, so the result is
        bit-identical.  False (pool untouched) when the free list cannot
        back the mapping."""
        i = slot_idx
        if prefix.state is None:
            if prefix.slot != i:
                raise ValueError(f"resident prefix lives in slot "
                                 f"{prefix.slot}; detach it before inserting "
                                 f"into slot {i}")
            self._feed[i] = prefix.first_token
            return True
        st, dev = prefix.state, self.device
        table, ok = CC.restore_request(
            self.pool, torch.as_tensor(st.mapped, device=dev),
            CC.PoolView(*(self._local(p, SH.PLANE_HEAD_DIM).to(dev)
                          for p in st.view)))
        if not bool(ok):
            CC.release_blocks(self.pool, table)
            return False
        if st.shared_table is not None:
            shared = torch.as_tensor(st.shared_table, device=dev)
            table = torch.where(shared >= 0, shared, table)
        self.tables[i].copy_(table)
        self.caches.slot(i).copy_(CC.CTCache(**{
            f: self._cache_field(f, getattr(st.cache, f), self._local)
            for f in CC.CTCache.FIELDS}))
        self._slot_ntok[i] = int(st.cache.num_tokens)
        self._slot_buflen[i] = int(st.cache.buf_len)
        self._feed[i] = st.next_token
        if st.rng is not None:
            self._slot_keys[i] = torch.as_tensor(st.rng, device=dev)
        return True

    def generate(self) -> Union[TickResult, MultiTickResult, None]:
        """Headroom, then one dispatch over every occupied slot; None when
        headroom preempted every slot.  With ``ticks_per_dispatch`` 1 it is
        one tick (:class:`TickResult`); above, a pack of trips
        (:class:`MultiTickResult`) that stops where the reference's loop
        does: at the claim-safe cap, after the trip on which a slot reaches
        its token allowance, or after the trip on which a slot samples its
        eos token.  The result holds device tensors: route it through
        :meth:`consume`, which settles a pack's ticks and tokens."""
        self._ensure_decode_headroom()
        active = np.array([not s.free for s in self.scheduler.slots])
        if not active.any():
            return None
        self.metrics["dispatches"] += 1
        t0 = time.perf_counter()
        feed = torch.as_tensor(self._feed, device=self.device)
        if self.ticks_per_dispatch == 1:
            tokens, logits = self._trip(active, feed)
            self.metrics["ticks"] += 1
            self.metrics["tokens"] += int(active.sum())
            return TickResult(int(self.metrics["ticks"]), tokens, logits,
                              self._flags(), t0)
        slots = self.scheduler.active_slots()
        requested = self._safe_decode_trips(self.ticks_per_dispatch,
                                            [s.idx for s in slots])
        if requested < self.ticks_per_dispatch:
            self.metrics["early_exit_headroom"] += 1
        trips = min([requested] + [
            max(1, int(s.request.max_new_tokens) - int(s.tokens_out))
            for s in slots])
        eos = {s.idx: int(s.request.eos_token) for s in slots
               if s.request.eos_token is not None}
        eos_dev = torch.tensor([eos.get(i, -1) for i in range(len(active))],
                               device=self.device) if eos else None
        tokens, valid, logits = self._pack(active, feed, trips, eos_dev)
        return MultiTickResult(int(self.metrics["ticks"]),
                               self.ticks_per_dispatch, requested, tokens,
                               valid, logits, self._flags(), t0)

    def _pack(self, active: np.ndarray, feed: torch.Tensor, trips: int,
              eos_dev: Optional[torch.Tensor] = None):
        """Up to ``trips`` trips, each trip's tokens feeding the next; with
        ``eos_dev`` ([R], -1 where a slot has no eos) it stops after the
        trip on which a slot samples its eos (one read per trip).  Returns
        per-trip (tokens, active mask, logits) lists."""
        tokens, valid, logits = [], [], []
        for _ in range(trips):
            feed, lg = self._trip(active, feed)
            tokens.append(feed)
            valid.append(active)
            logits.append(lg)
            if eos_dev is not None and bool((feed == eos_dev).any()):
                break
        return tokens, valid, logits

    def consume(self, res: Union[TickResult, MultiTickResult]):
        """Fold a dispatch's COW faults into the metrics (those on forked
        slots also into ``fork_cow_faults``) and assert its commits did not
        fail (blocks on the result's host copy).  A pack's executed trips
        land in ``ticks`` and its valid rows in ``tokens``; fewer trips
        than requested count an ``early_exit_finish``."""
        if res.alloc_fail_host:
            raise AssertionError(
                "decode commit allocation failed despite preemption "
                "headroom (pool accounting bug — data would have been "
                "dropped)")
        cow = res.cow_per_slot_host
        self.metrics["cow_faults"] += int(cow.sum())
        self.metrics["fork_cow_faults"] += int(cow[self._forked].sum())
        if res.packed:
            if res.trips_host < res.requested:
                self.metrics["early_exit_finish"] += 1
            self.metrics["ticks"] += res.trips_host
            self.metrics["tokens"] += int(res.valid_host.sum())
        self.metrics["decode_s"] += time.perf_counter() - res.t0
        return res

    def fork_slot(self, src: int, dst: int, arrival: int) -> None:
        """Fork slot ``src``'s sequence into the free slot ``dst`` by
        reference: every block the parent maps gains a reference (no plane
        copy), the table and cache rows, the host mirrors and the feed are
        copied, and the child's key stream starts from its own ``arrival``
        (so at temperature 0 it emits its parent's tokens, above it
        diverges from its first draw).  The first commit either side makes
        on a shared block COW-faults a private copy."""
        if not self._track_cow:
            raise ValueError("fork_slot needs allow_forks=True (COW write "
                             "tracking)")
        if self._slot_ntok[src] == 0:
            raise ValueError(f"fork source slot {src} never started")
        if self._slot_ntok[dst] != 0:
            raise ValueError(f"fork target slot {dst} is in use")
        CC.incref_blocks(self.pool, self.tables[src])
        self.tables[dst].copy_(self.tables[src])
        self.caches.slot(dst).copy_(self.caches.slot(src))
        self._slot_ntok[dst] = self._slot_ntok[src]
        self._slot_buflen[dst] = self._slot_buflen[src]
        self._feed[dst] = self._feed[src]
        self._slot_keys[dst] = SMP.request_stream_key(self.cfg.seed, arrival,
                                                      self.device)
        self._forked[src] = self._forked[dst] = True
        self.metrics["forks"] += 1
        self.metrics["peak_refcount"] = max(
            self.metrics["peak_refcount"], int(self.pool.refcount.max()))

    def free_resource(self, slot_idx: int) -> None:
        """Release every pool reference of ``slot_idx`` and reset it
        (retirement and cancellation)."""
        self._release_slot(slot_idx)

    def drop_spill(self, arrival: int) -> bool:
        """Drop a cancelled request's spill, releasing the shared references
        it kept (``audit_pool`` counts them)."""
        st = self._spilled.pop(arrival, None)
        if st is None:
            return False
        if st.shared_table is not None and (st.shared_table >= 0).any():
            CC.release_blocks(self.pool, torch.as_tensor(
                st.shared_table, device=self.device))
        return True

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        """Serve everything submitted through the orchestrator's
        synchronous episode (the reference's decision order); returns the
        finished requests."""
        from repro_torch.serving.orchestrator import Orchestrator
        orch = Orchestrator(self)
        self.last_orchestrator = orch
        return orch.run_sync(max_ticks=max_ticks)

    # ------------------------------------------------------------------
    # logit-drift probe (quality telemetry)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _drift_probe(self, tokens: torch.Tensor, rows: slice
                     ) -> torch.Tensor:
        """The uncompressed reference forward of the drift probe: the dense
        teacher-forced pass (no ThinKV cache, no quantization, no eviction)
        over tokens [1, S], the logits of positions ``rows`` only.  It is
        the prefill step's dense path (``models/lm.py``: assemble_inputs,
        backbone, unembed); causal attention makes a right-padded tail
        harmless."""
        h, positions = lm.assemble_inputs(self.model, {"tokens": tokens},
                                          self.mcfg)
        h, _ = lm.backbone(self.model, h, self.mcfg, positions)
        return self.model.unembed(h[0, rows])

    def measure_drift(self, prompt: np.ndarray, output: Sequence[int],
                      recorded: Sequence[np.ndarray]) -> Dict[str, float]:
        """A finished request's recorded serving logits (one [V] array per
        emitted token) against the dense replay of the same tokens
        (``prompt + output[:-1]``, right-padded to a multiple of
        ``DRIFT_PAD``): ``recorded[i]`` predicted ``output[i]`` from the
        compressed cache, the replay's position ``len(prompt) - 1 + i``
        from the full-precision context.  Returns ``steps``, ``max_abs``,
        ``mean_abs`` (the mean over steps of each step's mean |difference|)
        and ``top1_agree`` (the share of steps whose argmaxes agree)."""
        if not self.drift_probe:
            raise RuntimeError("engine built without drift_probe=True")
        p = int(len(prompt))
        toks = np.concatenate([np.asarray(prompt, np.int64),
                               np.asarray(list(output), np.int64)])
        n = len(toks) - 1 if len(output) else len(toks)
        pad = -(-max(n, 1) // DRIFT_PAD) * DRIFT_PAD
        buf = np.zeros((1, pad), np.int64)
        buf[0, :n] = toks[:n]
        steps = min(len(output), len(recorded))
        ref = self._drift_probe(torch.as_tensor(buf, device=self.device),
                                slice(p - 1, p - 1 + steps))
        ref = ref.float().cpu().numpy()
        max_abs = mean_abs = 0.0
        top1 = 0
        for i in range(steps):
            got = np.asarray(recorded[i], np.float32).reshape(-1)
            want = ref[i]
            d = np.abs(got - want)
            max_abs = max(max_abs, float(d.max()))
            mean_abs += float(d.mean())
            top1 += int(np.argmax(got) == np.argmax(want))
        out = {"steps": steps, "max_abs": max_abs,
               "mean_abs": mean_abs / max(steps, 1),
               "top1_agree": top1 / max(steps, 1)}
        self.metrics["drift_probes"] += 1
        self.metrics["drift_max_abs"] = max(self.metrics["drift_max_abs"],
                                            max_abs)
        return out

    # ------------------------------------------------------------------
    # compiled-path checks (repro_torch.analysis)
    # ------------------------------------------------------------------

    def compiled_entry_points(self) -> Dict[str, tuple]:
        """``{name: (fn, prepare)}`` for every entry point of the device
        seam whose launches ``analysis.contracts.engine_contracts`` pins
        (the reference's registry, by its names; ``_commit_fn`` is the
        port's own: its commit launches K4).  ``prepare()`` puts a scratch
        request into slot 0 of an idle engine and returns the arguments
        ``fn`` is called with; the caller releases the slot after.
        Registering an entry point here needs a contract there
        (``audit_engine`` raises on one without)."""
        G, V = self.dims.G, self.mcfg.vocab_size
        R = self.cfg.max_seqs
        active = np.zeros(R, bool)
        active[0] = True

        def toks(n):
            return (np.arange(n, dtype=np.int64) * 7 + 3) % V

        def fresh(n=0):
            if any(not s.free for s in self.scheduler.slots) or \
                    self._slot_ntok[0]:
                raise RuntimeError("the entry points run on an idle engine")
            if n:
                self._prefill_chunk(0, toks(n))
                self._check_fails()

        def tick():
            fresh(1)           # the tick writes token 2: no commit when G > 2
            return active, torch.zeros(R, dtype=torch.int64,
                                       device=self.device)

        def chunk(n):
            def prepare():
                fresh()
                return 0, toks(n)
            return prepare

        def commit():
            fresh(G - 1)
            return 0, torch.zeros((), device=self.device), 1

        eps = {"_tick_fn": (self._trip, tick),
               "_prefill_chunk_fn": (self._prefill_chunk, chunk(G)),
               "_commit_fn": (self._advance, commit)}
        if self.ticks_per_dispatch > 1:
            eps["_megatick_fn"] = (self._pack, lambda: (
                *tick(), self.ticks_per_dispatch))
        if self.prefill_chunk:
            eps["_prefill_big_fn"] = (self._prefill_big,
                                      chunk(self.prefill_chunk))
        if self.drift_probe:
            eps["_drift_probe_fn"] = (self._drift_probe, lambda: (
                torch.as_tensor(toks(DRIFT_PAD)[None], device=self.device),
                slice(0, DRIFT_PAD)))
        return eps

    def audit_compiled(self):
        """Contract audit of every entry point -> ``analysis.AuditReport``
        (launches per kernel, collectives, fp64; host syncs reported)."""
        from repro_torch.analysis import audit_engine
        return audit_engine(self)

    def _entry_census(self, name: str):
        from repro_torch.analysis.census import census_of
        fn, prepare = self.compiled_entry_points()[name]
        try:
            return census_of(fn, *prepare(), engine=self,
                             trips=name == "_megatick_fn")
        finally:
            self._release_slot(0)

    def tick_launch_count(self) -> int:
        """Kernel launches of one decode tick, counted by running it: K1
        once on the kernel backend at any layer count, none on the
        reference backend (on the CPU: the plain versions' dispatches)."""
        return sum(self._entry_census("_tick_fn").launches.values())

    def megatick_launch_count(self) -> tuple:
        """``(per_trip, outside)`` launches of a pack of
        ``ticks_per_dispatch`` trips: K1 once per trip on the kernel
        backend, none outside the trips."""
        if self.ticks_per_dispatch == 1:
            raise ValueError("multi-tick dispatch is off "
                             "(ticks_per_dispatch == 1)")
        c = self._entry_census("_megatick_fn")
        return sum((c.launches_per_trip or {}).values()), \
            sum(c.launches_outside_trips.values())

    def prefill_launch_count(self) -> int:
        """Attention launches of one g-chunk (K2 and K3 once per layer on
        the kernel backend); its commit's K4 is not counted here."""
        c = self._entry_census("_prefill_chunk_fn")
        return sum(n for k, n in c.launches.items() if k != "group_quant")

    def slot_stats(self, i: int) -> Dict:
        comp = TV.compression_ratio(self.tk, self.dims, self.caches.slot(i),
                                    int(self._slot_ntok[i]))
        return {k: (v.tolist() if torch.is_tensor(v) else v)
                for k, v in comp.items()}
