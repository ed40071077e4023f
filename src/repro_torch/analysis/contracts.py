"""Declarative contracts over the engine's entry points (ports
``repro/analysis/contracts.py``).

A :class:`CompiledContract` pins what one entry point may do: exact kernel
launches per kernel (fixed, per trip of a pack, per group commit), no
float64 tensor (but from code it names: the sampled tick's
``SAMPLED_FP64``), and a :class:`CollectiveRule` bounding cross-rank
communication.  ``audit_engine(engine)`` runs every entry point the engine
registers (``ThinKVEngine.compiled_entry_points``) once under
``analysis.census`` and checks it against ``engine_contracts(engine)``; a
registered entry point with no contract is itself an error.

Where the reference reads a jaxpr, the port runs the call: its counts are
what the call did, on the card launches and on the CPU the plain versions'
dispatches.  Host syncs are counted and reported per entry point, not
pinned (ROADMAP item 17 exists to lower them).  Not ported: the
callback and in-graph transfer rules and the cond-divergence rule (host
branches are Python, and a run counts the launches of the branch taken),
and ``audit_train_step`` (ROADMAP item 16).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.analysis.census import Census, census_of, fp64_origin

_MAX_ITEMIZED = 5      # cap per-item violations so reports stay readable

K1, K2, K3, K4 = ("ct_paged_attention_fused", "ct_paged_attention_batched",
                  "flash_prefill", "group_quant")

#: The sampled tick's one float64 source: ``prng.uniform`` emulates XLA's
#: fused scale-and-shift of ``jax.random.uniform`` (one f32 FMA) with an
#: exact f64 product and one rounding, so sampled tokens equal JAX's; five
#: f64 temporaries a draw.  Named, so that any other fp64 still fails.
SAMPLED_FP64 = ("serving/prng.py:uniform",)


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken contract rule."""
    contract: str
    rule: str            # launch-count | launch-per-trip | collective | fp64
    message: str
    path: str = ""

    def __str__(self) -> str:
        loc = f" at {self.path}" if self.path else ""
        return f"[{self.contract}] {self.rule}: {self.message}{loc}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CollectiveRule:
    """What cross-rank communication an entry point may run.

    ``movement`` collectives (the tiled head all-gather) are allowed at any
    dtype: they are bit-exact concatenation.  ``integer_reductions`` (the
    COW dirty-mask sum) are allowed on integer and bool operands only:
    integer sums are exact in any order.  A float reduction must appear in
    ``float_reductions`` as a ``(collective, axis)`` pair; the serving
    engine allows none (bit-identity across rank counts)."""
    movement: Tuple[str, ...] = ("all_gather",)
    integer_reductions: Tuple[str, ...] = ("all_reduce",)
    float_reductions: Tuple[Tuple[str, str], ...] = ()
    axis: str = "model"

    def check(self, contract: str, collectives) -> List[Violation]:
        out = []
        for c in collectives:
            if not c.reduces:
                if c.name in self.movement:
                    continue
                out.append(Violation(
                    contract, "collective",
                    f"{c.name}({c.dtype}) is not a whitelisted movement "
                    f"collective (allowed: {list(self.movement)})", c.op))
                continue
            is_float = c.dtype.startswith(("float", "bfloat", "complex"))
            if not is_float and c.name in self.integer_reductions:
                continue
            if is_float and (c.name, self.axis) in self.float_reductions:
                continue
            out.append(Violation(
                contract, "collective",
                f"reduction {c.name}({c.dtype}) crosses ranks — the "
                f"bit-identity contract allows integer "
                f"{list(self.integer_reductions)} and movement "
                f"{list(self.movement)} only", c.op))
        return out


def _fmt(d: Mapping[str, int]) -> str:
    return ", ".join(f"{k} x{n}" for k, n in sorted(d.items())) or "(none)"


@dataclasses.dataclass(frozen=True)
class CompiledContract:
    """The declared invariants of ONE entry point.  Kernels in
    ``launches_per_commit`` are held in total (fixed + per trip + per
    commit); the others outside the trips to ``launches`` and in every
    trip to ``launches_per_trip``."""
    name: str
    launches: Mapping[str, int] = dataclasses.field(default_factory=dict)
    launches_per_trip: Mapping[str, int] = \
        dataclasses.field(default_factory=dict)
    launches_per_commit: Mapping[str, int] = \
        dataclasses.field(default_factory=dict)
    forbid_fp64: bool = True
    #: code (``file:function`` under ``src/repro_torch``) whose float64
    #: values are allowed
    fp64_allowance: Tuple[str, ...] = ()
    #: None = collectives unchecked; a rule = every collective must
    #: satisfy it.
    collectives: Optional[CollectiveRule] = None
    note: str = ""

    def check(self, census: Census) -> List[Violation]:
        v: List[Violation] = []
        per_commit = set(self.launches_per_commit)
        kernels = set(census.launches) | set(self.launches) | \
            set(self.launches_per_trip) | per_commit
        for k in sorted(kernels & per_commit):
            want = (self.launches.get(k, 0)
                    + self.launches_per_trip.get(k, 0) * census.trips
                    + self.launches_per_commit[k] * census.commits)
            got = census.launches.get(k, 0)
            if got != want:
                v.append(Violation(
                    self.name, "launch-count",
                    f"{k}: {got} launch(es) for {census.commits} "
                    f"commit(s) and {census.trips} trip(s), contract pins "
                    f"{want}; launches: {_fmt(census.launches)}"))
        outside = census.launches_outside_trips
        for k in sorted(kernels - per_commit):
            got, want = outside.get(k, 0), self.launches.get(k, 0)
            if got != want:
                v.append(Violation(
                    self.name, "launch-count",
                    f"{k}: {got} launch(es) outside trips, contract pins "
                    f"{want}; launches: {_fmt(census.launches)}"))
        want_trip = {k: n for k, n in self.launches_per_trip.items()
                     if n and k not in per_commit}
        for i, trip in enumerate(census.per_trip):
            got_trip = {k: n for k, n in trip.items() if k not in per_commit}
            if got_trip != want_trip:
                v.append(Violation(
                    self.name, "launch-per-trip",
                    f"trip {i}: {_fmt(got_trip)}, contract pins "
                    f"{_fmt(want_trip)}"))
        if self.forbid_fp64:
            bad = [e for e in census.fp64
                   if fp64_origin(e) not in self.fp64_allowance]
            for e in bad[:_MAX_ITEMIZED]:
                v.append(Violation(self.name, "fp64",
                                   f"float64 value from {e}"))
            if len(bad) > _MAX_ITEMIZED:
                v.append(Violation(
                    self.name, "fp64",
                    f"... and {len(bad) - _MAX_ITEMIZED} more"))
        if self.collectives is not None:
            v.extend(self.collectives.check(self.name, census.collectives))
        return v

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["collectives"] = (dataclasses.asdict(self.collectives)
                            if self.collectives is not None else None)
        return d


class ContractViolation(AssertionError):
    """Raised by ``AuditReport.raise_on_violation``: the message lists
    every broken rule."""


@dataclasses.dataclass
class EntryAudit:
    """census + contract + violations for one entry point."""
    name: str
    census: Census
    contract: CompiledContract
    violations: List[Violation]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {"name": self.name, "ok": self.ok,
                "census": self.census.to_dict(),
                "contract": self.contract.to_dict(),
                "violations": [v.to_dict() for v in self.violations]}


@dataclasses.dataclass
class AuditReport:
    """All entry-point audits of one engine cell."""
    entries: Dict[str, EntryAudit]
    meta: Dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(e.ok for e in self.entries.values())

    @property
    def violations(self) -> List[Violation]:
        return [v for e in self.entries.values() for v in e.violations]

    def host_syncs(self) -> Dict[str, int]:
        """Host syncs per entry point (reported, not pinned)."""
        return {k: e.census.host_sync_count
                for k, e in sorted(self.entries.items())}

    def raise_on_violation(self) -> "AuditReport":
        if not self.ok:
            lines = "\n".join(f"  {v}" for v in self.violations)
            raise ContractViolation(
                f"entry-point contract audit failed "
                f"({len(self.violations)} violation(s)):\n{lines}")
        return self

    def summary(self) -> str:
        lines = []
        for name, e in sorted(self.entries.items()):
            c = e.census
            status = "OK " if e.ok else "FAIL"
            lines.append(
                f"[{status}] {name}: launches {_fmt(c.launches)} "
                f"({c.trips} trips, {c.commits} commits) "
                f"collectives={len(c.collectives)} fp64={len(c.fp64)} "
                f"host_syncs={c.host_sync_count}")
            lines.extend(f"       {v}" for v in e.violations)
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"ok": self.ok, "meta": dict(self.meta),
                "host_syncs": self.host_syncs(),
                "entries": {k: e.to_dict()
                            for k, e in sorted(self.entries.items())}}


def serve_collective_rule() -> CollectiveRule:
    """The serving engine's collective whitelist, sourced from the sharding
    scheme (``distributed.sharding.serve_collective_whitelist``) so the
    contract and the head layout live together."""
    from repro_torch.distributed import sharding as SH
    w = SH.serve_collective_whitelist()
    return CollectiveRule(
        movement=tuple(w["movement"]),
        integer_reductions=tuple(w["integer_reductions"]),
        float_reductions=tuple(w["float_reductions"]),
        axis=SH.SERVE_HEAD_AXIS)


def engine_contracts(engine) -> Dict[str, CompiledContract]:
    """The declared contract of every ``ThinKVEngine`` entry point.  Kernel
    backend: the decode tick is ONE fused K1 launch at any layer count, a
    pack one per trip and none outside, a prefill chunk (g-sized or big)
    K2 and K3 once per layer.  Reference backend: no attention kernel.
    Both: a group commit is one K4 launch (the cache quantizes through K4
    on either backend), and the drift probe's dense replay launches
    nothing.  All share the serve collective whitelist and forbid fp64; a
    sampling engine's tick and pack allow ``SAMPLED_FP64`` by name."""
    L = engine.mcfg.num_layers
    k = engine.backend == "kernel"
    rule = serve_collective_rule()
    f64 = SAMPLED_FP64 if engine.cfg.temperature > 0 else ()
    commit = {K4: 1}
    chunk = {K2: L, K3: L} if k else {}
    return {
        "_tick_fn": CompiledContract(
            "_tick_fn", launches={K1: 1} if k else {},
            launches_per_commit=commit, collectives=rule,
            fp64_allowance=f64, note="decode trip: one fused K1 launch"),
        "_megatick_fn": CompiledContract(
            "_megatick_fn", launches_per_trip={K1: 1} if k else {},
            launches_per_commit=commit, collectives=rule,
            fp64_allowance=f64,
            note="a pack: one fused K1 launch per trip, none outside"),
        "_prefill_chunk_fn": CompiledContract(
            "_prefill_chunk_fn", launches=chunk, launches_per_commit=commit,
            collectives=rule,
            note="g-chunk: K2 + K3 per layer (the reference runs the "
                 "intra-chunk part as plain jnp; the port runs K3)"),
        "_prefill_big_fn": CompiledContract(
            "_prefill_big_fn", launches=chunk, launches_per_commit=commit,
            collectives=rule, note="big chunk: K2 + K3 per layer"),
        "_commit_fn": CompiledContract(
            "_commit_fn", launches_per_commit=commit, collectives=rule,
            note="group commit: one K4 launch"),
        "_drift_probe_fn": CompiledContract(
            "_drift_probe_fn", collectives=rule,
            note="drift probe: dense replay, whole on every rank, no "
                 "kernel launches on either backend"),
    }


def audit_engine(engine,
                 contracts: Optional[Dict[str, CompiledContract]] = None,
                 ) -> AuditReport:
    """Run every registered engine entry point once on a scratch request
    (slot 0 of an idle engine, released after each) and audit it against
    its contract.  Raises ``KeyError`` if an entry point has no declared
    contract.  On a mesh every rank must call it: the entry points
    gather."""
    eps = engine.compiled_entry_points()
    cons = dict(engine_contracts(engine))
    if contracts:
        cons.update(contracts)
    missing = sorted(set(eps) - set(cons))
    if missing:
        raise KeyError(
            f"no CompiledContract declared for engine entry point(s) "
            f"{missing} — add one to analysis.contracts.engine_contracts")
    entries = {}
    for name, (fn, prepare) in eps.items():
        try:
            census = census_of(fn, *prepare(), engine=engine,
                               trips=name == "_megatick_fn")
        finally:
            engine._release_slot(0)
        entries[name] = EntryAudit(name, census, cons[name],
                                   cons[name].check(census))
    meta = {"backend": engine.backend, "layers": int(engine.mcfg.num_layers),
            "ranks": int(engine._nshard), "rank": int(engine._rank),
            "device": str(engine.device),
            "ticks_per_dispatch": int(engine.ticks_per_dispatch),
            "max_seqs": int(engine.cfg.max_seqs)}
    return AuditReport(entries=entries, meta=meta)


def audit_flash_prefill(seq: int = 128, heads: int = 4, kv_heads: int = 2,
                        head_dim: int = 16, device="cpu") -> EntryAudit:
    """Contract audit of the standalone K3 entry (``ops.prefill_attention``):
    exactly one launch, no fp64."""
    import torch

    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    q = torch.randn(seq, heads, head_dim, generator=g).to(device)
    kv = torch.randn(seq, kv_heads, head_dim, generator=g).to(device)
    census = census_of(ops.prefill_attention, q, kv, kv)
    con = CompiledContract("flash_prefill", launches={K3: 1},
                           collectives=CollectiveRule(),
                           note="standalone prefill kernel: one launch")
    return EntryAudit("flash_prefill", census, con, con.check(census))


def _model_step_audits(arch: str = "r1-llama-8b", device="cpu"
                       ) -> Dict[str, EntryAudit]:
    """Contract audits of the serve steps (``serving/serve_step.py``) at
    the smoke config: the prefill step and a FullKV decode step over bf16
    caches, neither launching a kernel.  No fp64; collectives unchecked.
    The train step belongs to ROADMAP item 16."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import factory
    from repro_torch.serving import serve_step as SS

    cfg = get_smoke_config(arch)
    model = factory.build_model(cfg)
    params = model.init_params(0, device)
    B, S, T = 2, 16, 32
    tokens = torch.arange(B * S, device=device).reshape(B, S) \
        % cfg.vocab_size
    cache = torch.zeros((B, cfg.num_layers, T, cfg.num_kv_heads,
                         cfg.head_dim), dtype=torch.bfloat16, device=device)
    steps = {
        "prefill_step": (SS.make_prefill_step(model, cfg),
                         {"tokens": tokens}),
        "decode_step_fullkv": (SS.make_decode_step_fullkv(cfg), {
            "tokens": tokens[:, -1], "positions": torch.full(
                (B,), S, device=device), "k_cache": cache,
            "v_cache": cache.clone(), "cache_len": torch.full(
                (B,), S, dtype=torch.int32, device=device)})}
    out: Dict[str, EntryAudit] = {}
    for name, (fn, batch) in steps.items():
        census = census_of(fn, params, batch)
        con = CompiledContract(name, note="serve step at the smoke config")
        out[name] = EntryAudit(name, census, con, con.check(census))
    return out
