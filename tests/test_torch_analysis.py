"""The port's entry-point checks (``repro_torch.analysis``), the
counterparts of ``tests/test_analysis.py``: the census against the
runtime counters, contracts with teeth (an extra launch, a float
all-reduce between two gloo ranks, an fp64 tensor, a tampered contract,
an entry point without a contract), ``audit_engine`` on both backends at
1 and 2 ranks, the RetraceGuard's bookkeeping over a streamed pressure
trace and a faked steady-state build failing loudly (on the CPU no kernel
library is built, so the guard cannot fire on its own), the audit CLI, and
the three lint rules over ``src/repro_torch`` with a fixture each.

On the CPU the census counts each kernel's plain-version dispatches
(``ops.DISPATCHES``); on the card the same counts are launches."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (CollectiveRule, CompiledContract,  # noqa
                                  ContractViolation, RetraceGuard,
                                  RetraceViolation, audit_engine,
                                  census_of, no_implicit_transfers,
                                  serve_collective_rule)
from repro_torch.analysis import lint  # noqa: E402
from repro_torch.config import ServeConfig, ThinKVConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.serving.engine import ThinKVEngine  # noqa: E402

K1, K2, K3, K4 = ("ct_paged_attention_fused", "ct_paged_attention_batched",
                  "flash_prefill", "group_quant")
TK = dict(refresh_interval=16, group_size=8, block_size=8, token_budget=48,
          retention_schedule=(16, 8, 4), min_retention=4, max_segments=64,
          kmeans_iters=4)
ENTRIES = {"_tick_fn", "_megatick_fn", "_prefill_chunk_fn",
           "_prefill_big_fn", "_commit_fn", "_drift_probe_fn"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_engine(backend, mesh=None, params=None, **kw):
    mc = dataclasses.replace(get_smoke_config("r1-llama-8b"), num_heads=8,
                             num_kv_heads=4)
    kw.setdefault("ticks_per_dispatch", 4)
    kw.setdefault("drift_probe", True)
    return ThinKVEngine(ServeConfig(model=mc, thinkv=ThinKVConfig(**TK),
                                    max_seqs=3, temperature=0.0),
                        params=params, backend=backend, device="cpu",
                        mesh=mesh, **kw)


def fused_args(seed=0, L=2, R=2, H=2, GQ=2, D=16, BS=8, NB=3, G=8):
    g = torch.Generator().manual_seed(seed)
    NP = R * NB
    codes = torch.randint(0, 16, (L, NP, BS, H, D), generator=g,
                          dtype=torch.uint8)
    scales = torch.full((L, NP, BS, H, D // 16), 0.01, dtype=torch.bfloat16)
    meta = torch.ones((L, R, NB, BS), dtype=torch.uint8)
    table = torch.arange(R * L * NB, dtype=torch.int32).reshape(R, L, NB) \
        % NP
    buf = torch.randn((L, R, G, H, D), generator=g).to(torch.bfloat16)
    return (torch.randn((L, R, H, GQ, D), generator=g), codes, codes,
            scales, scales, meta, meta * 4, table, buf, buf,
            torch.full((R,), 3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3])
def test_census_launch_count_matches_runtime(n):
    """The census's count of a function's launches equals the runtime
    counter's delta (on the CPU the plain versions' dispatches; no device
    launch)."""
    args = fused_args(n)
    before = dict(ops.DISPATCHES)

    def fn():
        for _ in range(n):
            ops.paged_decode_attention_fused(*args)
    c = census_of(fn)
    assert c.launches == {K1: n}
    assert ops.DISPATCHES[K1] - before[K1] == n
    assert c.device_launches == {}
    assert CompiledContract("f", launches={K1: n}).check(c) == []


def test_extra_launch_fails_loudly():
    """An extra launch against a one-launch contract is a violation naming
    the kernel and both counts."""
    q = torch.randn(16, 4, 16)
    kv = torch.randn(16, 2, 16)

    def twice():
        ops.prefill_attention(q, kv, kv)
        ops.prefill_attention(q, kv, kv)
    v = CompiledContract("k3", launches={K3: 1}).check(census_of(twice))
    assert [x.rule for x in v] == ["launch-count"]
    assert "flash_prefill: 2 launch(es)" in str(v[0])
    assert "pins 1" in str(v[0])


def test_fp64_tensor_is_a_violation():
    c = census_of(lambda: torch.zeros(3).double() + 1)
    assert c.fp64
    v = CompiledContract("f").check(c)
    assert v and {x.rule for x in v} == {"fp64"}
    assert CompiledContract("f", forbid_fp64=False).check(c) == []


@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_sampled_tick_holds_its_named_fp64_allowance(backend):
    """A sampling engine's tick and pack make float64 values in one place,
    ``prng.uniform`` (the exact emulation of XLA's fused scale-and-shift),
    and their contracts allow that code by name: the audit is clean, the
    same census fails a contract without the allowance, and fp64 made
    anywhere else still fails the sampled contract."""
    from repro_torch.analysis.census import fp64_origin
    from repro_torch.analysis.contracts import SAMPLED_FP64, engine_contracts
    eng = ThinKVEngine(ServeConfig(
        model=dataclasses.replace(get_smoke_config("r1-llama-8b"),
                                  num_heads=8, num_kv_heads=4),
        thinkv=ThinKVConfig(**TK), max_seqs=3, temperature=0.8, top_p=0.9),
        backend=backend, device="cpu", ticks_per_dispatch=4)
    rep = audit_engine(eng)
    assert rep.ok, rep.violations
    for name in ("_tick_fn", "_megatick_fn"):
        fp64 = rep.entries[name].census.fp64
        assert fp64 and {fp64_origin(e) for e in fp64} == set(SAMPLED_FP64)
        strict = dataclasses.replace(rep.entries[name].contract,
                                     fp64_allowance=())
        v = strict.check(rep.entries[name].census)
        assert v and {x.rule for x in v} == {"fp64"}
        assert "in serving/prng.py:uniform" in str(v[0])
    for name in ("_prefill_chunk_fn", "_commit_fn", "_prefill_big_fn"):
        assert rep.entries[name].census.fp64 == []
    other = census_of(lambda: torch.zeros(3).double() + 1)
    assert engine_contracts(eng)["_tick_fn"].check(other)
    assert engine_contracts(make_engine(backend))["_tick_fn"] \
        .fp64_allowance == ()


def collective_census(mesh):
    """On each of 2 ranks: the serving helpers' gathers and integer OR, and
    a float all-reduce called directly; returns the census's collectives
    and the serve rule's violations."""
    import torch.distributed as dist

    def fn():
        x = torch.full((2, 2), float(mesh.rank))
        SH.gather_heads(x, mesh, 1)
        SH.any_shard(torch.tensor([mesh.rank == 0, False]), mesh)
        dist.all_reduce(x)
    SH.reset_collectives()
    c = census_of(fn)
    return ([u.to_dict() for u in c.collectives], c.collective_counts,
            [str(v) for v in serve_collective_rule().check("f",
                                                           c.collectives)])


def test_float_all_reduce_in_a_two_rank_function_is_a_violation():
    """Between two gloo ranks the census sees every collective, whoever
    calls it: the head gather (movement) and the int32 OR pass the serve
    whitelist, a float all-reduce is a collective violation."""
    for uses, counts, violations in M.run_ranks(collective_census, 2, "cpu",
                                                timeout=120, threads=1):
        assert [(u["name"], u["dtype"], u["reduces"]) for u in uses] == [
            ("all_gather", "float32", False), ("all_reduce", "int32", True),
            ("all_reduce", "float32", True)]
        assert counts == {"all_gather(float32)": 1, "all_reduce(int32)": 1}
        assert len(violations) == 1
        assert "reduction all_reduce(float32) crosses ranks" in violations[0]
    rule = CollectiveRule(float_reductions=(("all_reduce", "model"),))
    from repro_torch.analysis.census import CollectiveUse
    assert rule.check("f", [CollectiveUse("all_reduce", "float32",
                                          True)]) == []
    assert CollectiveRule().check("f", [CollectiveUse("broadcast", "int32",
                                                      False)])


# ---------------------------------------------------------------------------
# engine audits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    ref = make_engine("reference")
    ker = make_engine("kernel", params=ref.model)
    return ref, ker


def test_audit_engine_passes_both_backends(engines):
    """Every registered entry point has a contract and passes: kernel
    backend K1 x1 per tick and per trip (none outside the trips), K2 and K3
    x L per chunk, K4 x1 per commit; reference backend K4 per commit
    only; the drift probe nothing."""
    L = engines[0].mcfg.num_layers
    for eng, k in zip(engines, (0, 1)):
        rep = audit_engine(eng)
        assert rep.ok, rep.summary()
        assert set(rep.entries) == ENTRIES
        e = {n: a.census for n, a in rep.entries.items()}
        assert e["_tick_fn"].launches == ({K1: 1} if k else {})
        assert e["_megatick_fn"].trips == 4
        assert (e["_megatick_fn"].launches_per_trip or {}) == \
            ({K1: 1} if k else {})
        assert e["_megatick_fn"].launches_outside_trips == {}
        for name in ("_prefill_chunk_fn", "_prefill_big_fn"):
            c = e[name]
            assert c.commits > 0
            assert c.launches == {**({K2: L, K3: L} if k else {}),
                                  K4: c.commits}
        assert e["_commit_fn"].launches == {K4: 1} and \
            e["_commit_fn"].commits == 1
        assert e["_drift_probe_fn"].launches == {}
        for c in e.values():
            assert c.fp64 == [] and c.collectives == []
        assert rep.meta["backend"] == eng.backend
        assert rep.meta["ranks"] == 1
        assert set(rep.host_syncs()) == ENTRIES
        eng.audit_pool()
        assert all(s.free for s in eng.scheduler.slots)


def test_launch_counts_of_the_entry_points(engines):
    ref, ker = engines
    L = ker.mcfg.num_layers
    assert (ker.tick_launch_count(), ref.tick_launch_count()) == (1, 0)
    assert ker.megatick_launch_count() == (1, 0)
    assert ref.megatick_launch_count() == (0, 0)
    assert (ker.prefill_launch_count(), ref.prefill_launch_count()) == \
        (2 * L, 0)
    assert ker.audit_compiled().ok


def audit_two_ranks(mesh):
    reps = []
    for backend in ("reference", "kernel"):
        rep = audit_engine(make_engine(backend, mesh))
        reps.append(rep.to_dict())
    return reps


def test_audit_engine_passes_at_two_ranks():
    """At 2 ranks every entry point still holds its launch contract, and
    its collectives (head gathers, integer ORs) satisfy the whitelist."""
    per_rank = M.run_ranks(audit_two_ranks, 2, "cpu", timeout=300,
                           threads=1)
    for reps in per_rank:
        for rep in reps:
            assert rep["ok"], json.dumps(rep["entries"], indent=1)[:4000]
            assert rep["meta"]["ranks"] == 2
            tick = rep["entries"]["_tick_fn"]["census"]
            assert tick["collectives"] and {
                c["name"] for c in tick["collectives"]} <= {"all_gather",
                                                            "all_reduce"}
            drift = rep["entries"]["_drift_probe_fn"]["census"]
            assert drift["collectives"] == []
    assert [r["entries"]["_prefill_big_fn"]["census"]["collective_counts"]
            for r in per_rank[0]] == \
        [r["entries"]["_prefill_big_fn"]["census"]["collective_counts"]
         for r in per_rank[1]]


def test_unregistered_entry_point_is_an_error(engines):
    """audit_engine refuses an entry point with no declared contract."""
    ref, _ = engines
    orig = ref.compiled_entry_points

    def with_rogue():
        eps = orig()
        eps["_rogue_fn"] = eps["_tick_fn"]
        return eps

    ref.compiled_entry_points = with_rogue
    try:
        with pytest.raises(KeyError, match="_rogue_fn"):
            audit_engine(ref)
    finally:
        del ref.compiled_entry_points


def test_tampered_contract_fails_on_real_engine(engines):
    """Pinning the wrong launch count on the real kernel tick fails, naming
    the entry point and its census."""
    _, ker = engines
    bad = {"_tick_fn": CompiledContract("_tick_fn", launches={K1: 2},
                                        collectives=serve_collective_rule())}
    rep = audit_engine(ker, contracts=bad)
    assert not rep.ok
    assert [v.contract for v in rep.violations] == ["_tick_fn"]
    with pytest.raises(ContractViolation,
                       match="_tick_fn.*ct_paged_attention_fused"):
        rep.raise_on_violation()
    per_trip = {"_megatick_fn": CompiledContract(
        "_megatick_fn", launches_per_trip={K1: 2},
        launches_per_commit={K4: 1})}
    rep = audit_engine(ker, contracts=per_trip)
    assert {v.rule for v in rep.violations} == {"launch-per-trip"}


# ---------------------------------------------------------------------------
# the RetraceGuard
# ---------------------------------------------------------------------------

def _stream(eng, prompts, max_new, stagger=0):
    from repro_torch.launch.audit import _stream as stream
    return stream(eng, prompts, max_new, stagger)


def test_streamed_pressure_trace_makes_no_steady_state_builds():
    """The guard over a streamed pressure trace (prefix sharing, staggered
    arrivals, more requests than slots, an oversubscribed pool): calls
    counted on the entry points, no build after warmup, no retrace logged,
    the engine's methods restored after.  On the CPU no kernel library is
    ever built, so this holds the guard's bookkeeping only: the guard's
    firing is held by the faked build below, and on the card by
    ``test_torch_cuda.py::test_retrace_guard_in_a_fresh_process``."""
    rng = np.random.default_rng(0)
    eng = make_engine("kernel", prefix_cache=True, pool_blocks=20,
                      ticks_per_dispatch=1, drift_probe=False)
    builds = build.BUILDS
    guard = RetraceGuard(eng).install()
    try:
        done, _ = _stream(eng, [rng.integers(0, 256, 12) for _ in range(2)],
                          max_new=8)
        assert len(done) == 2
        guard.mark_steady()
        shared = rng.integers(0, 256, 16)
        prompts = [np.concatenate([shared, rng.integers(0, 256, 4)])
                   for _ in range(5)]
        done, orch = _stream(eng, prompts, max_new=16, stagger=2)
        assert len(done) == 7
        assert eng.metrics["prefix_hits"] > 0
        guard.assert_steady_state()
        assert guard.steady_retraces() == 0
        assert sum(guard.calls.values()) > 10
        assert not [e for e in orch.events if e["kind"] == "retrace"]
        assert build.BUILDS == builds
    finally:
        guard.uninstall()
    assert "_trip" not in eng.__dict__


def test_steady_state_build_fails_loudly(monkeypatch):
    """A kernel library built after warmup (faked: K3's wrapper bumps the
    build counter) is attributed to the entry point and call that caused
    it, fails ``assert_steady_state``, and lands in the orchestrator's log
    as a retrace event."""
    rng = np.random.default_rng(1)
    eng = make_engine("kernel", ticks_per_dispatch=1, drift_probe=False)
    guard = RetraceGuard(eng).install()
    try:
        _stream(eng, [rng.integers(0, 256, 10)], max_new=4)
        guard.mark_steady()
        stats = ops.prefill_attention_stats

        def building(*a, **k):
            build.BUILDS += 1
            return stats(*a, **k)
        monkeypatch.setattr(ops, "prefill_attention_stats", building)
        monkeypatch.setattr(build, "BUILDS", build.BUILDS)
        eng._prefill_chunk(0, rng.integers(0, 256, 5))
        monkeypatch.setattr(ops, "prefill_attention_stats", stats)
        eng._release_slot(0)
        assert guard.steady_retraces() == 1
        with pytest.raises(RetraceViolation,
                           match="_prefill_chunk built a kernel library at "
                                 "its call #"):
            guard.assert_steady_state()
        _, orch = _stream(eng, [rng.integers(0, 256, 6)], max_new=4)
        assert [e["entry"] for e in orch.events
                if e["kind"] == "retrace"] == ["_prefill_chunk"]
    finally:
        guard.uninstall()


def test_no_implicit_transfers_is_a_no_op_on_the_cpu():
    with no_implicit_transfers("cpu"):
        assert float(torch.ones(2).sum().item()) == 2.0


def test_audit_cli_is_clean(tmp_path, capsys):
    from repro_torch.launch import audit
    out = tmp_path / "analysis_report.json"
    assert audit.main(["--device", "cpu", "--fail-on-violation", "--out",
                       str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] and len(rep["cells"]) == 4
    assert set(rep["steps"]) == {"flash_prefill", "prefill_step",
                                 "decode_step_fullkv", "train_step"}
    assert rep["steps"]["train_step"]["ok"]
    assert "-> OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the train step's contract
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("r1-llama-8b", "mixtral-8x7b", "paligemma-3b",
               "falcon-mamba-7b", "zamba2-7b", "whisper-medium")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_contract_holds_for_every_family(arch):
    """One train step of every family's smoke form (remat on): no launch
    of K1-K5 (none has a backward; the reference's train path runs none of
    its Pallas kernels), no collective, no fp64."""
    from repro_torch.analysis import audit_train_step
    a = audit_train_step(arch)
    assert a.ok, a.violations
    assert a.census.launches == {} and a.census.device_launches == {}
    assert a.census.fp64 == [] and a.census.collectives == []


def test_train_step_contract_holds_with_microbatches():
    from repro_torch.analysis import audit_train_step
    a = audit_train_step("r1-llama-8b", microbatches=2)
    assert a.ok and a.census.launches == {}


def test_train_step_contract_fails_on_a_kernel_launch(monkeypatch):
    """A loss that reaches a kernel wrapper (here K3's, on the hidden
    states) breaks the train step's contract, naming the kernel."""
    from repro_torch.analysis import audit_train_step
    from repro_torch.models import lm
    real = lm.backbone

    def backbone(params, h, cfg, positions, **kw):
        q = h[0].reshape(h.shape[1], cfg.d_model // 16, 16).contiguous()
        ops.prefill_attention(q, q, q)
        return real(params, h, cfg, positions, **kw)
    monkeypatch.setattr(lm, "backbone", backbone)
    a = audit_train_step("r1-llama-8b")
    assert not a.ok
    assert any(v.rule == "launch-count" and K3 in v.message
               for v in a.violations), a.violations


# ---------------------------------------------------------------------------
# the lint rules
# ---------------------------------------------------------------------------

def test_lint_rules_repo_clean(capsys):
    assert lint.main() == 0, capsys.readouterr().out


def test_lint_blocking_sync_fixture(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import torch\n"
        "async def f(res, t):\n"
        "    res.block()\n"
        "    torch.cuda.synchronize()\n"
        "    t.cpu()\n"
        "    t.item()\n"
        "def g(res):\n"
        "    res.block()\n")                # a plain def: out of scope
    out = lint.lint_blocking_sync(bad)
    assert len(out) == 4
    assert "block" in out[0] and "synchronize" in out[1]
    assert ".cpu()" in out[2] and ".item()" in out[3]
    good = tmp_path / "good.py"
    good.write_text(
        "import torch\n"
        "async def f(loop, res):\n"
        "    await loop.run_in_executor(None, res.block)\n"
        "    await loop.run_in_executor(None, torch.cuda.synchronize)\n")
    assert lint.lint_blocking_sync(good) == []


def test_lint_refcount_mutation_fixture(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "def f(pool, i, rc):\n"
        "    pool.refcount[0, i] += 1\n"
        "    pool.refcount.index_put_((i,), rc, accumulate=True)\n"
        "    pool.refcount = rc\n"
        "    return pool._replace(refcount=rc)\n")
    out = lint.lint_refcount_mutation([bad])
    assert len(out) == 4
    ok = tmp_path / "ok.py"
    ok.write_text("def f(pool):\n"
                  "    rc = pool.refcount.cpu().numpy().copy()\n"
                  "    rc[0] += 1\n"
                  "    return pool.refcount.sum()\n")
    assert lint.lint_refcount_mutation([ok]) == []


def test_lint_float64_fixture(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import numpy as np\n"
        "import torch\n"
        "a = torch.zeros(2, dtype=torch.float64)\n"
        "b = np.float64(2.0)\n"
        "c = 'float64'\n"
        "d = torch.ones(2).double()\n"
        "e = torch.double\n")
    assert len(lint.lint_float64([bad])) == 5
    # the allowlist is by path under the package root
    assert lint.lint_float64([bad], allow={"bad.py"}, root=tmp_path) == []
    assert len(lint.lint_float64([bad], allow={"bad.py"})) == 5
