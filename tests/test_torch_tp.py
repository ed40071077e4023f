"""Tensor-parallel serving over kv heads (``repro_torch.distributed``,
``repro_torch.launch.mesh``): the engine on 1, 2 and 4 gloo ranks on the
CPU, each rank one process serving its share of the kv heads.

The model is r1-llama-8b's smoke form at 8 q / 4 kv heads (GQ 2, so a
rank's queries are the query groups of its kv heads), with the JAX
engine's weights.  The flash trace (``test_torch_engine``) and the
pressure trace (``test_torch_pressure``: an oversubscribed 14-block pool,
the prefix cache on) run on both backends, and the pressure trace also
under the rkv policy, whose selection reads the keys gathered from every
rank.  Bars:

* N ranks against one rank: bit-identical tokens, logits, engine counters
  and pool audit (the reference's contract for sharding, its
  ``serving/engine.py:162-165``), on every rank;
* one rank against the live JAX engine at the same heads: identical
  tokens, logits within 1e-3, equal counters and audit (the bars of
  ``test_torch_engine`` and ``test_torch_pressure``).

Also: a prefix detached on 2 ranks (its spill holds every head) equals the
one detached on 1 and resumes on 1, ``--mesh`` refusals with the
reference's messages, ``parse_mesh_spec`` against the reference's,
``local_heads`` against a numpy slice, K2's split count against the
model's heads, and the CLI's ``--expect-mesh-parity`` gate.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import ServeConfig, ThinKVConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.serving.engine import ThinKVEngine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS, KV_HEADS = 8, 4
RANKS = (2, 4)
BACKENDS = ("reference", "kernel")
# (trace, policy) cells each rank count serves on both backends
CELLS = (("flash", "thinkv"), ("pressure", "thinkv"), ("pressure", "rkv"))
COUNTERS = ("ticks", "tokens", "preemptions", "resumes", "prefix_hits",
            "prefix_tokens_skipped", "cow_faults", "prefill_chunks",
            "prefill_big_chunks", "admissions", "queue_wait_ticks",
            "prefill_tokens", "commits", "spill_bytes")


def port_model():
    return dataclasses.replace(get_smoke_config("r1-llama-8b"),
                               num_heads=HEADS, num_kv_heads=KV_HEADS)


def trace(name):
    """(prompts, priorities, max_new, slots, ThinKV settings, engine
    options) of the flash or the pressure trace."""
    import test_torch_engine as ET
    import test_torch_pressure as PT
    if name == "flash":
        return ET.prompts(), ET.PRIORITIES, ET.MAX_NEW, ET.SLOTS, ET.TK, {}
    return PT.prompts(), PT.PRIORITIES, PT.MAX_NEW, PT.SLOTS, ET.TK, dict(
        pool_blocks=PT.pool_blocks(), prefix_cache=True)


def port_engine(params, name, backend, policy="thinkv", mesh=None):
    _, _, _, slots, tk, kw = trace(name)
    mc = port_model()
    return ThinKVEngine(
        ServeConfig(model=mc, thinkv=ThinKVConfig(**tk), max_seqs=slots),
        params=params_from_numpy(params, mc, "cpu"), backend=backend,
        record_logits=True, device="cpu", policy=policy, mesh=mesh, **kw)


def serve(eng, name):
    prompts, priorities, max_new, *_ = trace(name)
    eng.submit(prompts, max_new_tokens=max_new, priorities=priorities)
    done = eng.run()
    return {"outputs": {r.arrival: r.output for r in done},
            "logits": {a: np.stack(v) for a, v in eng.request_logits.items()},
            "counters": {k: eng.metrics[k] for k in COUNTERS},
            "audit": eng.audit_pool()}


def serve_cells(mesh, params):
    """Every cell on this rank (a module-level function: ranks import it)."""
    SH.reset_collectives()
    out = {(name, policy, backend): serve(
        port_engine(params, name, backend, policy, mesh), name)
        for name, policy in CELLS for backend in BACKENDS}
    out["collectives"] = dict(SH.COLLECTIVES)
    return out


def detach(mesh, params, prompt):
    """A pressure-trace engine on this rank prefills ``prompt`` into slot 0
    and detaches it (its spill on the host, every head whole)."""
    eng = port_engine(params, "pressure", "kernel", mesh=mesh)
    return eng.detach_prefix(eng.prefill(prompt, 0))


@pytest.fixture(scope="module")
def jax_runs():
    """The live JAX reference engine on both traces at the same heads (one
    set of weights, from the engine's seed); returns (runs by trace, the
    weights as numpy)."""
    import jax

    import test_torch_pressure as PT
    jm = dataclasses.replace(PT.jax_model(), num_kv_heads=KV_HEADS)
    out, params = {}, None
    for name in ("flash", "pressure"):
        prompts, priorities, max_new, slots, tk, kw = trace(name)
        eng = PT.JaxEngine(PT.JSC(model=jm, thinkv=PT.JTK(**tk),
                                  max_seqs=slots), params=params,
                           backend="reference", record_logits=True, **kw)
        params = eng.params
        eng.submit(prompts, max_new_tokens=max_new, priorities=priorities)
        done = eng.run()
        out[name] = {
            "outputs": {r.arrival: r.output for r in done},
            "logits": {a: np.stack(v) for a, v in
                       eng.request_logits.items()},
            "counters": {k: eng.metrics[k] for k in PT.COUNTERS},
            "audit": eng.audit_pool()}
    return out, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_params(jax_runs):
    return jax_runs[1]


@pytest.fixture(scope="module")
def runs(jax_params):
    """{ranks: [each rank's cells]} at 1 rank (in this process) and 2 and
    4 (spawned, one torch thread each)."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {1: [serve_cells(M.make_serve_mesh("model=1", device="cpu"),
                               jax_params)]}
    finally:
        torch.set_num_threads(n_threads)
    for n in RANKS:
        out[n] = M.run_ranks(serve_cells, n, "cpu", jax_params,
                             timeout=600, threads=1)
    return out


def assert_same_run(got, want, what):
    assert got["outputs"] == want["outputs"], what
    assert sorted(got["logits"]) == sorted(want["logits"]), what
    for a in want["logits"]:
        np.testing.assert_array_equal(got["logits"][a], want["logits"][a],
                                      err_msg=f"{what}: arrival {a}")
    assert got["counters"] == want["counters"], what
    assert got["audit"] == want["audit"], what


CELL_IDS = [f"{t}-{p}-{b}" for t, p in CELLS for b in BACKENDS]
CELL_KEYS = [(t, p, b) for t, p in CELLS for b in BACKENDS]


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("cell", CELL_KEYS, ids=CELL_IDS)
def test_ranks_are_bit_identical_to_one_rank(runs, n, cell):
    """Every rank of an N-rank run gives the one-rank run's tokens, logits,
    counters and pool audit, bit for bit."""
    want = runs[1][0][cell]
    assert len(runs[n]) == n
    for r, got in enumerate(runs[n]):
        assert_same_run(got[cell], want, f"{cell} rank {r} of {n}")


@pytest.mark.parametrize("n", RANKS)
def test_ranks_communicate_through_the_whitelist_only(runs, n):
    """The ranks gathered (attention outputs, anneal keys, per-head
    sparsities, spills) and summed integer dirty masks; nothing else, and
    the one-rank run communicated nothing."""
    assert runs[1][0]["collectives"] == {}
    for got in runs[n]:
        kinds = {k for k, _ in got["collectives"]}
        assert kinds == {"all_gather", "all_reduce"}, got["collectives"]
        assert {d for k, d in got["collectives"] if k == "all_reduce"} == \
            {"int32"}
        assert got["collectives"] == runs[n][0]["collectives"]


@pytest.mark.parametrize("name,backend", [
    (t, b) for t in ("flash", "pressure") for b in BACKENDS])
def test_one_rank_matches_the_live_jax_engine(jax_runs, runs, name,
                                              backend):
    """One rank at 8 q / 4 kv heads against the live JAX engine: identical
    tokens, logits within 1e-3, equal counters and pool audit."""
    want, got = jax_runs[0][name], runs[1][0][(name, "thinkv", backend)]
    assert got["outputs"] == want["outputs"]
    for a in want["logits"]:
        np.testing.assert_allclose(got["logits"][a], want["logits"][a],
                                   rtol=0, atol=1e-3, err_msg=str(a))
    assert {k: got["counters"][k] for k in want["counters"]} == \
        want["counters"]
    assert got["audit"] == want["audit"]
    if name == "pressure":
        assert want["counters"]["preemptions"] > 0
        assert want["counters"]["prefix_hits"] > 0
        assert want["counters"]["cow_faults"] > 0


def test_rkv_at_two_ranks_selects_from_the_gathered_keys(runs):
    """rkv's farthest-point selection reads every head's keys: on two ranks
    it keeps exactly the one-rank run's slots (logits bit-identical,
    counters and audit equal), and it is another policy's run than
    thinkv's."""
    for backend in BACKENDS:
        one = runs[1][0][("pressure", "rkv", backend)]
        thinkv = runs[1][0][("pressure", "thinkv", backend)]
        assert one["counters"]["commits"] > 0
        assert any(not np.array_equal(one["logits"][a], thinkv["logits"][a])
                   for a in one["logits"])
        for got in runs[2]:
            assert_same_run(got[("pressure", "rkv", backend)], one,
                            f"rkv {backend}")


def spill_fields(st):
    def np_(t):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    out = {f: np_(getattr(st.cache, f)) for f in st.cache.FIELDS}
    out.update({f"view.{i}": np_(p) for i, p in enumerate(st.view)},
               mapped=st.mapped, next_token=st.next_token)
    return out


def resume_and_step(params, prefix, steps=6):
    """Insert ``prefix`` into slot 1 of a one-rank engine and run
    ``steps`` greedy trips; returns (tokens, logits) of slot 1."""
    eng = port_engine(params, "pressure", "kernel")
    assert eng.insert(prefix, 1)
    active = np.zeros(eng.cfg.max_seqs, bool)
    active[1] = True
    feed = torch.as_tensor(eng._feed)
    toks, lgs = [], []
    for _ in range(steps):
        feed, lg = eng._trip(active, feed)
        toks.append(int(feed[1]))
        lgs.append(lg[1].numpy().copy())
    eng.free_resource(1)
    eng.audit_pool()
    return toks, np.stack(lgs)


def test_spill_made_on_two_ranks_resumes_on_one(jax_params):
    """A prefix detached on 2 ranks holds every head on the host: it
    equals the prefix detached on one rank bit for bit, and resumed on
    one rank it decodes the same tokens and logits."""
    import test_torch_pressure as PT
    prompt = PT.prompts()[2]                     # 40 tokens: 5 commits
    one = detach(M.make_serve_mesh("model=1", device="cpu"), jax_params,
                 prompt)
    two = M.run_ranks(detach, 2, "cpu", jax_params, prompt, timeout=300,
                      threads=1)
    want = spill_fields(one.state)
    for r, pre in enumerate(two):
        assert pre.first_token == one.first_token
        np.testing.assert_array_equal(pre.logits, one.logits)
        got = spill_fields(pre.state)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"rank {r}: {k}")
    t1, l1 = resume_and_step(jax_params, one)
    t2, l2 = resume_and_step(jax_params, two[0])
    assert t1 == t2
    np.testing.assert_array_equal(l1, l2)


def test_kv_heads_that_do_not_divide_are_refused():
    """``kv_heads % N != 0`` is refused with the reference's message, by
    the engine and by the CLI, before any rank starts."""
    mc = port_model()
    mesh = M.ServeMesh(rank=0, size=3, group=None,
                       device=torch.device("cpu"), spec="model=3")
    with pytest.raises(ValueError, match=r"mesh\['model'\]=3 cannot shard "
                       r"4 kv heads \(head sharding needs kv_heads % mesh "
                       r"size == 0\)"):
        ThinKVEngine(ServeConfig(model=mc, max_seqs=1), device="cpu",
                     mesh=mesh)
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--mesh", "model=3", "--heads", "8",
                    "--kv-heads", "4"])
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--expect-mesh-parity"])


@pytest.mark.parametrize("spec", ["model=2", "model=1", "data=2,model=4",
                                  "pod=2,data=16,model=16", "model = 8"])
def test_parse_mesh_spec_matches_the_reference(spec):
    from repro.launch.mesh import parse_mesh_spec as jax_parse
    want, got = jax_parse(spec), M.parse_mesh_spec(spec)
    assert got.shape == tuple(want.shape)
    assert got.axis_names == tuple(want.axis_names)


@pytest.mark.parametrize("spec", ["model=0", "model", "=2", "model=x",
                                  "model=2,"])
def test_bad_mesh_specs_are_refused_as_the_reference_refuses_them(spec):
    from repro.launch.mesh import parse_mesh_spec as jax_parse
    with pytest.raises(ValueError) as want:
        jax_parse(spec)
    with pytest.raises(ValueError) as got:
        M.parse_mesh_spec(spec)
    assert str(got.value) == str(want.value)


def test_serve_mesh_needs_a_model_axis_and_its_ranks():
    with pytest.raises(ValueError, match="has no 'model' axis"):
        M.make_serve_mesh("data=2")
    with pytest.raises(ValueError, match="'model' axis only"):
        M.make_serve_mesh("data=2,model=2")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        M.make_serve_mesh("model=2", device="cpu")
    one = M.make_serve_mesh("data=1,model=1", device="cpu")
    assert (one.rank, one.size, one.group) == (0, 1, None)


def boom(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return mesh.rank


def test_a_failing_rank_fails_the_run():
    """No fallback: one rank raising ends every rank and raises here with
    its traceback."""
    with pytest.raises(RuntimeError,
                       match="(?s)rank 1 of 2 failed.*on purpose"):
        M.run_ranks(boom, 2, "cpu", timeout=120, threads=1)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_local_heads_is_a_numpy_slice(n, dim):
    x = np.random.default_rng(dim).standard_normal((2, 8, 8, 8, 3))
    for r in range(n):
        size = 8 // n
        want = np.take(x, range(r * size, (r + 1) * size), axis=dim)
        got = ops.local_heads(torch.from_numpy(x), dim, r, n)
        np.testing.assert_array_equal(got.numpy(), want)
    parts = [ops.local_heads(torch.from_numpy(x), dim, r, n)
             for r in range(n)]
    np.testing.assert_array_equal(torch.cat(parts, dim).numpy(), x)
    with pytest.raises(ValueError, match="does not divide"):
        ops.local_heads(torch.from_numpy(x), 4, 0, 2)


def test_k2_splits_each_head_as_the_model_does():
    """K2's split count follows the MODEL's kv heads (``split_heads``): at
    r1-llama-8b's big chunk (R 1, GQ 512, NB 128) a launch over 4 of its 8
    kv heads would split each walk 8 ways where the one-rank launch splits
    it 4, so the merge would add other partial sums.  The wrapper refuses
    a ``split_heads`` that is no multiple of the launch's heads."""
    assert ops.kv_splits(1, 8, 512, 128, 132, 128) == 4
    assert ops.kv_splits(1, 4, 512, 128, 132, 128) == 8
    g = torch.Generator().manual_seed(0)
    qh = torch.randn(1, 2, 4, 16, generator=g)
    codes = torch.zeros(4, 8, 2, 16, dtype=torch.uint8)
    scales = torch.zeros(4, 8, 2, 1, dtype=torch.bfloat16)
    meta = torch.zeros(1, 2, 8, dtype=torch.uint8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.paged_decode_attention_batched(qh, codes, codes, scales, scales,
                                           meta, meta, table, split_heads=3)
    a = ops.paged_decode_attention_batched(qh, codes, codes, scales, scales,
                                           meta, meta, table, split_heads=8)
    b = ops.paged_decode_attention_batched(qh, codes, codes, scales, scales,
                                           meta, meta, table)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_serve_cli_mesh_parity_gate():
    """``--mesh model=2 --heads 8 --kv-heads 4 --pool-frac 0.6
    --prefix-cache --expect-mesh-parity`` on the CPU exits 0: two ranks,
    then the unsharded replay, bit-identical."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--temperature", "0", "--mesh", "model=2", "--heads", "8", "--kv-heads", "4",
         "--pool-frac", "0.6", "--prefix-cache", "--expect-mesh-parity",
         "--shared-prefix-frac", "0.5", "--prompt-len", "48"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "mesh: model=2 over 2 ranks" in p.stdout
    assert "mesh-parity gate OK" in p.stdout
    assert "preemptions" in p.stdout and "prefix cache:" in p.stdout
