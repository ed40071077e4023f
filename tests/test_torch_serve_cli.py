"""The port's serving CLI (``python -m repro_torch.launch.serve``) at smoke
size on the CPU: on an oversubscribed pool with the prefix cache it
preempts and resumes, hits the cache, prints the reference's counter lines
and passes its pool audit; sampling in packs; and the reference's streamed
runs, policies, drift probe and gates.  Greedy runs are served with the
JAX package's weights and finish with the tokens the JAX engine gives
for the same flags (built as ``repro/launch/serve.py`` builds it, streamed
through its ``_run_streamed`` where the run streams)."""
import re
import types

import numpy as np

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    several pytest workers on one host the threads' wake-ups dominate:
    run this module's torch ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_cli_oversubscribed_with_the_prefix_cache(capsys):
    serve.main(["--device", "cpu", "--temperature", "0", "--pool-frac",
                "0.6", "--prefix-cache", "--shared-prefix-frac", "0.5",
                "--prompt-len", "48", "--max-new", "64"])
    out = capsys.readouterr().out
    # every request's 64 tokens: the first from its prefill, 63 decoded
    assert re.search(r"served 8 requests .* 504 tokens", out), out
    pool = re.search(r"pool (\d+)/(\d+) blocks .* \| (\d+) preemptions, "
                     r"(\d+) resumes", out)
    assert pool, out
    blocks, worst, pre, res = map(int, pool.groups())
    assert blocks == int(worst * 0.6) < worst
    assert pre > 0 and res == pre
    hits = re.search(r"prefix cache: (\d+) hits \| (\d+) prefill tokens "
                     r"skipped \| (\d+) COW faults", out)
    assert hits and int(hits.group(1)) > 0 and int(hits.group(2)) > 0, out
    assert "pool refcount audit OK" in out


def test_serve_cli_takes_the_reference_pool_flags():
    args = serve.build_parser().parse_args(
        ["--pool-blocks", "12", "--prefix-cache", "--shared-prefix-frac",
         "0.25"])
    assert (args.pool_blocks, args.pool_frac, args.prefix_cache,
            args.shared_prefix_frac) == (12, None, True, 0.25)


def test_serve_cli_samples_in_packs(capsys):
    """Sampling at temperature 0.7 / top-p 0.9 in packs of up to 4 ticks:
    every request's tokens, the mega-dispatch line (fewer dispatches than
    ticks) and a clean audit."""
    serve.main(["--device", "cpu", "--temperature", "0.7", "--top-p", "0.9",
                "--ticks-per-dispatch", "4", "--requests", "4",
                "--max-new", "24"])
    out = capsys.readouterr().out
    # 24 tokens each: the first from its prefill, 23 decoded
    assert re.search(r"served 4 requests .* 92 tokens", out), out
    mega = re.search(r"mega-dispatch: (\d+) dispatches for (\d+) ticks", out)
    assert mega and int(mega.group(1)) < int(mega.group(2)), out
    assert "pool refcount audit OK" in out


def test_serve_cli_multi_tick_gate(capsys):
    """``--expect-multi-tick`` on an oversubscribed pool: packs of more than
    one tick, early exits, the per-tick replay's tokens, both audits."""
    serve.main(["--device", "cpu", "--temperature", "0",
                "--ticks-per-dispatch", "4",
                "--expect-multi-tick", "--pool-frac", "0.6",
                "--prompt-len", "24", "--max-new", "40"])
    out = capsys.readouterr().out
    assert "multi-tick gate OK" in out, out


@pytest.mark.parametrize("argv", [
    ["--expect-multi-tick", "--temperature", "0"],
    ["--expect-multi-tick", "--ticks-per-dispatch", "4",
     "--temperature", "0.7"],
    ["--temperature", "-1"], ["--top-p", "0"],
    ["--ticks-per-dispatch", "0"]])
def test_serve_cli_refuses_what_the_reference_refuses(argv):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"] + argv)


def jax_outputs(argv, policy="thinkv"):
    """The JAX engine's outputs by uid for the port CLI's ``argv`` (the same
    config, prompts, pool and streaming), and its parameters as numpy."""
    import jax
    from repro.config import ServeConfig as JSC
    from repro.config import ThinKVConfig as JTK
    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch import serve as JS
    from repro.serving.engine import ThinKVEngine as JaxEngine
    args = serve.build_parser().parse_args(argv)
    mcfg = jax_smoke(args.arch)
    tk = JTK(refresh_interval=args.tau, group_size=args.group,
             block_size=args.group, token_budget=args.budget,
             retention_schedule=(32, 16, 8, 4), min_retention=4,
             max_segments=256, kmeans_iters=4)
    worst = args.slots * (2 * args.budget // args.group)
    pool = max(int(worst * args.pool_frac), 1) if args.pool_frac else None
    eng = JaxEngine(JSC(model=mcfg, thinkv=tk, max_seqs=args.slots,
                        temperature=args.temperature, top_p=args.top_p),
                    backend="reference",
                    pool_blocks=pool, prefix_cache=args.prefix_cache,
                    ticks_per_dispatch=args.ticks_per_dispatch,
                    allow_forks=args.samples_per_slot > 1, policy=policy,
                    drift_probe=args.drift_probe)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mcfg.vocab_size, args.prompt_len)
               .astype(np.int64) for _ in range(args.requests)]
    if args.stream:
        done = JS._run_streamed(eng, types.SimpleNamespace(
            samples_per_slot=args.samples_per_slot,
            arrival_rate=args.arrival_rate, max_new=args.max_new), prompts,
            None)[0]
    else:
        eng.submit(prompts, max_new_tokens=args.max_new)
        done = eng.run()
    return {r.uid: list(r.output) for r in done}, \
        jax.tree.map(np.asarray, eng.params), done


def serve_like_jax(argv, capsys, policy="thinkv"):
    """The port CLI on ``argv`` with the JAX weights; its output text, its
    finished requests and the JAX run's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    want, params, jdone = jax_outputs(argv, policy)
    arch = serve.build_parser().parse_args(argv).arch
    done = serve.main(["--device", "cpu"] + argv, params=params_from_numpy(
        params, get_smoke_config(arch), "cpu"))
    assert {r.uid: list(r.output) for r in done} == want
    return capsys.readouterr().out, done, jdone


def test_serve_cli_default_flags_sample_as_the_jax_cli(capsys):
    """At its default flags the CLI samples at temperature 0.8, the
    reference's default, on the reference's per-request key streams: every
    request's tokens are the JAX CLI's engine's for the same flags."""
    args = serve.build_parser().parse_args([])
    assert (args.temperature, args.top_p) == (0.8, 1.0)
    out, done, _ = serve_like_jax([], capsys)
    # 64 tokens each: the first from its prefill, 63 decoded
    assert re.search(r"served 8 requests \[policy=thinkv\] .* 504 tokens",
                     out), out
    assert all(len(r.output) == 64 for r in done)


def test_serve_cli_rkv_with_the_drift_probe_streamed(capsys):
    """``--policy rkv --drift-probe --expect-drift --stream``: the JAX
    engine's tokens, the drift line and gate, each request's drift steps
    and top-1 agreement equal to JAX's."""
    argv = ["--temperature", "0", "--policy", "rkv", "--drift-probe",
            "--expect-drift", "--stream", "--requests", "4", "--max-new",
            "40"]
    out, done, jdone = serve_like_jax(argv, capsys, "rkv")
    # 40 tokens each: the first from its prefill, 39 decoded
    assert re.search(r"served 4 requests \[policy=rkv\] .* 156 tokens",
                     out), out
    assert re.search(r"drift probe: 4 requests vs uncompressed replay \| "
                     r"max \|dlogit\| [\d.]+ \| mean \|dlogit\| [\d.]+ \| "
                     r"top-1 agreement [\d.]+%", out), out
    assert re.search(r"streamed \(all-at-once open-loop\): 160 tokens "
                     r"delivered over 4 streams \| TTFT", out), out
    assert "drift gate OK: 4/4 requests probed" in out
    want = {r.uid: r.stats["drift"] for r in jdone}
    for r in done:
        d, w = r.stats["drift"], want[r.uid]
        assert (d["steps"], d["top1_agree"]) == (w["steps"], w["top1_agree"])
        assert abs(d["max_abs"] - w["max_abs"]) <= 2e-3


def test_serve_cli_uniform_oversubscribed_gates(capsys):
    """``--policy uniform --pool-frac 0.6 --expect-all --expect-preemptions``
    (48-token prompts: at the default 16 neither package preempts): the JAX
    engine's tokens, 4.00 bits, both gates."""
    argv = ["--temperature", "0", "--policy", "uniform", "--pool-frac",
            "0.6", "--expect-all", "--expect-preemptions", "--prompt-len",
            "48"]
    out, _, _ = serve_like_jax(argv, capsys, "uniform")
    assert re.search(r"\[policy=uniform\] .* avg 4\.00 bits", out), out
    assert "oversubscription gate OK: 8/8 requests" in out
    assert re.search(r"preemption gate OK: [1-9]\d* preemption", out), out


def test_serve_cli_open_loop_stream_parity(capsys):
    """``--stream --arrival-rate 0.5 --expect-stream-parity``: staggered
    Poisson arrivals give the JAX engine's tokens and the synchronous
    run's logits bit for bit."""
    argv = ["--temperature", "0", "--stream", "--arrival-rate", "0.5",
            "--expect-stream-parity", "--max-new", "32"]
    out, _, _ = serve_like_jax(argv, capsys)
    assert "streamed (0.5 req/tick open-loop): 256 tokens delivered over 8 " \
        "streams" in out, out
    assert "overlap: prefill-inside-decode=True" in out
    assert "stream-parity gate OK: 8 requests, 256 logit steps" in out


def test_serve_cli_forked_multi_tick_gate(capsys):
    """``--samples-per-slot 2 --stream --expect-multi-tick
    --ticks-per-dispatch 4`` (2 requests of 48 tokens, 96 new: past the
    budget, so forks pay COW faults): the JAX engine's tokens for every
    parent and fork, and the gate's fork checks."""
    argv = ["--temperature", "0", "--samples-per-slot", "2", "--stream",
            "--expect-multi-tick", "--ticks-per-dispatch", "4", "--requests",
            "2", "--prompt-len", "48", "--max-new", "96"]
    out, done, _ = serve_like_jax(argv, capsys)
    assert len(done) == 4
    assert re.search(r"mega-dispatch: .* \| 2 fork\(s\), [1-9]\d* fork COW "
                     r"faults, peak refcount 2", out), out
    assert re.search(r"multi-tick gate OK: .* 2 fork\(s\) sharing prefix "
                     r"blocks", out), out


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-7b",
                                  "paligemma-3b"])
def test_serve_cli_serves_the_moe_and_qkv_bias_archs(arch, capsys):
    """``--arch mixtral-8x7b``, ``--arch qwen2-7b`` and (the VLM, text
    prompts) ``--arch paligemma-3b`` at smoke size on an
    oversubscribed pool, kernel backend (plain versions on the CPU): the
    JAX engine's tokens for the same flags and weights, every request's
    tokens, a clean audit."""
    argv = ["--temperature", "0", "--arch", arch, "--backend", "kernel",
            "--pool-frac", "0.6", "--prompt-len", "40", "--max-new", "24",
            "--requests", "6", "--expect-all"]
    out, done, _ = serve_like_jax(argv, capsys)
    # every request's 24 tokens: the first from its prefill, 23 decoded
    assert re.search(r"served 6 requests .* 138 tokens .*cpu, kernel", out), \
        out
    assert "pool refcount audit OK" in out
    assert all(len(r.output) == 24 for r in done)


@pytest.mark.parametrize("argv,what", [
    (["--drift-probe"], "requires --stream"),
    (["--expect-mesh-parity"], "requires --mesh"),
    (["--mesh", "data=2"], "has no 'model' axis"),
    (["--expect-drift", "--stream"], "requires --drift-probe"),
    (["--arrival-rate", "0.5"], "require --stream"),
    (["--samples-per-slot", "2"], "requires --stream")])
def test_serve_cli_refuses_the_reference_refusals(argv, what, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"] + argv)
    assert what in capsys.readouterr().err
