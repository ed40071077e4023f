"""The port's serving CLI (``python -m repro_torch.launch.serve``) on an
oversubscribed pool with the prefix cache, at smoke size on the CPU: it
preempts and resumes, hits the cache, prints the reference's counter lines
and passes its pool audit."""
import re

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
    serve.main(["--device", "cpu", "--pool-frac", "0.6", "--prefix-cache",
                "--shared-prefix-frac", "0.5", "--prompt-len", "48",
                "--max-new", "64"])
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
    serve.main(["--device", "cpu", "--ticks-per-dispatch", "4",
                "--expect-multi-tick", "--pool-frac", "0.6",
                "--prompt-len", "24", "--max-new", "40"])
    out = capsys.readouterr().out
    assert "multi-tick gate OK" in out, out


@pytest.mark.parametrize("argv", [
    ["--expect-multi-tick"],
    ["--expect-multi-tick", "--ticks-per-dispatch", "4",
     "--temperature", "0.7"],
    ["--temperature", "-1"], ["--top-p", "0"],
    ["--ticks-per-dispatch", "0"]])
def test_serve_cli_refuses_what_the_reference_refuses(argv):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"] + argv)
