"""The port's serving CLI (``python -m repro_torch.launch.serve``) on an
oversubscribed pool with the prefix cache, at smoke size on the CPU: it
preempts and resumes, hits the cache, prints the reference's counter lines
and passes its pool audit."""
import re

import pytest

pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402


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
