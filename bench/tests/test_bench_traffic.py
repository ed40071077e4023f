"""The traffic kinds repeat for a seed, stay in their ranges, and give
every seed the same sizes (and, open-loop, the same gaps) in another
order."""
import json

import numpy as np
import pytest

import tinycell  # noqa: F401  (puts bench/ on the path)
from benchlib import spec, traffic

closed_loop = traffic.kind("closed_loop")
open_loop = traffic.kind("open_loop")
OPEN = {"kind": "open_loop", "requests": 200, "rate": 2.5,
        "prompt_len": [32, 290], "output_len": [64, 612]}


def _mix(name):
    return json.loads((spec.BENCH / "traffic" / f"{name}.json").read_text())


def _sizes(clients):
    return [(len(r.prompt), r.max_new) for c in clients for r in c]


@pytest.mark.parametrize("name", ["reason", "short"])
def test_repeats_for_a_seed(name):
    a = closed_loop.make(_mix(name), 2 ** 31 + 17, 32000)
    b = closed_loop.make(_mix(name), 2 ** 31 + 17, 32000)
    assert _sizes(a) == _sizes(b)
    assert all((x.prompt == y.prompt).all() for ca, cb in zip(a, b)
               for x, y in zip(ca, cb))
    c = closed_loop.make(_mix(name), 2 ** 31 + 18, 32000)
    assert any((x.prompt[:8] != y.prompt[:8]).any() for ca, cc in zip(a, c)
               for x, y in zip(ca, cc))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5])
def test_same_sizes_every_seed(seed):
    for name in ("reason", "short"):
        mix = _mix(name)
        got = closed_loop.make(mix, seed, 1000)
        ref = closed_loop.make(mix, 12345, 1000)
        for r in range(mix["rounds"]):
            assert sorted(len(c[r].prompt) for c in got) == \
                sorted(len(c[r].prompt) for c in ref)
            assert sorted(c[r].max_new for c in got) == \
                sorted(c[r].max_new for c in ref)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 99])
def test_ranges(seed):
    mix = _mix("short")
    short = closed_loop.make(mix, seed, 32000)
    (plo, phi), (olo, ohi) = mix["prompt_len"], mix["output_len"]
    assert phi + ohi < 1024
    assert all(len(r.prompt) + r.max_new < 1024 for c in short for r in c)
    assert all(plo <= len(r.prompt) <= phi and 1 <= r.max_new <= ohi
               for c in short for r in c)
    later = [r for c in short for r in c[1:]]
    assert np.mean([len(r.prompt) for r in later]) == \
        pytest.approx(161, abs=1)                      # ShareGPT's means
    assert np.mean([r.max_new for r in later]) == pytest.approx(338, abs=1)
    reason = closed_loop.make(_mix("reason"), seed, 152064)
    assert all(1024 < len(r.prompt) <= 1536 and r.max_new == 8192
               for c in reason for r in c)
    ids = np.concatenate([r.prompt for c in reason for r in c])
    assert ids.min() >= 0 and ids.max() < 152064


def test_spread_is_even():
    s = traffic.spread(64, 448, 32)
    assert s[0] >= 64 and s[-1] <= 448 and (np.diff(s) > 0).all()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_open_loop_same_gaps_and_sizes_every_seed(seed):
    got, ref = open_loop.make(OPEN, seed, 1000), open_loop.make(OPEN, 9, 1000)
    again = open_loop.make(OPEN, seed, 1000)
    assert [a for a, _ in got] == [a for a, _ in again]
    assert all((x.prompt == y.prompt).all()
               for (_, x), (_, y) in zip(got, again))

    def gaps(plan):
        return sorted(np.round(np.diff([a for a, _ in plan]), 9))
    assert got[0][0] == 0.0
    assert sorted(len(r.prompt) for _, r in got) == \
        sorted(len(r.prompt) for _, r in ref)
    assert sorted(r.max_new for _, r in got) == \
        sorted(r.max_new for _, r in ref)
    # every gap but the one dealt last of each order is sent
    assert len(set(gaps(got)) ^ set(gaps(ref))) <= 2


def test_open_loop_rate():
    plan = open_loop.make(OPEN, 4, 1000)
    at = [a for a, _ in plan]
    assert all(b > a for a, b in zip(at, at[1:]))
    # the mean gap of the evenly spread exponential is close to 1 / rate
    assert at[-1] / (len(at) - 1) == pytest.approx(1 / OPEN["rate"],
                                                    rel=0.05)
