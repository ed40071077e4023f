"""The port's host spans (``repro_torch/spans.py``) and the census's count of
the waits they mark.

On the CPU, under ``torch.profiler`` CPU activity, a smoke engine serves
(through the orchestrator) a prompt that prefills in a big chunk and
g-chunks and decode ticks whose commits evict past a small budget and
whose refreshes classify, on a dense and on a MoE smoke config: every
span appears, each nests as ``spans.py`` documents, and every
``aten::nonzero`` and ``aten::_local_scalar_dense`` on the serving thread
lies inside a ``thinkv.readback`` span.  Two exceptions, both of code the
card runs otherwise: the kernels' plain versions (``kernels/ref.py``; the
card runs the CUDA kernels), and the range checks of ``one_hot`` (on the
CPU it reads its input's extremes back; on the card it does not).

The census (``analysis/census.py``) counts boolean-mask shapes on a decode
tick with a commit and a refresh due, exactly as the code makes them.

On the card (skipped without one, as ``tests/test_torch_cuda.py`` is):
every ``cudaStreamSynchronize`` of a profiled serving run, its ticks and
its prefills, lies inside a ``thinkv.readback`` span.
"""
import bisect
import collections
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.census import census_of  # noqa: E402
from repro_torch.config import ServeConfig, ThinKVConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ref as KR  # noqa: E402
from repro_torch.serving.engine import ThinKVEngine  # noqa: E402

TK = dict(refresh_interval=16, group_size=8, block_size=8, token_budget=48,
          retention_schedule=(16, 8, 4), min_retention=4, max_segments=64,
          kmeans_iters=2)
TICK_PARTS = ("trunk", "attend", "project", "advance", "logits")
MAINTAIN_PARTS = ("commit", "evict", "refresh", "tables")
PLAIN = "test.plain_kernel"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def engine(arch, device="cpu", **kw):
    mc = dataclasses.replace(get_smoke_config(arch), num_heads=8,
                             num_kv_heads=4)
    return ThinKVEngine(ServeConfig(model=mc, thinkv=ThinKVConfig(**TK),
                                    max_seqs=3),
                        backend="kernel", device=device, **kw)


def prompts(n=(140, 30, 52), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, k) for k in n]


@pytest.fixture
def marked_plain_kernels(monkeypatch):
    """Every plain kernel version runs inside a ``test.plain_kernel``
    range."""
    def marked(fn):
        @functools.wraps(fn)
        def run(*a, **k):
            with torch.profiler.record_function(PLAIN):
                return fn(*a, **k)
        return run
    for name in dir(KR):
        fn = getattr(KR, name)
        if callable(fn) and not name.startswith("_") and \
                getattr(fn, "__module__", "") == KR.__name__:
            monkeypatch.setattr(KR, name, marked(fn))


def served_events(arch, device="cpu", max_new=40, activities=None):
    """Serve ``prompts()`` for ``max_new`` tokens under the profiler: the
    events as (name, start, end, thread) and the engine."""
    from torch.profiler import ProfilerActivity, profile
    eng = engine(arch, device, prefill_chunk=128)
    eng.submit(prompts(), max_new_tokens=max_new)
    with profile(activities=activities or [ProfilerActivity.CPU]) as prof:
        eng.run(max_ticks=1000)
    ev = [(e.name, e.time_range.start, e.time_range.end, e.thread)
          for e in prof.events()
          if not str(e.device_type).endswith("CUDA")]
    return ev, eng


def chains(ev, keep):
    """Each kept event's enclosing kept events (names, outermost first), as
    ``{event: names}``: on one thread the profiler's events nest or are
    disjoint, so one sweep in order of start finds them."""
    by_thread = collections.defaultdict(list)
    for x in ev:
        if keep(x[0]):
            by_thread[x[3]].append(x)
    out = {}
    for xs in by_thread.values():
        stack = []
        for x in sorted(xs, key=lambda x: (x[1], -x[2])):
            while stack and stack[-1][2] < x[2]:
                stack.pop()
            out[x] = [y[0] for y in stack]
            stack.append(x)
    return out


def span_chains(ev):
    """Every span's enclosing spans, by their names without the prefix."""
    return {x: [n[len("thinkv."):] for n in c] for x, c in
            chains(ev, lambda n: n.startswith("thinkv.")).items()}


def spans_of(ev, name):
    return [x for x in ev if x[0] == "thinkv." + name]


@pytest.fixture(scope="module")
def dense_run():
    return served_events("r1-llama-8b")


@pytest.fixture(scope="module")
def moe_run():
    return served_events("mixtral-8x7b", max_new=24)


def test_every_span_appears(dense_run, moe_run):
    ev, eng = dense_run
    assert eng.metrics["prefill_big_chunks"] >= 1
    assert eng.metrics["prefill_chunks"] >= 1 and eng.metrics["commits"] > 0
    for name in ("tick", "prefill", "maintain", "anneal", "readback",
                 "deliver") + TICK_PARTS + MAINTAIN_PARTS:
        assert spans_of(ev, name), name
    assert len(spans_of(ev, "tick")) == eng.metrics["ticks"]
    assert len(spans_of(ev, "commit")) == eng.metrics["commits"]
    for name in ("route", "experts"):
        assert spans_of(moe_run[0], name), name
        assert not spans_of(ev, name), name


@pytest.mark.parametrize("run", ["dense_run", "moe_run"])
def test_spans_nest_as_documented(run, request):
    ev, _ = request.getfixturevalue(run)
    outer = span_chains(ev)
    for part in TICK_PARTS:
        for x in spans_of(ev, part):
            assert outer[x] == ["tick"], (part, outer[x])
    for x in spans_of(ev, "maintain"):
        assert outer[x] in (["tick", "advance"], ["prefill"]), outer[x]
    for part in MAINTAIN_PARTS:
        for x in spans_of(ev, part):
            want = ["maintain", "refresh"] if part == "evict" and \
                "refresh" in outer[x] else ["maintain"]
            assert outer[x][-len(want):] == want, (part, outer[x])
    for x in spans_of(ev, "anneal"):
        assert outer[x][-1] in ("evict", "refresh"), outer[x]
        assert "maintain" in outer[x]
    for part in ("route", "experts"):
        for x in spans_of(ev, part):
            assert outer[x] in (["tick", "trunk"], ["prefill"]), outer[x]
    for x in spans_of(ev, "deliver"):
        assert outer[x] == []


@pytest.mark.parametrize("arch", ["r1-llama-8b", "mixtral-8x7b"])
def test_waits_lie_inside_readback_spans(arch, marked_plain_kernels):
    ev, _ = served_events(arch, max_new=24)
    serving = {t for n, _, _, t in ev if n == "thinkv.tick"}
    waits = ("aten::nonzero", "aten::_local_scalar_dense")
    # a wait inside a plain kernel version or a CPU range check is exempt
    exempt = {PLAIN, "aten::one_hot", "thinkv.readback"}
    outer = chains([x for x in ev if x[3] in serving],
                   lambda n: n in exempt or n in waits)
    seen = [(x, c) for x, c in outer.items() if x[0] in waits]
    assert seen
    assert [(x[0], c) for x, c in seen if not exempt & set(c)] == []


def test_census_counts_boolean_mask_shapes_of_a_tick():
    """A decode tick whose token commits (and refreshes) one slot: 19
    boolean-mask shapes for the commit, as the code makes them, with no
    prefix cache (no COW compare): ``commit_group`` 9 (two in the slot
    pick, one per plane, the positions, two in the block claim),
    ``sync_block_tables`` 10 (two for each of its two reference updates,
    two for the scatter's rows and one per plane)."""
    eng = engine("r1-llama-8b")
    p = prompts((15,))[0]
    eng._prefill_chunk(0, p[:8])
    eng._prefill_chunk(0, p[8:])
    eng._check_fails()
    active = np.zeros(3, bool)
    active[0] = True
    assert (eng._slot_ntok[0] + 1) % TK["group_size"] == 0
    assert (eng._slot_ntok[0] + 1) % TK["refresh_interval"] == 0
    c = census_of(eng._trip, active, torch.zeros(3, dtype=torch.int64),
                  engine=eng)
    assert c.commits == 1
    assert c.host_syncs["boolean_index"] == 19
    assert "nonzero" not in c.host_syncs
    assert "cuda_to_cpu_copy" not in c.host_syncs
    assert c.host_sync_count >= 19


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stream syncs happen only there")
    return torch.device("cuda")


@pytest.mark.parametrize("arch", ["r1-llama-8b", "mixtral-8x7b"])
def test_stream_syncs_lie_inside_readback_spans_on_the_card(card, arch):
    from torch.profiler import ProfilerActivity
    ev, eng = served_events(arch, "cuda", max_new=24, activities=[
        ProfilerActivity.CPU, ProfilerActivity.CUDA])
    assert eng.metrics["commits"] > 0 and eng.metrics["prefill_chunks"] > 0
    # the tick's copy waits on an executor thread, inside the serving
    # thread's span: readback spans are looked up by time, on any thread
    reads = sorted((a, b) for n, a, b, _ in ev if n == "thinkv.readback")
    starts = [a for a, _ in reads]
    syncs = [x for x in ev if x[0] == "cudaStreamSynchronize"]
    assert syncs, "the profiler recorded no stream sync"

    def inside(x):
        i = bisect.bisect_right(starts, x[1]) - 1
        return i >= 0 and reads[i][1] >= x[2]
    bare = [x for x in syncs if not inside(x)]
    assert bare == [], f"{len(bare)} of {len(syncs)} syncs outside"
