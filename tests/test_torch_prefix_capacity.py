"""The engine's prefix-cache capacity (``ThinKVEngine(prefix_cache_capacity=)``,
passed to ``PrefixCache`` as the reference passes it): with a capacity of 2
entries and four distinct shared prefixes the cache evicts, and the port's
engine is held to the live JAX engine's run with the same capacity, JAX
parameters carried across, greedy: the same entries evicted in the same
order, the same prefix hits and misses, tokens, engine counters and pool
audit, on both of the port's backends (the plain versions on the CPU)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import ServeConfig as JSC  # noqa: E402
from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.serving.engine import ThinKVEngine as JaxEngine  # noqa: E402
from repro_torch.config import ServeConfig, ThinKVConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ThinKVEngine  # noqa: E402
from test_torch_engine import TK  # noqa: E402

CAPACITY, SLOTS, MAX_NEW, SHARED_LEN, TAIL, SEED, VOCAB = 2, 2, 8, 16, 8, \
    3, 256
# prefix index of each request: four distinct prefixes, each met again
# after others have pushed it out of a 2-entry cache, and once at once
ORDER = (0, 1, 0, 2, 3, 1, 2, 3, 3)
COUNTERS = ("ticks", "tokens", "prefix_hits", "prefix_tokens_skipped",
            "cow_faults", "prefill_chunks", "prefill_big_chunks",
            "admissions", "queue_wait_ticks", "prefill_tokens",
            "preemptions", "resumes")


def prompts():
    rng = np.random.default_rng(SEED)
    heads = [rng.integers(0, VOCAB, SHARED_LEN) for _ in range(4)]
    return [np.concatenate([heads[i], rng.integers(0, VOCAB, TAIL)])
            .astype(np.int64) for i in ORDER]


def log_evictions(pc):
    """Wrap ``pc.evict_entry`` to record (prefix length, key) of each entry
    it drops, in order (LRU evictions go through it too)."""
    log = []
    inner = pc.evict_entry

    def wrapped(pool, entry):
        log.append((entry.length, entry.key))
        return inner(pool, entry)
    pc.evict_entry = wrapped
    return log


def model(smoke):
    return dataclasses.replace(smoke("r1-llama-8b"), vocab_size=VOCAB)


@pytest.fixture(scope="module")
def jax_run():
    eng = JaxEngine(JSC(model=model(jax_smoke), thinkv=JTK(**TK),
                        max_seqs=SLOTS), backend="reference",
                    prefix_cache=True, prefix_cache_capacity=CAPACITY)
    evicted = log_evictions(eng.prefix_cache)
    eng.submit(prompts(), max_new_tokens=MAX_NEW)
    done = eng.run()
    return {"params": jax.tree.map(np.asarray, eng.params),
            "tokens": {r.uid: list(map(int, r.output)) for r in done},
            "metrics": {k: eng.metrics[k] for k in COUNTERS},
            "stats": eng.prefix_cache.stats(), "evicted": evicted,
            "entries": sorted(eng.prefix_cache.entries),
            "audit": eng.audit_pool()}


def test_the_capacity_reaches_the_prefix_cache():
    cfg = ServeConfig(model=model(get_smoke_config), thinkv=ThinKVConfig(**TK),
                      max_seqs=1)
    eng = ThinKVEngine(cfg, device="cpu", prefix_cache=True,
                       prefix_cache_capacity=CAPACITY)
    assert eng.prefix_cache.capacity == CAPACITY
    assert ThinKVEngine(cfg, device="cpu", prefix_cache=True) \
        .prefix_cache.capacity == 64


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_a_two_entry_prefix_cache_evicts_as_the_jax_engine(jax_run, backend):
    want = jax_run
    mc = model(get_smoke_config)
    eng = ThinKVEngine(
        ServeConfig(model=mc, thinkv=ThinKVConfig(**TK), max_seqs=SLOTS),
        params=params_from_numpy(want["params"], mc, "cpu"),
        backend=backend, device="cpu", prefix_cache=True,
        prefix_cache_capacity=CAPACITY)
    evicted = log_evictions(eng.prefix_cache)
    eng.submit(prompts(), max_new_tokens=MAX_NEW)
    done = eng.run()
    assert {r.uid: list(map(int, r.output)) for r in done} == want["tokens"]
    assert {k: eng.metrics[k] for k in COUNTERS} == want["metrics"]
    assert eng.prefix_cache.stats() == want["stats"]
    assert evicted == want["evicted"]
    assert sorted(eng.prefix_cache.entries) == want["entries"]
    assert eng.audit_pool() == want["audit"]
    # the cache did evict, and still served hits
    assert want["stats"]["evictions"] > 0 and want["stats"]["hits"] > 0
    assert len(eng.prefix_cache.entries) <= CAPACITY
