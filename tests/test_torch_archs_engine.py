"""The port's ThinKVEngine against the JAX package's on the flash and the
pressure trace (``tests/test_serving_traces.py``'s shapes, as
``test_torch_engine.py`` and ``test_torch_pressure.py`` run them on
r1-llama-8b), with each served smoke config of the dense, MoE and VLM slices in its
place: qwen2-7b (non-zero qkv biases), mixtral-8x7b (top 2 of 4 experts)
and llama4-scout-17b-a16e (top 1 of 4), each at its own 4 q / 2 kv heads,
and paligemma-3b (4 q / 1 kv head, tied embeddings scaled by
sqrt(d_model), GeGLU; text prompts, as both engines serve the VLM).

Per case the live JAX ``reference`` engine runs once and the port runs on
both of its backends on the CPU.  Bars: identical tokens, equal counters
and pool audit, per-request logits within 1e-3.  A MoE tick routes the
slots together and a prefill chunk its rows, padded g-chunk rows included,
as the reference does, so the capacity drops the same choices."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import jax  # noqa: E402

from repro.config import ServeConfig as JSC  # noqa: E402
from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.serving.engine import ThinKVEngine as JaxEngine  # noqa: E402
from repro_torch.config import ServeConfig, ThinKVConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.engine import ThinKVEngine  # noqa: E402
import test_torch_engine as FL  # noqa: E402
import test_torch_pressure as PT  # noqa: E402
from test_torch_archs import SERVED, TK, jax_params  # noqa: E402

ENGINE_ARCHS = SERVED + ("paligemma-3b",)

# trace -> (prompts, priorities, max_new, slots, pool blocks, prefix cache,
# counters held)
TRACES = {
    "flash": (FL.prompts, FL.PRIORITIES, FL.MAX_NEW, FL.SLOTS, None, False,
              FL.COUNTERS),
    "pressure": (PT.prompts, PT.PRIORITIES, PT.MAX_NEW, PT.SLOTS,
                 PT.pool_blocks(), True, PT.COUNTERS),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    several pytest workers on one host the threads' wake-ups dominate:
    run this module's torch ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_matches_the_jax_engine(arch, trace):
    prompts, prio, max_new, slots, pool, prefix, counters = TRACES[trace]
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = jax_params(jcfg, seed=1)
    je = JaxEngine(JSC(model=jcfg, thinkv=JTK(**TK), max_seqs=slots),
                   params=jax.tree.map(jnp.asarray, jp), backend="reference",
                   pool_blocks=pool, record_logits=True, prefix_cache=prefix)
    je.submit(prompts(), max_new_tokens=max_new, priorities=prio)
    want = {r.arrival: r.output for r in je.run()}
    assert len(want) == len(prompts())
    if trace == "pressure":
        assert je.metrics["preemptions"] > 0 and je.metrics["prefix_hits"]
    else:
        assert je.metrics["prefill_big_chunks"] == 1
    for backend in ("reference", "kernel"):
        eng = ThinKVEngine(
            ServeConfig(model=tcfg, thinkv=ThinKVConfig(**TK),
                        max_seqs=slots),
            params=params_from_numpy(jp, tcfg, "cpu"), backend=backend,
            pool_blocks=pool, record_logits=True, prefix_cache=prefix,
            device="cpu")
        launches = dict(ops.LAUNCHES)
        eng.submit(prompts(), max_new_tokens=max_new, priorities=prio)
        got = {r.arrival: r.output for r in eng.run()}
        assert ops.LAUNCHES == launches         # plain versions on the CPU
        assert got == want, backend
        assert {k: int(eng.metrics[k]) for k in counters} == \
            {k: int(je.metrics[k]) for k in counters}, backend
        assert eng.audit_pool() == je.audit_pool(), backend
        for a, lg in je.request_logits.items():
            np.testing.assert_allclose(np.stack(eng.request_logits[a]),
                                       np.stack(lg), rtol=0, atol=1e-3,
                                       err_msg=f"{backend} request {a}")
