"""The port's mixture-of-experts FFN (``repro_torch/layers/moe.py``) against
the JAX package's ``repro.layers.moe.moe_apply``, on the MoE smoke configs
(mixtral-8x7b: top 2 of 4 experts; llama4-scout-17b-a16e: top 1 of 4;
d_model 64, d_ff 128, dispatch group 64) with the JAX parameters carried
across.

The routing is held bit-exact: each (token, choice)'s expert, its place in
the expert's queue and whether the capacity keeps it, against the
reference's own lines (f32 router softmax, ``jax.lax.top_k`` on the
probabilities, the cumsum over the flattened (token, choice) order)
evaluated with JAX on the same inputs.  Outputs are held within 1e-5 and
the auxiliary loss within 1e-6.  Group shapes: 8 tokens (one group), 64
(one full group) and 4400 (the group-size search: 55 at dispatch group 64;
a 4 x 1100 prefill at the full configs' 256 gives 220), plus a case built
so that capacity drops choices (8 tokens at E 4 give cap 5 for top 2) and
the single-token groups of the decode steps."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.layers import moe as MJ  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.layers import moe as MT  # noqa: E402

ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    several pytest workers on one host the threads' wake-ups dominate:
    run this module's torch ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """(arch, jax cfg, port cfg, the JAX layer parameters as numpy)."""
    arch = request.param
    jcfg = jax_smoke(arch)
    p = jax.tree.map(np.asarray, MJ.moe_params(jax.random.PRNGKey(7), jcfg))
    return arch, jcfg, get_smoke_config(arch), p


def as_torch(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def jax_routing(p, x, cfg):
    """The reference's routing lines (``repro/layers/moe.py:63-81``) on x
    [B, S, D]: (expert [g, t, k], pos [g, t, k], keep [g, t, k], gsz,
    cap) as numpy."""
    mcfg = cfg.moe
    e, k = mcfg.num_experts, mcfg.num_experts_per_token
    b, s, d = x.shape
    n = b * s
    gsz = min(mcfg.dispatch_group, n)
    while n % gsz != 0:
        gsz -= 1
    ng = n // gsz
    xt = jnp.asarray(x).reshape(ng, gsz, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    cap = max(int(math.ceil(k * gsz / e * mcfg.capacity_factor)), 4)
    sel = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    pos = jnp.cumsum(sel.reshape(ng, gsz * k, e), axis=1).reshape(
        ng, gsz, k, e) - 1.0
    keep = sel * (pos < cap)
    pos_c = jnp.sum(pos * sel, -1)
    return (np.asarray(gate_idx), np.asarray(pos_c).astype(np.int64),
            np.asarray(keep.sum(-1)).astype(bool), gsz, cap)


def inputs(seed, shape, d=64):
    return np.random.default_rng(seed).standard_normal(
        (*shape, d)).astype(np.float32)


def crowded(p, shape, seed=0):
    """Inputs whose router logits all favour expert 0: every token's first
    choice is expert 0, so a group of 8 sends 8 choices to a capacity of
    5 (top 2) or 4 (top 1)."""
    x = inputs(seed, shape) * 0.1
    r = p["router"][:, 0]
    return (x + 4.0 * r / np.linalg.norm(r) ** 2).astype(np.float32)


def check(p, x, jcfg, tcfg):
    """The port against JAX on x: routing bit-exact, outputs within 1e-5;
    returns the number of dropped choices."""
    expert, pos, keep, gsz, cap = jax_routing(p, x, jcfg)
    xt = torch.from_numpy(x)
    n = x.shape[0] * x.shape[1]
    assert MT.group_size(n, tcfg.moe.dispatch_group) == gsz
    assert MT.capacity(tcfg, gsz) == cap
    rt = MT.moe_route(as_torch(p)["router"], xt.reshape(n // gsz, gsz, -1),
                      tcfg)
    np.testing.assert_array_equal(rt.expert.numpy(), expert)
    np.testing.assert_array_equal(rt.pos.numpy(), pos)
    np.testing.assert_array_equal(rt.keep.numpy(), keep)
    assert rt.cap == cap
    yj, aux_j = MJ.moe_apply(p, jnp.asarray(x), jcfg)
    yt, aux_t = MT.moe_apply(as_torch(p), xt, tcfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=1e-5)
    assert abs(float(aux_t) - float(aux_j)) <= 1e-6
    return int((~keep).sum())


@pytest.mark.parametrize("shape", [(1, 8), (4, 16), (4, 1100)],
                         ids=["n8", "n64", "n4400"])
def test_moe_apply_matches_jax(layer, shape):
    _, jcfg, tcfg, p = layer
    check(p, inputs(sum(shape), shape), jcfg, tcfg)


def test_moe_apply_drops_choices_like_jax(layer):
    """8 tokens crowded onto expert 0: the capacity (5 for top 2, 4 for
    top 1) drops choices, the same ones as the reference."""
    arch, jcfg, tcfg, p = layer
    assert MT.capacity(tcfg, 8) == (5 if arch == "mixtral-8x7b" else 4)
    dropped = check(p, crowded(p, (1, 8)), jcfg, tcfg)
    assert dropped >= 3


def test_single_token_groups_match_a_vmap(layer):
    """``group=1`` (the decode steps: each request's token alone) equals
    the reference ``vmap``ped over single tokens, with the crowded inputs
    (which a shared group of 8 would drop)."""
    _, jcfg, tcfg, p = layer
    x = crowded(p, (8, 1), seed=1)
    want = jax.vmap(lambda t: MJ.moe_apply(p, t[None, None], jcfg)[0][0, 0])(
        jnp.asarray(x[:, 0]))
    got, _ = MT.moe_apply(as_torch(p), torch.from_numpy(x), tcfg, group=1)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    together, _ = MT.moe_apply(as_torch(p), torch.from_numpy(x)
                               .reshape(1, 8, -1), tcfg)
    assert float((together[0] - got[:, 0]).abs().max()) > 1e-3


def test_group_size_search_and_capacity():
    """The reference's search at the full configs' dispatch group: a
    4 x 1100 prefill routes in groups of 220 (cap 69 for mixtral's top 2
    of 8, 18 for llama4's top 1 of 16), a 128-row chunk in one group, a
    4-slot tick in one group at the capacity floor of 4."""
    mix, l4 = get_config("mixtral-8x7b"), get_config("llama4-scout-17b-a16e")
    assert MT.group_size(4400, mix.moe.dispatch_group) == 220
    assert MT.group_size(4400, 64) == 55
    assert MT.group_size(7, 64) == 7
    assert (MT.capacity(mix, 220), MT.capacity(l4, 220)) == (69, 18)
    assert (MT.capacity(mix, 128), MT.capacity(mix, 4)) == (40, 4)


def test_param_shapes_and_scales_are_the_reference_ones(layer):
    arch, jcfg, tcfg, p = layer
    shapes = MT.moe_param_shapes(tcfg)
    assert {k: s for k, (s, _) in shapes.items()} == \
        {k: v.shape for k, v in p.items()}
    full = MT.moe_param_shapes(get_config(arch))
    jfull = jax.eval_shape(lambda: MJ.moe_params(jax.random.PRNGKey(0),
                                                 jax_config(arch)))
    assert {k: s for k, (s, _) in full.items()} == \
        {k: v.shape for k, v in jfull.items()}
    # truncated normal in [-2, 2] std at the reference's scales
    for name, (_, scale) in shapes.items():
        assert np.abs(p[name]).max() <= 2 * scale + 1e-7
        assert 0.5 * scale < p[name].std() < scale
