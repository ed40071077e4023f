"""The port's PRNG (``repro_torch.serving.prng``) and sampler
(``repro_torch.serving.sampling``) against ``jax.random`` (jax 0.9.0,
threefry2x32, partitionable) and ``repro.serving.sampling``.

Bars: keys (``PRNGKey``, ``fold_in``, ``split``), 32-bit bits and uniforms
bit-exact; request stream keys, sampled tokens and next keys equal to
JAX's over 50 seeds at V 256 and 128256, T 0.3, 0.7 and 1.0 and top-p 1,
0.95, 0.9 and 0.5, in both of the reference's rounding forms (its compiled
tick's, which scales by the f32 reciprocal of T, and its eager prefill's,
which divides); nucleus masks bit-equal at V 256.  At V 128256 XLA's
softmax sum rounds differently from torch's (ROADMAP queue 3): masks may
differ only for tokens at the nucleus edge, whose mass before them lies
within 3e-5 of top-p; the test counts them.  Then the port's version of
each test in ``tests/test_sampling.py``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import sampling as JS  # noqa: E402
from repro.serving.engine import _sample_slots as jax_sample_slots  # noqa
from repro_torch.serving import prng  # noqa: E402
from repro_torch.serving import sampling as S  # noqa: E402
from repro_torch.serving.engine import _sample_slots  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    several pytest workers on one host the threads' wake-ups dominate:
    run this module's torch ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SEEDS = 50
# the most mass before a token whose nucleus membership XLA and torch
# decide differently at V 128256 (measured: 2.10e-5; ROADMAP queue 3)
EDGE = 3e-5


def as_torch(key) -> torch.Tensor:
    return torch.as_tensor(np.asarray(key).astype(np.int64))


def logits_np(rng, v=64, scale=4.0, rows=None):
    shape = (v,) if rows is None else (rows, v)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1])
def test_keys_are_jax_bits(seed):
    """``prng_key``, ``fold_in`` (small, large and > 2**31 data) and
    ``split`` (2, 3 and 5 ways) give JAX's words."""
    jk = jax.random.PRNGKey(seed)
    assert (np.asarray(jk) == prng.prng_key(seed).numpy()).all()
    for d in (0, 3, 17, 2 ** 31 + 5):
        assert (np.asarray(jax.random.fold_in(jk, d)) ==
                prng.fold_in(prng.prng_key(seed), d).numpy()).all(), d
    k = jax.random.fold_in(jk, 3)
    for n in (2, 3, 5):
        assert (np.asarray(jax.random.split(k, n)) ==
                prng.split(as_torch(k), n).numpy()).all(), n


def test_fold_in_of_key_zero_matches_the_issue_record():
    assert prng.fold_in(prng.prng_key(0), 3).tolist() == \
        [2467461003, 3840466878]


@pytest.mark.parametrize("seed", [0, 5, 99])
def test_bits_and_uniforms_are_jax_bits(seed):
    """32-bit ``random_bits`` and f32 ``uniform`` on [0, 1), on a shifted
    range (one FMA in XLA) and on [tiny, 1) (the Gumbel's) bit for bit, on
    one key and on a batch of keys."""
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    tk = as_torch(k)
    assert (np.asarray(jax.random.bits(k, (1001,))) ==
            prng.random_bits(tk, 1001).numpy()).all()
    for lo, hi in ((0.0, 1.0), (-2.5, 3.0), (0.1, 0.7), (prng.TINY, 1.0)):
        want = np.asarray(jax.random.uniform(k, (4097,), minval=lo,
                                             maxval=hi))
        got = prng.uniform(tk, 4097, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=str(lo))
    keys = jax.random.split(k, 4)
    want = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (257,)))(
        keys))
    np.testing.assert_array_equal(
        prng.uniform(as_torch(keys), 257).numpy().view(np.uint32),
        want.view(np.uint32))


def test_gumbel_within_two_ulps_of_jax():
    """The Gumbel noise takes the device's ``log``: within two f32 ulps of
    max(|g|, 1) of JAX's (XLA's CPU ``log`` rounds otherwise in some
    places; near g = 0 the inner log's ulp dominates), and mostly equal."""
    k = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    want = np.asarray(jax.random.gumbel(k, (100_001,)))
    got = prng.gumbel(as_torch(k), 100_001).numpy()
    err = np.abs(got - want)
    assert (err <= 2 * np.spacing(np.maximum(np.abs(want),
                                             np.float32(1)))).all()
    assert (err == 0).mean() > 0.5


@functools.lru_cache(maxsize=None)
def jax_tick_sampler(temperature, top_p):
    return jax.jit(functools.partial(jax_sample_slots,
                                     temperature=temperature, top_p=top_p))


@pytest.mark.parametrize("top_p", [1.0, 0.95, 0.9, 0.5])
@pytest.mark.parametrize("temperature", [0.3, 0.7, 1.0])
@pytest.mark.parametrize("vocab", [256, 128256])
def test_stream_sampling_matches_jax_over_seeds(vocab, temperature, top_p):
    """50 requests' streams (seed s, arrival s + 7): root keys equal
    ``request_stream_key``'s; one draw through the engine's
    ``_sample_slots`` equals the JAX engine's compiled one (tokens and
    next keys); rows through ``stream_sample`` equal the eager JAX one
    (the prefill's form; three rows at V 256, one at V 128256)."""
    rng = np.random.default_rng(vocab + int(temperature * 10) +
                                int(top_p * 100))
    logits = logits_np(rng, vocab, 3.0, rows=SEEDS)
    keys = np.stack([np.asarray(JS.request_stream_key(s, s + 7))
                     for s in range(SEEDS)])
    tkeys = torch.stack([S.request_stream_key(s, s + 7)
                         for s in range(SEEDS)])
    assert (tkeys.numpy() == keys).all()
    jt, jk = jax_tick_sampler(temperature, top_p)(jnp.asarray(keys),
                                                  jnp.asarray(logits))
    tt, tk = _sample_slots(tkeys, torch.as_tensor(logits), temperature,
                           top_p)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for r in range(3 if vocab == 256 else 1):
        et, ek = JS.stream_sample(jnp.asarray(keys[r]),
                                  jnp.asarray(logits[r]), temperature,
                                  top_p)
        pt, pk = S.stream_sample(tkeys[r], torch.as_tensor(logits[r]),
                                 temperature, top_p)
        assert int(pt) == int(et), r
        assert (pk.numpy() == np.asarray(ek)).all(), r


@pytest.mark.parametrize("top_p", [0.95, 0.9, 0.5])
@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("vocab", [256, 128256])
def test_nucleus_mask_matches_jax(vocab, temperature, top_p):
    """The nucleus of the compiled tick's scaled logits over 50 rows:
    bit-equal to JAX's at V 256.  At V 128256 a token's membership may
    differ only at the nucleus edge (mass before it within EDGE of top-p:
    XLA and torch sum the softmax in another order, ROADMAP queue 3)."""
    rng = np.random.default_rng(3 * vocab + int(temperature * 10) +
                                int(top_p * 100))
    logits = logits_np(rng, vocab, 3.0, rows=SEEDS)
    want = np.asarray(jax.jit(jax.vmap(
        lambda x: JS._top_p_filter(x / temperature, top_p)))(
            jnp.asarray(logits))) > -1e29
    scaled = torch.as_tensor(logits) * (1.0 / torch.full((), temperature))
    got = (S._top_p_filter(scaled, top_p) > -1e29).numpy()
    diff = np.argwhere(got != want)
    if vocab == 256:
        assert len(diff) == 0, diff
    p = torch.softmax(scaled.double(), -1)
    for r, c in diff:
        before = float(p[r][p[r] > p[r, c]].sum())
        assert abs(before - top_p) <= EDGE, (r, c, before - top_p)
    print(f"V {vocab} T {temperature} top-p {top_p}: {len(diff)} edge "
          f"tokens differ in {len(set(diff[:, 0].tolist()))} of {SEEDS} "
          f"rows")


# the port's versions of tests/test_sampling.py


def test_greedy_matches_np_argmax_bitexact(rng):
    for _ in range(10):
        logits = torch.as_tensor(logits_np(rng))
        tok = S.sample_tokens(None, logits, temperature=0.0)
        assert int(tok) == int(np.argmax(logits.numpy()))


def test_greedy_ties_break_low_like_np_argmax():
    logits = torch.zeros(16)
    logits[3] = logits[9] = 1.0
    tok = S.sample_tokens(None, logits, temperature=0.0)
    assert int(tok) == 3 == int(np.argmax(logits.numpy()))


def test_temperature_to_zero_converges_to_greedy():
    """For 25 seeded (key, logits) draws, a temperature below the
    runner-up gap / 100 samples the argmax on four subkeys, as JAX's
    sampler does on the same draws."""
    draw = np.random.default_rng(2024)
    for _ in range(25):
        seed, vocab = int(draw.integers(0, 2 ** 31 - 1)), \
            int(draw.integers(8, 129))
        logits = logits_np(np.random.default_rng(seed), v=vocab)
        greedy = int(np.argmax(logits))
        top2 = np.sort(logits)[-2:]
        temp = max(float(top2[1] - top2[0]), 1e-3) / 100.0
        for sub in prng.split(prng.prng_key(seed), 4):
            assert int(S.sample_tokens(sub, torch.as_tensor(logits),
                                       temp)) == greedy
        for sub in jax.random.split(jax.random.PRNGKey(seed), 4):
            assert int(JS.sample_tokens(sub, jnp.asarray(logits),
                                        temp)) == greedy


def test_temperature_one_samples_proportionally():
    logits = torch.full((32,), -30.0)
    logits[5] = logits[11] = 2.0
    seen = {int(S.sample_tokens(k, logits, 1.0))
            for k in prng.split(prng.prng_key(0), 64)}
    assert seen == {5, 11}


def test_top_p_masks_outside_nucleus():
    """top-p below the top token's mass forces greedy (the argmax always
    survives); just above it, a nucleus of two; the masks equal JAX's."""
    logits = torch.tensor([3.0, 2.0, 1.0, -5.0])
    probs = torch.softmax(logits, -1).numpy()
    for key in prng.split(prng.prng_key(1), 32):
        assert int(S.sample_tokens(key, logits, 1.0,
                                   top_p=float(probs[0]) * 0.5)) == 0
    seen = {int(S.sample_tokens(k, logits, 1.0,
                                top_p=float(probs[0]) + 1e-4))
            for k in prng.split(prng.prng_key(2), 64)}
    assert seen == {0, 1}
    for top_p in (float(probs[0]) * 0.5, float(probs[0]) + 1e-4, 0.999):
        want = np.asarray(JS._top_p_filter(jnp.asarray(logits.numpy()),
                                           top_p))
        np.testing.assert_array_equal(
            S._top_p_filter(logits, top_p).numpy(), want)


def test_stream_sample_greedy_leaves_key_untouched():
    key = prng.prng_key(7)
    tok, key2 = S.stream_sample(key, torch.tensor([0.0, 1.0, 2.0]),
                                temperature=0.0)
    assert int(tok) == 2
    assert torch.equal(key, key2)


def test_stream_sample_advances_key_per_draw(rng):
    """The token sequence is a pure function of (seed, arrival, logits),
    the same as JAX's over five draws."""
    logits_seq = [logits_np(rng) for _ in range(5)]

    def roll(seed, arrival):
        key = S.request_stream_key(seed, arrival)
        out = []
        for lg in logits_seq:
            tok, key = S.stream_sample(key, torch.as_tensor(lg), 0.9,
                                       top_p=0.95)
            out.append(int(tok))
        return out

    def jax_roll(seed, arrival):
        key = JS.request_stream_key(seed, arrival)
        out = []
        for lg in logits_seq:
            tok, key = JS.stream_sample(key, jnp.asarray(lg), 0.9,
                                        top_p=0.95)
            out.append(int(tok))
        return out

    assert roll(0, 3) == roll(0, 3) == jax_roll(0, 3)
    assert roll(0, 3) != roll(0, 4) or roll(0, 3) != roll(1, 3)


def test_request_stream_key_unique_per_arrival():
    keys = {tuple(S.request_stream_key(0, a).tolist()) for a in range(32)}
    assert len(keys) == 32
