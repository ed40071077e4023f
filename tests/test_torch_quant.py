"""The port's TBQ quantization is bit-exact to the JAX package's
(``core/quantization.py``) and K4's plain version to the Pallas
``group_quant`` kernel (interpret mode)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as QJ  # noqa: E402
from repro.kernels.group_quant import group_quant  # noqa: E402
from repro_torch.core import quantization as QT  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def edge_inputs(rows, d, seed):
    """Normal rows plus groups whose amax falls in the E4M3 subnormal
    scale range, at zero, at the 448 saturation edge and beyond."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    x[0, :16] *= 1e-4
    x[1, :16] *= 1e-6
    x[2, :16] = 0.0
    x[3, :16] *= 3000.0
    x[4, :16] = 448.0 * 127.0 * 1.5
    x[5, :16] = rng.uniform(2 ** -12, 2 ** -10, 16)
    x[6, :16] = rng.uniform(2 ** -20, 2 ** -17, 16)
    x[7, :16] = 448.0 * np.sign(rng.standard_normal(16))
    return x


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert (a.view(np.uint8) == b.view(np.uint8)).all()


@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("shape,seed", [((16, 32), 0), ((48, 128), 1),
                                        ((8, 16), 2)])
def test_quantize_group_bit_exact(bits, shape, seed):
    x = edge_inputs(*shape, seed)
    cj, sj = QJ.quantize_group(jnp.asarray(x), bits)
    ct, st = QT.quantize_group(torch.from_numpy(x), bits)
    same_bits(ct.numpy(), cj)
    same_bits(st.numpy(), sj)


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_dequantize_group_bit_exact(bits):
    x = edge_inputs(32, 64, 3)
    cj, sj = QJ.quantize_group(jnp.asarray(x), bits)
    dj = QJ.dequantize_group(cj, sj, bits)
    dt = QT.dequantize_group(torch.from_numpy(np.array(cj)),
                             torch.from_numpy(np.array(sj)), bits)
    same_bits(dt.numpy(), dj)


def test_dequantize_by_bitcode_mixed_bits_bit_exact():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 256, (24, 2, 32)).astype(np.uint8)
    scales = np.asarray(QJ.e4m3_round(jnp.asarray(
        rng.uniform(1e-3, 2.0, (24, 2, 2)).astype(np.float32))))
    bits = rng.choice([2, 4, 8], (24, 1, 1)).astype(np.int32)
    dj = QJ.dequantize_by_bitcode(jnp.asarray(codes), jnp.asarray(scales),
                                  jnp.asarray(bits))
    dt = QT.dequantize_by_bitcode(torch.from_numpy(codes),
                                  torch.from_numpy(scales),
                                  torch.from_numpy(bits))
    same_bits(dt.numpy(), dj)


def test_e4m3_round_and_next_up_over_the_whole_grid():
    """Every positive finite E4M3 value (subnormals included) rounds to
    itself and steps to the same successor in both frameworks."""
    grid = np.arange(1, 0x7F, dtype=np.uint8).view(
        jnp.float8_e4m3fn).astype(np.float32)
    mids = (grid[:-1] + grid[1:]) / 2
    vals = np.concatenate([grid, mids, [0.0, 500.0, 1e-9]]).astype(
        np.float32)
    same_bits(QT.e4m3_round(torch.from_numpy(vals)).numpy(),
              QJ.e4m3_round(jnp.asarray(vals)))
    same_bits(QT._e4m3_next_up(torch.from_numpy(grid)).numpy(),
              QJ._e4m3_next_up(jnp.asarray(grid)))


@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("shape", ((16, 32), (48, 128), (130, 16)))
def test_group_quant_plain_version_matches_pallas_kernel(bits, shape):
    """K4's plain version (what ``ops.tbq_group_quant`` runs for a CPU
    tensor): codes and bf16 scales bit-exact to the Pallas kernel."""
    x = edge_inputs(*shape, seed=shape[0] + bits)
    ck, sk = group_quant(jnp.asarray(x), bits, interpret=True)
    launches = dict(ops.LAUNCHES)
    ct, st = ops.tbq_group_quant(torch.from_numpy(x), bits)
    assert ops.LAUNCHES == launches          # a CPU tensor launches nothing
    same_bits(ct.numpy(), ck)
    assert st.dtype == torch.bfloat16
    np.testing.assert_array_equal(st.view(torch.int16).numpy(),
                                  np.asarray(sk).view(np.int16))


def buffers(shape, seed):
    """bf16 K/V commit buffers [L, G, H, D] whose first groups hold the
    edge rows of :func:`edge_inputs` (as bf16)."""
    L, G, H, D = shape
    k = edge_inputs(L * G * H, D, seed).astype(jnp.bfloat16)
    v = (edge_inputs(L * G * H, D, seed + 1) * 40).astype(jnp.bfloat16)
    return k.reshape(shape), v.reshape(shape)


@pytest.mark.parametrize("thought", (0, 1, 2))
@pytest.mark.parametrize("precision", [(2, 4, 4), (2, 4, 8), (4, 8, 8),
                                       (8, 8, 8)])
def test_commit_quantization_matches_reference_selection(precision, thought):
    """A commit's quantization (``_quantize_group_by_thought``: one K4 launch
    on the card, its plain version here) against the reference's, which
    quantizes at every precision level and selects the thought's: codes,
    scale bits and the returned bits equal, for every thought under mixed
    precisions."""
    from repro.config import ThinKVConfig as JTK
    from repro.core import ct_cache as CJ
    from repro_torch.config import ThinKVConfig
    from repro_torch.convert import tensor_from_numpy
    from repro_torch.core import ct_cache as CT
    k, v = buffers((2, 8, 2, 32), seed=10 * thought + precision[1])
    want = CJ._quantize_group_by_thought(
        JTK(precision=precision), jnp.asarray(k).astype(jnp.float32),
        jnp.asarray(v).astype(jnp.float32), jnp.int32(thought))
    launches = dict(ops.LAUNCHES)
    got = CT._quantize_group_by_thought(
        ThinKVConfig(precision=precision), tensor_from_numpy(k, "cpu"),
        tensor_from_numpy(v, "cpu"), torch.tensor(thought, dtype=torch.int32))
    assert ops.LAUNCHES == launches
    assert got[4].dtype == torch.int32 and int(got[4]) == \
        precision[thought] == int(want[4])
    for g, w, name in zip(got, want, ("k codes", "k scales", "v codes",
                                      "v scales")):
        g = g.view(torch.int16) if g.dtype == torch.bfloat16 else g
        same_bits(g.numpy(), np.asarray(w).view(
            np.int16 if w.dtype == jnp.bfloat16 else np.uint8))


def test_commit_quant_takes_the_first_level_for_other_bits():
    """Bits that name no precision level select the first level, as the
    reference's selection chain does."""
    k, v = buffers((1, 4, 2, 32), seed=3)
    kt, vt = (torch.from_numpy(np.array(a.view(np.uint16))).view(
        torch.bfloat16) for a in (k, v))
    def as_np(t):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t) \
            .numpy()
    for bits, want in ((8, 2), (4, 4), (0, 2)):
        got = ops.tbq_commit_quant(
            kt, vt, torch.tensor(bits, dtype=torch.int32), (2, 4))
        kc, ks = QT.quantize_group(kt.float(), want)
        vc, vs = QT.quantize_group(vt.float(), want)
        for g, w in zip(got, (kc, ks.to(torch.bfloat16), vc,
                              vs.to(torch.bfloat16))):
            same_bits(as_np(g), as_np(w))


@pytest.mark.parametrize("case", ["levels", "empty_levels", "dtype", "bits",
                                  "bits_shape", "shape", "head_dim"])
def test_commit_quant_refuses_what_it_does_not_take(case):
    k = torch.zeros((2, 4, 1, 32), dtype=torch.bfloat16)
    v, bits, levels = k.clone(), torch.tensor(4, dtype=torch.int32), (2, 4)
    err = ValueError
    if case == "levels":
        levels = (2, 3)
    elif case == "empty_levels":
        levels = ()
    elif case == "dtype":
        k, err = k.float(), TypeError
    elif case == "bits":
        bits, err = bits.long(), TypeError
    elif case == "bits_shape":
        bits = bits.reshape(1)
    elif case == "shape":
        v = v[:, :2].contiguous()
    elif case == "head_dim":
        k, v = k[..., :24].contiguous(), v[..., :24].contiguous()
    with pytest.raises(err):
        ops.tbq_commit_quant(k, v, bits, levels)
