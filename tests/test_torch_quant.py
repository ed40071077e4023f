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
