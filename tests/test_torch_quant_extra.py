"""The rest of the JAX package's surface that the port copies: the second
half of ``core/quantization.py`` (the KIVI per-channel baseline, per-tensor
FP8, nibble and ternary packing, the memory accounting), the App. C.2
sparsity statistics of ``core/thoughts.py`` (``gqa_group_sparsity``,
``sparsity_from_qk``), ``configs.assigned_archs``, ``layers/rope.py``'s
``rope_single``, ``core/ct_cache.py``'s ``view_paged``, the
``RetraceGuard``'s ``on_steady_retrace`` keyword and
``assert_no_steady_retraces``, and the dry run's ``--tag``.

Inputs come from numpy seeds and go through the JAX function and the
port's.  Codes, packed bytes and scales are bit-exact (scales compared as
bit patterns, FP8 codes through uint8 views); dequantized values too (the
same f32 products); the sparsity statistics within 1e-6 (f32, a softmax
summed in another order)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as CFJ  # noqa: E402
from repro.config import ThinKVConfig as JTK  # noqa: E402
from repro.core import ct_cache as CCJ  # noqa: E402
from repro.core import quantization as QJ  # noqa: E402
from repro.core import thoughts as THJ  # noqa: E402
from repro.layers import rope as RPJ  # noqa: E402
from repro_torch import configs as CFT  # noqa: E402
from repro_torch.analysis import retrace as RG  # noqa: E402
from repro_torch.config import ThinKVConfig  # noqa: E402
from repro_torch.core import ct_cache as CCT  # noqa: E402
from repro_torch.core import quantization as QT  # noqa: E402
from repro_torch.core import thoughts as THT  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.layers import rope as RPT  # noqa: E402
from test_torch_quant import edge_inputs, same_bits  # noqa: E402

SPARSITY_TOL = 1e-6


def fp8_bits(codes) -> np.ndarray:
    """float8_e4m3fn codes (a torch tensor or a JAX array) as uint8."""
    if torch.is_tensor(codes):
        return codes.view(torch.uint8).numpy()
    return np.asarray(codes).view(np.uint8)


# ---------------------------------------------------------------------------
# KIVI per-channel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("transpose", (False, True), ids=("rows", "cols"))
@pytest.mark.parametrize("seed", (0, 1))
def test_per_channel_bit_exact(bits, transpose, seed):
    """Codes, scales and dequantized values of ``quantize_per_channel`` /
    ``dequantize_per_channel`` on edge inputs (subnormal-range, zero,
    saturating groups), laid along the token axis or the channel axis."""
    x = edge_inputs(16, 64, seed)
    x = np.ascontiguousarray(x.T if transpose else x)
    cj, sj = QJ.quantize_per_channel(jnp.asarray(x), bits)
    ct, st = QT.quantize_per_channel(torch.from_numpy(x), bits)
    same_bits(ct.numpy(), cj)
    same_bits(st.numpy(), sj)
    same_bits(QT.dequantize_per_channel(ct, st, bits).numpy(),
              QJ.dequantize_per_channel(cj, sj, bits))


def test_mx_channel_group_keys_vs_kivi_per_channel():
    """``tests/test_quantization.py``'s KIVI case on the port: keys with
    channel-structured outliers, MX channel-group scales within noise of
    KIVI per-channel at g 16; both errors equal to the JAX package's."""
    rng = np.random.default_rng(99)
    base = rng.standard_normal((16, 128))
    base[:, ::16] *= 6.0
    x = base.astype(np.float32)
    errs = {}
    for name, Q, conv in (("jax", QJ, jnp.asarray),
                          ("port", QT, torch.from_numpy)):
        xx = conv(x)
        c1, s1 = Q.quantize_group(xx, 4)
        y1 = np.asarray(Q.dequantize_group(c1, s1, 4))
        c2, s2 = Q.quantize_per_channel(xx, 4)
        y2 = np.asarray(Q.dequantize_per_channel(c2, s2, 4))
        errs[name] = (np.mean((x - y1) ** 2), np.mean((x - y2) ** 2))
    e1, e2 = errs["port"]
    assert e1 <= e2 * 1.5, (e1, e2)
    assert errs["port"] == errs["jax"]


# ---------------------------------------------------------------------------
# FP8 per tensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["normal", "large", "tiny", "zero",
                                  "bf16"])
def test_fp8_per_tensor_bit_exact(case):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((32, 64)) * 10).astype(np.float32)
    if case == "large":
        x *= 1e5
    elif case == "tiny":
        x *= 1e-9
    elif case == "zero":
        x[:] = 0.0
    if case == "bf16":
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    cj, sj = QJ.quantize_fp8(xj)
    ct, st = QT.quantize_fp8(xt)
    assert ct.dtype == torch.float8_e4m3fn and st.dtype == torch.float32
    assert (fp8_bits(ct) == fp8_bits(cj)).all()
    same_bits(st.numpy().reshape(1), np.asarray(sj).reshape(1))
    same_bits(QT.dequantize_fp8(ct, st).numpy(), QJ.dequantize_fp8(cj, sj))
    if case == "normal":
        y = QT.dequantize_fp8(ct, st).numpy()
        err = np.sqrt(np.mean((x - y) ** 2) / np.mean(x ** 2))
        assert err < 0.04


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(8,), (2, 3, 4)])
@pytest.mark.parametrize("high", (16, 256), ids=("codes", "any_byte"))
def test_nibble_packing_bit_exact(lead, high):
    """``pack_nibbles`` / ``unpack_nibbles`` on 4-bit codes (which round
    trip) and on any byte (the reference's unmasked packing)."""
    rng = np.random.default_rng(high + len(lead))
    c = rng.integers(0, high, lead + (128,)).astype(np.uint8)
    pj = QJ.pack_nibbles(jnp.asarray(c))
    pt = QT.pack_nibbles(torch.from_numpy(c))
    same_bits(pt.numpy(), pj)
    same_bits(QT.unpack_nibbles(pt).numpy(), QJ.unpack_nibbles(pj))
    if high == 16:
        assert (QT.unpack_nibbles(pt).numpy() == c).all()


@pytest.mark.parametrize("lead", [(8,), (2, 3, 4)])
@pytest.mark.parametrize("high", (4, 256), ids=("codes", "any_byte"))
def test_ternary_packing_bit_exact(lead, high):
    rng = np.random.default_rng(3 * high + len(lead))
    c = rng.integers(0, high, lead + (128,)).astype(np.uint8)
    pj = QJ.pack_ternary(jnp.asarray(c))
    pt = QT.pack_ternary(torch.from_numpy(c))
    assert pt.shape == lead + (32,)
    same_bits(pt.numpy(), pj)
    same_bits(QT.unpack_ternary(pt).numpy(), QJ.unpack_ternary(pj))
    if high == 4:
        assert (QT.unpack_ternary(pt).numpy() == c).all()


def test_packing_refuses_a_ragged_last_axis():
    with pytest.raises(ValueError, match="multiple of 2"):
        QT.pack_nibbles(torch.zeros((4, 7), dtype=torch.uint8))
    with pytest.raises(ValueError, match="multiple of 4"):
        QT.pack_ternary(torch.zeros((4, 6), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# Memory accounting
# ---------------------------------------------------------------------------

def test_cache_bits_accounting():
    """``tests/test_quantization.py``'s accounting case on the port, and
    every (bits, g, plane) equal to the JAX package's."""
    assert QT.cache_bits_per_element(4) == pytest.approx(4.5)
    assert QT.cache_bits_per_element(2, physical_nibble_plane=False) == \
        pytest.approx(2.5)
    assert QT.cache_bits_per_element(8) == pytest.approx(8.5)
    for bits in (2, 4, 8):
        for g in (8, 16, 32):
            for plane in (True, False):
                assert QT.cache_bits_per_element(bits, g, plane) == \
                    QJ.cache_bits_per_element(bits, g, plane)


# ---------------------------------------------------------------------------
# App. C.2 sparsity statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", (1, 2, 4, 8))
@pytest.mark.parametrize("masked", (False, True))
def test_gqa_group_sparsity_matches_jax(group, masked):
    rng = np.random.default_rng(10 * group + masked)
    scores = (rng.standard_normal((8, 64)) * 4).astype(np.float32)
    valid = rng.random(64) < 0.7 if masked else None
    want = THJ.gqa_group_sparsity(
        jnp.asarray(scores), group,
        None if valid is None else jnp.asarray(valid))
    got = THT.gqa_group_sparsity(
        torch.from_numpy(scores), group,
        None if valid is None else torch.from_numpy(valid))
    assert 0.0 <= float(got) <= 1.0
    assert abs(float(got) - float(want)) <= SPARSITY_TOL


def test_gqa_group_sparsity_refuses_a_ragged_group():
    with pytest.raises(ValueError, match="multiple of the group size"):
        THT.gqa_group_sparsity(torch.zeros((6, 8)), 4)


@pytest.mark.parametrize("hq,hkv,n", [(8, 2, 64), (4, 4, 33), (8, 1, 128)])
@pytest.mark.parametrize("per_head", (False, True))
def test_sparsity_from_qk_matches_jax(hq, hkv, n, per_head):
    """The decode-time statistic over compressed keys, with a validity mask
    per key or per (key, kv head)."""
    rng = np.random.default_rng(hq * n + hkv + per_head)
    q = rng.standard_normal((hq, 32)).astype(np.float32)
    k = (rng.standard_normal((n, hkv, 32)) * 2).astype(np.float32)
    shape = (n, hkv) if per_head else (n,)
    valid = rng.random(shape) < 0.8
    valid[0] = True
    want = THJ.sparsity_from_qk(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(valid), gqa_group=hq // hkv)
    got = THT.sparsity_from_qk(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(valid), gqa_group=hq // hkv)
    assert abs(float(got) - float(want)) <= SPARSITY_TOL


def test_sparsity_from_qk_refuses_a_disagreeing_group():
    """``gqa_group`` is 1 or the shapes' group (8 q heads over 2 kv heads:
    4); any other value is refused, not silently ignored."""
    q, k = torch.zeros((8, 16)), torch.zeros((5, 2, 16))
    valid = torch.ones(5, dtype=torch.bool)
    for g in (1, 4):
        assert torch.isfinite(THT.sparsity_from_qk(q, k, valid, gqa_group=g))
    with pytest.raises(ValueError, match="gqa_group 2 disagrees"):
        THT.sparsity_from_qk(q, k, valid, gqa_group=2)


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------

def test_assigned_archs_are_the_references():
    """The ten assigned architectures (the registry without the paper's
    model); the port's registry is sorted, the reference's in pool order."""
    assert CFT.assigned_archs() == sorted(CFJ.assigned_archs())
    assert "r1-llama-8b" not in CFT.assigned_archs()
    assert len(CFT.assigned_archs()) == 10


@pytest.mark.parametrize("pos,theta,d", [(0, 1e4, 16), (17, 1e4, 64),
                                         (4095, 5e5, 128), (3, 1e6, 112)])
def test_rope_single_matches_jax(pos, theta, d):
    rng = np.random.default_rng(pos + d)
    x = rng.standard_normal((4, d)).astype(np.float32)
    want = RPJ.rope_single(jnp.asarray(x), jnp.int32(pos), theta)
    got = RPT.rope_single(torch.from_numpy(x), torch.tensor(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_view_paged_inverts_view_flat_as_the_reference():
    tk = dict(refresh_interval=8, group_size=8, block_size=8,
              token_budget=32, retention_schedule=(16, 8, 4),
              min_retention=4, max_segments=16, kmeans_iters=2)
    dt = CCT.make_dims(ThinKVConfig(**tk), 2, 3, 32)
    dj = CCJ.make_dims(JTK(**tk), 2, 3, 32)
    rng = np.random.default_rng(5)
    planes = [rng.integers(0, 256, (2, dt.NB, dt.BS, 3, w)).astype(np.uint8)
              for w in (32, 32, 2, 2)]
    view = CCT.PoolView(*map(torch.from_numpy, planes))
    flat = CCT.view_flat(view)
    back = CCT.view_paged(dt, *flat)
    want = CCJ.view_paged(dj, *map(jnp.asarray, (f.numpy() for f in flat)))
    for got, p, w in zip(back, view, want):
        assert got.shape == p.shape == np.asarray(w).shape
        assert got.data_ptr() == p.data_ptr()          # a view, no copy
        assert (got.numpy() == np.asarray(w)).all()


class _Engine:
    """The entry points the guard wraps, on a stand-in engine."""

    device = torch.device("cpu")

    def __init__(self):
        self.built_in = set()

    def _call(self, name):
        if name in self.built_in:
            build.BUILDS += 1
        return name

    def _trip(self):
        return self._call("_trip")

    def _pack(self):
        return self._call("_pack")

    def _prefill_chunk(self):
        return self._call("_prefill_chunk")

    def _prefill_big(self):
        return self._call("_prefill_big")

    def _release_slot(self):
        return self._call("_release_slot")


def test_retrace_guard_raises_at_a_steady_build_when_asked(monkeypatch):
    """``on_steady_retrace="raise"``: a build after ``mark_steady()`` raises
    at the call; ``"record"`` defers to ``assert_no_steady_retraces``."""
    monkeypatch.setattr(build, "BUILDS", 0)
    eng = _Engine()
    with pytest.raises(RuntimeError, match="no RetraceGuard installed"):
        RG.assert_no_steady_retraces(eng)
    with pytest.raises(ValueError, match="'record' or 'raise'"):
        RG.RetraceGuard(eng, on_steady_retrace="warn")
    with RG.RetraceGuard(eng, on_steady_retrace="raise") as guard:
        eng.built_in = {"_trip"}
        assert eng._trip() == "_trip"                 # warmup: recorded
        guard.mark_steady()
        RG.assert_no_steady_retraces(eng)
        eng.built_in = {"_prefill_chunk"}
        with pytest.raises(RG.RetraceViolation,
                           match="_prefill_chunk built a kernel library at "
                                 "its call #1"):
            eng._prefill_chunk()
        assert guard.report()["builds"] == 2
    with RG.RetraceGuard(eng) as guard:
        guard.mark_steady()
        eng.built_in = {"_prefill_big"}
        eng._prefill_big()                            # built: recorded
        eng.built_in = set()
        with pytest.raises(RG.RetraceViolation, match="1 steady-state"):
            RG.assert_no_steady_retraces(eng)
    assert "_trip" not in eng.__dict__


def test_dry_run_tag_and_recount(tmp_path, capsys):
    """``--tag`` suffixes each cell's file name with ``__<tag>``; a rerun
    counts every cell again and overwrites its file, never reading a stale
    one back."""
    argv = ["--arch", "yi-6b", "--shape", "decode_32k", "--mesh", "single",
            "--out", str(tmp_path)]
    assert DR.main(argv + ["--tag", "opt"]) == 0
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(f"yi-6b__decode_32k__{v}__single__opt.json"
                           for v in DR.variants_for("yi-6b", "decode_32k"))
    path = tmp_path / files[0]
    rec = json.loads(path.read_text())
    assert rec["cell"] == path.stem
    stale = dict(rec, seconds=-1.0, bytes_per_rank=-1)
    path.write_text(json.dumps(stale))
    assert DR.main(argv + ["--tag", "opt"]) == 0
    again = json.loads(path.read_text())
    assert again["seconds"] >= 0.0
    assert again["bytes_per_rank"] == rec["bytes_per_rank"]
    assert DR.main(argv) == 0
    assert len(os.listdir(tmp_path)) == 2 * len(files)
    capsys.readouterr()
