"""The roofline arithmetic against hand counts."""
import json

import pytest

import tinycell  # noqa: F401  (puts bench/ on the path)
from benchlib import model, profile, roofline, spec


def _arch(name):
    return model.arch(json.loads(
        (spec.BENCH / "configs" / f"{name}.json").read_text()))


def test_pool_bytes_per_token_and_layer():
    a = _arch("qwen2-7b")
    # 4 kv heads x (128 K + 128 V code bytes + 2 x 8 bf16 scales)
    assert roofline.paged_per_block(1, a["kv_heads"], a["head_dim"]) \
        == 4 * (256 + 32) == 1152
    assert roofline.paged_per_block(16, 4, 128) == 18432


def test_params_in_products():
    q = _arch("qwen2-7b")
    layer = 2 * 3584 * 3584 + 2 * 3584 * 512 + 3 * 3584 * 18944
    assert model.params_in_products(q) == 28 * layer + 3584 * 152064
    assert round(model.params_in_products(q) / 1e9, 2) == 7.07
    m = _arch("mixtral-8x7b-l8")
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 8 + 2 * 3 * 4096 * 14336
    assert model.params_in_products(m) == 8 * layer + 4096 * 32000


def test_k1_bytes_at_a_small_pool():
    # L 2, R 2, H 1, GQ 2, D 16, NB 4, BS 4: 3 blocks holding VALID slots,
    # 9 VALID slots, 2 x (3 + 1) buffer entries
    b, f = roofline.k1_tick(blocks=3, n_valid=9, n_buf=8, L=2, R=2, H=1,
                            gq=2, D=16, NB=4, BS=4)
    per_block = 4 * 1 * (2 * 16 + 2 * 2 * 1)
    q = 2 * 2 * 1 * 2 * 16 * 4
    assert b == 3 * per_block + q + 2 * 2 * 2 * 4 * 4 + 2 * 2 * 4 * 4 \
        + 2 * 4 + q + 2 * 8 * 1 * 16 * 2
    assert f == 4 * 1 * 2 * 16 * (9 + 8)


def test_k2_chunk_and_chunks():
    assert roofline.prefill_chunks(300, 128, 16) == \
        [(0, 128), (128, 128), (256, 16), (272, 16), (288, 16)]
    b, f = roofline.k2_chunk(n_valid=256, rows=16, H=8, gq=4, D=128,
                             NB=128, BS=16)
    GQ = 64
    assert f == 4 * 8 * GQ * 128 * 256
    assert b == 16 * roofline.paged_per_block(16, 8, 128) + \
        2 * 8 * GQ * 128 * 4 + 2 * 128 * 16 + 128 * 4 + 2 * 8 * GQ * 4


def test_bound_takes_the_larger():
    assert roofline.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 67e12) == pytest.approx(1.0)


def test_busy_time_is_a_union():
    rec = {"device_ops": [("a", 0.0, 10.0), ("b", 5.0, 12.0),
                          ("Memcpy DtoH", 20.0, 22.0)],
           "spans": [("thinkv.tick", 0.0, 30.0)],
           "cpu_ops": [("aten::copy_", 11.0, 21.0)]}
    assert profile.busy_s(rec) == pytest.approx(14e-6)
    gaps = profile.breakdown(rec)["idle_gaps"]
    assert gaps == [["thinkv.tick: aten::copy_", pytest.approx(8e-6)]]
    assert profile.kernel_time_s(rec, ("a",)) == (pytest.approx(1e-5), 1)
