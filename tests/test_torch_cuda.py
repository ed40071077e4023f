"""The CUDA kernels against their plain versions, on the card; the flash, the
pressure and the sampled trace and the pressure trace under the rkv and
uniform policies (head_dim 16) on the card against the JAX engine's
records; the shared-pool operations, the sampler, a fork and the rkv and
uniform selections on card tensors against their CPU results; packs of 8
ticks against single ticks on the kernel backend; the dense ThinKV serve
step's kernel path (one K1 launch per layer) against its plain path; a
uniform single-level commit; the pressure trace on mixtral-8x7b's (MoE)
and qwen2-7b's (qkv bias) smoke configs against their JAX records, and
K1-K3 at those configs' query-group sizes; K1 at head_dim 112 and the JAX
records of the hybrid and encoder-decoder serve steps; K2 and K3 at head
dim 112; the JAX train record replayed by the port's train step, and a
trainer resumed after an injected failure; the KIVI, FP8 and packing
functions on card tensors against their CPU results, and the port's
three examples on the card against their CPU runs.

Every test here needs a CUDA card and the CUDA toolkit (the kernels are
built with nvcc at first use); without a card each test skips with the
reason.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Attention kernels agree with the plain versions to 1e-4 (f32 on both
sides, another summation order); the quantizer is bit-exact; the selective
scan agrees to rtol = atol = 3e-4 (the JAX package's bar between its scan
kernel and its oracle)."""
import copy
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import ServeConfig, ThinKVConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ct_cache as CT  # noqa: E402
from repro_torch.core import quantization as Q  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.models import ssm_lm  # noqa: E402
from repro_torch.models.lm import init_params  # noqa: E402
from repro_torch.serving import trace_record as TR  # noqa: E402
from repro_torch.serving.engine import ThinKVEngine  # noqa: E402

ATOL = 1e-4
FLASH_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "golden", "torch_flash_trace.npz")
PRESSURE_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "golden", "torch_pressure_trace.npz")
SAMPLED_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "golden", "torch_sampled_trace.npz")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def pool_case(gen, L, R_, H, GQ, D, BS, NB, G=16, NP=None):
    NP = R_ * NB + 3 if NP is None else NP
    codes = lambda: torch.randint(0, 256, (L, NP, BS, H, D), generator=gen,
                                  dtype=torch.uint8)
    scales = lambda: (torch.rand((L, NP, BS, H, D // 16), generator=gen)
                      * 0.03 + 0.002).to(torch.bfloat16)
    table = torch.stack([torch.stack([torch.randperm(NP, generator=gen)[:NB]
                                      for _ in range(L)])
                         for _ in range(R_)]).to(torch.int32)
    table[torch.rand((R_, L, NB), generator=gen) < 0.25] = -1
    u = torch.rand((L, R_, NB, BS), generator=gen)
    state = torch.where(u < 0.7, 1, torch.where(u < 0.85, 2, 0)) \
        .to(torch.uint8)
    state.masked_fill_((table < 0).permute(1, 0, 2)[..., None], 0)
    bits = torch.tensor([2, 4, 8], dtype=torch.uint8)[
        torch.randint(0, 3, (L, R_, NB, BS), generator=gen)]
    return dict(qh=torch.randn((L, R_, H, GQ, D), generator=gen),
                k_codes=codes(), v_codes=codes(), k_scales=scales(),
                v_scales=scales(), slot_state=state, slot_bits=bits,
                block_table=table,
                buf_k=torch.randn((L, R_, G, H, D), generator=gen)
                .to(torch.bfloat16),
                buf_v=torch.randn((L, R_, G, H, D), generator=gen)
                .to(torch.bfloat16),
                buf_len=torch.tensor([0, G // 2, G][:R_], dtype=torch.int32))


def on(dev, tensors):
    return [t.to(dev) for t in tensors]


def assert_close(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("GQ,D,BS", [(4, 128, 16), (2, 32, 8), (8, 64, 16)])
def test_fused_decode_attention(card, GQ, D, BS):
    c = pool_case(torch.Generator().manual_seed(GQ), L=3, R_=3, H=2, GQ=GQ,
                  D=D, BS=BS, NB=6)
    n = ops.LAUNCHES["ct_paged_attention_fused"]
    got = ops.paged_decode_attention_fused(*on(card, c.values()))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ct_paged_attention_fused"] == n + 1
    assert_close(got, R.ct_paged_attention_fused_ref(*c.values()))


def test_fused_decode_attention_full_width(card):
    """K1 at the serve tick's shape (r1-llama-8b: L 32, H 8, GQ 4, D 128;
    4 slots, BS 16, NB 128, G 16), one launch for the whole tick."""
    c = pool_case(torch.Generator().manual_seed(32), L=32, R_=4, H=8, GQ=4,
                  D=128, BS=16, NB=128)
    c["buf_len"] = torch.tensor([0, 5, 16, 16], dtype=torch.int32)
    got = launched_once("ct_paged_attention_fused",
                        ops.paged_decode_attention_fused,
                        *on(card, c.values()))
    assert_close(got, R.ct_paged_attention_fused_ref(*c.values()))


@pytest.mark.parametrize("case", ["empty", "last_block_only", "all_evicted",
                                  "few_live", "buf_empty", "buf_full"])
def test_fused_decode_attention_edges_of_the_walk(card, case):
    """K1 where its warp-split walk has an edge: every table entry -1, one
    live block at the last entry, a mapped block whose slots are all
    EVICTED, two live blocks (fewer than its 4 warps), an empty and a full
    fp buffer; bits mixed 2/4/8 throughout."""
    c = pool_case(torch.Generator().manual_seed(6), L=2, R_=2, H=8, GQ=4,
                  D=128, BS=16, NB=128)
    st, tb = c["slot_state"], c["block_table"]
    if case in ("empty", "last_block_only", "all_evicted", "few_live"):
        tb.fill_(-1)
        st.zero_()
    if case == "last_block_only":
        tb[:, :, -1] = torch.tensor([[3, 7], [8, 1]])
        st[:, :, -1, 5] = 1
    elif case == "all_evicted":
        tb[:, :, 1] = torch.tensor([[3, 7], [8, 1]])
        st[:, :, 1] = 2
    elif case == "few_live":
        tb[:, :, 1:3] = torch.tensor([[[3, 4], [7, 9]], [[8, 2], [1, 0]]])
        st[:, :, 1:3, ::3] = 1
    elif case == "buf_empty":
        c["buf_len"].zero_()
    elif case == "buf_full":
        c["buf_len"].fill_(16)
    got = launched_once("ct_paged_attention_fused",
                        ops.paged_decode_attention_fused,
                        *on(card, c.values()))
    assert_close(got, R.ct_paged_attention_fused_ref(*c.values()))
    if case == "empty":
        assert float(got[:, 0].abs().max()) == 0.0        # buf_len[0] = 0


@pytest.mark.parametrize("GQ", [4, 64, 100, 512])
def test_batched_pool_attention_tiles_the_query_groups(card, GQ):
    c = pool_case(torch.Generator().manual_seed(GQ), L=1, R_=2, H=2, GQ=GQ,
                  D=128, BS=16, NB=5)
    args = [c["qh"][0], c["k_codes"][0], c["v_codes"][0], c["k_scales"][0],
            c["v_scales"][0], c["slot_state"][0], c["slot_bits"][0],
            c["block_table"][:, 0].contiguous()]
    got = ops.paged_decode_attention_batched(*on(card, args))
    torch.cuda.synchronize()
    assert_close(got, R.ct_paged_attention_batched_ref(*args))


def batched_args(c):
    return [c["qh"][0], c["k_codes"][0], c["v_codes"][0], c["k_scales"][0],
            c["v_scales"][0], c["slot_state"][0], c["slot_bits"][0],
            c["block_table"][:, 0].contiguous()]


def batched_f64(qh, k_codes, v_codes, k_scales, v_scales, slot_state,
                slot_bits, block_table, group=16):
    """K2's plain version (``ct_paged_attention_batched_ref``) evaluated in
    float64: the dequantized values are exact in f32, the scores, softmax
    and sums are not rounded to f32.  At NB 128 (2048 keys) the f32 plain
    version's own rounding of l (~50) reaches ~1e-4, so the full-width
    tests hold l to this evaluation at the same bar."""
    r, _, _, d = qh.shape
    n = slot_state.shape[1] * slot_state.shape[2]
    table = block_table.clamp_min(0).long()

    def deq(codes, scales):
        bits = slot_bits.reshape(r, n).to(torch.int32)[..., None, None]
        return Q.dequantize_by_bitcode(
            codes[table].reshape(r, n, *codes.shape[2:]),
            scales[table].reshape(r, n, *scales.shape[2:]).float(), bits,
            g=group).double()
    k, v = deq(k_codes, k_scales), deq(v_codes, v_scales)
    valid = (slot_state.reshape(r, n) == 1)[:, None, None, :]
    s = torch.einsum("rhgd,rnhd->rhgn", qh.double(), k) / d ** 0.5
    s = torch.where(valid, s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("rhgn,rnhd->rhgd", p / l.clamp_min(1e-30), v)
    return out.float(), m.float(), l.float()


def launched_once(name, fn, *args):
    """``fn(*args)`` synchronised, checking that it added exactly one to
    its kernel's launch count."""
    n = ops.LAUNCHES[name]
    got = fn(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == n + 1
    return got


@pytest.mark.parametrize("GQ", [512, 64, 4])
def test_batched_pool_attention_full_width(card, GQ):
    """K2 at r1-llama-8b's width (H 8, D 128, BS 16, NB 128) at the big
    chunk's, the g-chunk's and the single request's query-group sizes."""
    c = pool_case(torch.Generator().manual_seed(GQ), L=1, R_=1, H=8, GQ=GQ,
                  D=128, BS=16, NB=128)
    args = batched_args(c)
    got = launched_once("ct_paged_attention_batched",
                        ops.paged_decode_attention_batched, *on(card, args))
    assert_close(got[:2], R.ct_paged_attention_batched_ref(*args)[:2])
    assert_close(got, batched_f64(*args))


def aliased_tables(gen, L, NB, NP):
    """Block tables [4, L, NB] over NP >= 2 NB blocks that share physical
    blocks by construction, as prefix hits and COW sources do: slots 1 and
    2 map slot 0's first NB/4 blocks at the same positions, slot 3 maps
    slot 0's second half at its own first half; the rest is private or
    -1."""
    q, h = NB // 4, NB // 2
    none = torch.full((h,), -1, dtype=torch.long)
    rows = []
    for _ in range(L):
        perm = torch.randperm(NP, generator=gen)
        rows.append(torch.stack([
            perm[:NB], torch.cat([perm[:q], perm[NB:2 * NB - q]]),
            torch.cat([perm[:q], perm[2 * NB - q:2 * NB], none]),
            torch.cat([perm[h:NB], none])]))
    return torch.stack(rows, 1).to(torch.int32)


def oversubscribed_case(GQ, L=8):
    """The full-width pressure cell's pool (H 8, D 128, BS 16, budget 512
    so NB 64; a pool of half the 4 x NB worst case) with aliased tables and
    each slot's own metadata."""
    gen = torch.Generator().manual_seed(64 + GQ)
    c = pool_case(gen, L=L, R_=4, H=8, GQ=GQ, D=128, BS=16, NB=64, NP=128)
    c["block_table"] = aliased_tables(gen, L, 64, 128)
    c["slot_state"].masked_fill_(
        (c["block_table"] < 0).permute(1, 0, 2)[..., None], 0)
    c["buf_len"] = torch.tensor([0, 5, 16, 16], dtype=torch.int32)
    return c


def test_fused_decode_attention_on_an_oversubscribed_aliased_pool(card):
    """K1 where slots map the same physical blocks and the pool holds
    fewer blocks than 4 x NB (the pressure cell's tick)."""
    c = oversubscribed_case(GQ=4)
    got = launched_once("ct_paged_attention_fused",
                        ops.paged_decode_attention_fused,
                        *on(card, c.values()))
    assert_close(got, R.ct_paged_attention_fused_ref(*c.values()))


@pytest.mark.parametrize("GQ", [512, 64, 4])
def test_batched_pool_attention_on_an_oversubscribed_aliased_pool(card, GQ):
    """K2 on a slot whose table shares blocks with other slots, at NB 64 in
    a pool of 128 blocks, with its walk split (NS > 1) so the merge runs."""
    c = oversubscribed_case(GQ=GQ, L=1)
    assert ops.kv_splits(1, 8, GQ, 64, ops._sm_count(card.index or 0),
                         128) > 1
    args = [c["qh"][0, 1:2], c["k_codes"][0], c["v_codes"][0],
            c["k_scales"][0], c["v_scales"][0], c["slot_state"][0, 1:2],
            c["slot_bits"][0, 1:2], c["block_table"][1:2, 0].contiguous()]
    args = [a.contiguous() for a in args]
    got = launched_once("ct_paged_attention_batched",
                        ops.paged_decode_attention_batched, *on(card, args))
    assert_close(got[:2], R.ct_paged_attention_batched_ref(*args)[:2])
    assert_close(got, batched_f64(*args))


@pytest.mark.parametrize("case", ["empty", "last_block_only", "all_evicted",
                                  "ragged"])
def test_batched_pool_attention_edges_of_the_walk(card, case):
    """K2 where its live-block walk has an edge: every table entry -1, one
    live block at the last entry, a mapped block whose slots are all
    EVICTED, a ragged GQ (100: a partly filled 64-row tile)."""
    c = pool_case(torch.Generator().manual_seed(5), L=1, R_=2, H=8,
                  GQ=100 if case == "ragged" else 4, D=128, BS=16, NB=128)
    st, tb = c["slot_state"], c["block_table"]
    if case != "ragged":
        tb.fill_(-1)
        st.zero_()
    if case == "last_block_only":
        tb[:, 0, -1] = torch.tensor([3, 7])
        st[0, :, -1, 5] = 1
    elif case == "all_evicted":
        tb[:, 0, 1] = torch.tensor([3, 7])
        st[0, :, 1] = 2
    args = batched_args(c)
    got = launched_once("ct_paged_attention_batched",
                        ops.paged_decode_attention_batched, *on(card, args))
    assert_close(got[:2], R.ct_paged_attention_batched_ref(*args)[:2])
    assert_close(got, batched_f64(*args))
    if case in ("empty", "all_evicted"):
        assert float(got[1].max()) == float(np.float32(-1e30))
        assert float(got[2].abs().max()) == float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("S,n_valid,window", [
    (128, None, 0), (16, 1, 0), (16, 11, 0), (16, 16, 0), (200, None, 0),
    (128, None, 40)])
def test_prefill_attention_stats_full_width(card, S, n_valid, window):
    """K3 at r1-llama-8b's heads (Hq 32, H 8, D 128): the big chunk, the
    g-chunk with 1, 11 and 16 valid keys, a ragged S and a window."""
    gen = torch.Generator().manual_seed(S + (n_valid or 0))
    q = torch.randn((S, 32, 128), generator=gen)
    k = torch.randn((S, 8, 128), generator=gen)
    v = torch.randn((S, 8, 128), generator=gen)
    got = launched_once(
        "flash_prefill", lambda *a: ops.prefill_attention_stats(
            *a, window=window, n_valid=n_valid), *on(card, (q, k, v)))
    kv_valid = None if n_valid is None else torch.arange(S) < n_valid
    assert_close(got, R.flash_prefill_stats_ref(q, k, v, window=window,
                                                kv_valid=kv_valid))


@pytest.mark.parametrize("S,n_valid,window", [
    (128, None, 0), (16, 11, 0), (16, 1, 0), (200, None, 0),
    (128, None, 40), (8, 5, 0)])
def test_prefill_attention_stats(card, S, n_valid, window):
    gen = torch.Generator().manual_seed(S)
    q = torch.randn((S, 8, 128), generator=gen)
    k = torch.randn((S, 2, 128), generator=gen)
    v = torch.randn((S, 2, 128), generator=gen)
    got = ops.prefill_attention_stats(*on(card, (q, k, v)), window=window,
                                      n_valid=n_valid)
    torch.cuda.synchronize()
    kv_valid = None if n_valid is None else torch.arange(S) < n_valid
    assert_close(got, R.flash_prefill_stats_ref(q, k, v, window=window,
                                                kv_valid=kv_valid))


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_group_quant_bit_exact(card, bits):
    x = torch.randn((300, 128), generator=torch.Generator().manual_seed(bits))
    x[0, :16] *= 1e-4
    x[1, :16] *= 1e-6
    x[2, :16] = 0.0
    x[3, :16] *= 3000.0
    x[4, :16] = 448.0 * 127.0 * 1.5
    x[5, :16] = 448.0
    codes, scales = ops.tbq_group_quant(x.to(card), bits)
    torch.cuda.synchronize()
    rc, rs = R.group_quant_ref(x, bits)
    assert torch.equal(codes.cpu(), rc)
    assert torch.equal(scales.cpu().view(torch.int16), rs.view(torch.int16))


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.randn((64, 64), device=card)
    with pytest.raises(TypeError):
        ops.tbq_group_quant(x.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.tbq_group_quant(x.t(), 4)
    x = x[:8]
    with pytest.raises(ValueError, match="devices"):
        ops.prefill_attention_stats(x.view(8, 1, 64), x.cpu().view(8, 1, 64),
                                    x.view(8, 1, 64))


def test_engine_backends_agree_on_the_card(card):
    mcfg = dataclasses.replace(get_smoke_config("r1-llama-8b"), num_heads=8,
                               num_kv_heads=4, head_dim=32)
    tk = ThinKVConfig(refresh_interval=16, group_size=16, block_size=16,
                      token_budget=64, retention_schedule=(16, 8, 4))
    cfg = ServeConfig(model=mcfg, thinkv=tk, max_seqs=3)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mcfg.vocab_size, n) for n in (150, 40, 9)]
    params = init_params(mcfg, 0, card)
    runs = {}
    for backend in ("kernel", "reference"):
        ops.reset_launches()
        eng = ThinKVEngine(cfg, params=params, backend=backend, device=card,
                           record_logits=True)
        eng.submit(prompts, max_new_tokens=24)
        done = eng.run()
        runs[backend] = (eng, {r.arrival: r.output for r in done},
                         dict(ops.LAUNCHES))
    (ek, tk_, lk), (er, tr, lr) = runs["kernel"], runs["reference"]
    engine_kernels = ("ct_paged_attention_fused", "ct_paged_attention_batched",
                      "flash_prefill", "group_quant")
    assert all(lk[k] > 0 for k in engine_kernels), lk
    assert lk["mamba_scan"] == lk["ct_paged_attention"] == 0, lk
    assert lk["ct_paged_attention_fused"] == ek.metrics["ticks"]
    assert lr["ct_paged_attention_fused"] == 0
    assert tk_ == tr
    for a in er.request_logits:
        np.testing.assert_allclose(np.stack(ek.request_logits[a]),
                                   np.stack(er.request_logits[a]),
                                   rtol=0, atol=1e-3)
    assert ek.audit_pool() == er.audit_pool()


@pytest.mark.parametrize("lead,S,di,N", [
    ((), 64, 128, 16), ((3,), 100, 200, 16), ((2,), 1, 1, 16),
    ((), 37, 130, 8), ((4,), 300, 256, 16)])
def test_mamba_scan(card, lead, S, di, N):
    """K5, ragged S (not a multiple of the 16-step chunk) and di (not a
    multiple of the 32-channel block) included."""
    gen = torch.Generator().manual_seed(S + di)
    x = torch.randn(lead + (S, di), generator=gen)
    dt = 0.01 + 0.1 * torch.rand(lead + (S, di), generator=gen)
    b = torch.randn(lead + (S, N), generator=gen)
    c = torch.randn(lead + (S, N), generator=gen)
    a = -torch.exp(torch.randn((di, N), generator=gen))
    n = ops.LAUNCHES["mamba_scan"]
    got = ops.mamba_scan(*on(card, (x, dt, b, c, a)))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_scan"] == n + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), R.mamba_scan_ref(x, dt, b, c, a),
                               rtol=3e-4, atol=3e-4)


def test_mamba_scan_full_prefill_shape(card):
    """K5 at falcon-mamba-7b's prefill (B 4, S 1024, d_inner 8192, N 16),
    one launch for every batch row, against the plain scan on the card."""
    gen = torch.Generator(device=card).manual_seed(0)
    B, S, di, N = 4, 1024, 8192, 16
    x = torch.randn((B, S, di), generator=gen, device=card)
    dt = 0.01 + 0.1 * torch.rand((B, S, di), generator=gen, device=card)
    b = torch.randn((B, S, N), generator=gen, device=card)
    c = torch.randn((B, S, N), generator=gen, device=card)
    a = -torch.exp(torch.randn((di, N), generator=gen, device=card))
    got = launched_once("mamba_scan", ops.mamba_scan, x, dt, b, c, a)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, R.mamba_scan_ref(x, dt, b, c, a),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("GQ,D", [(1, 32), (4, 128), (4, 64), (1, 16),
                                  (4, 16), (8, 256)])
def test_single_request_wrapper(card, GQ, D):
    """The ``ct_paged_attention`` wrapper: physical metadata gathered
    through a shuffled raw table with -1 entries, one K2 launch."""
    gen = torch.Generator().manual_seed(GQ * D)
    c = pool_case(gen, L=1, R_=1, H=2, GQ=GQ, D=D, BS=16, NB=6)
    NP = c["k_codes"].shape[1]
    state = torch.randint(0, 3, (NP, 16), generator=gen).to(torch.uint8)
    bits = c["slot_bits"][0, 0][torch.randint(0, 6, (NP,), generator=gen)]
    table = c["block_table"][0, 0].clone()
    table[1] = -1
    state[table.clamp_min(0).long()[1]] = 1
    args = [c["qh"][0, 0].reshape(2 * GQ, D), c["k_codes"][0],
            c["v_codes"][0], c["k_scales"][0], c["v_scales"][0], state,
            bits.contiguous(), table]
    before = dict(ops.LAUNCHES)
    got = ops.paged_decode_attention(*on(card, args))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ct_paged_attention"] == \
        before["ct_paged_attention"] + 1
    assert ops.LAUNCHES["ct_paged_attention_batched"] == \
        before["ct_paged_attention_batched"]
    assert_close(got, R.ct_paged_attention_ref(*args))


def test_prefill_attention_without_stats(card):
    gen = torch.Generator().manual_seed(7)
    q = torch.randn((128, 8, 128), generator=gen)
    k = torch.randn((128, 2, 128), generator=gen)
    v = torch.randn((128, 2, 128), generator=gen)
    got = ops.prefill_attention(*on(card, (q, k, v)), window=40)
    torch.cuda.synchronize()
    assert_close(got, R.flash_prefill_ref(q, k, v, window=40))


def test_ssm_backends_agree_on_the_card(card):
    """The smoke falcon-mamba through K5 and through the plain scan, on the
    card: teacher-forced logits within the engine backends' bar."""
    cfg = get_smoke_config("falcon-mamba-7b")
    m = ssm_lm.init_params(cfg, 0, card)
    toks = torch.randint(0, cfg.vocab_size, (3, 50),
                         generator=torch.Generator().manual_seed(0)).to(card)
    n = ops.LAUNCHES["mamba_scan"]
    lk, _ = ssm_lm.logits_fn(m, {"tokens": toks}, cfg, backend="kernel")
    lr, _ = ssm_lm.logits_fn(m, {"tokens": toks}, cfg, backend="reference")
    assert ops.LAUNCHES["mamba_scan"] == n + cfg.num_layers
    torch.testing.assert_close(lk, lr, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("GQ,BS,H", [(1, 8, 8), (1, 16, 3), (2, 8, 8),
                                     (2, 16, 3), (4, 8, 3), (4, 16, 8),
                                     (8, 8, 3), (8, 16, 8)])
def test_fused_decode_attention_head_dim_16(card, GQ, BS, H):
    """K1 at head_dim 16 (the trace config's): one scale per pool row (its
    aligned word copied, the half picked by the element's parity, which
    moves from row to row at an odd H), and tiles of at most 4 query rows
    (GQ 8 takes two per (layer, slot, kv head)); one launch."""
    c = pool_case(torch.Generator().manual_seed(16 * GQ + BS + H), L=2,
                  R_=3, H=H, GQ=GQ, D=16, BS=BS, NB=6)
    got = launched_once("ct_paged_attention_fused",
                        ops.paged_decode_attention_fused,
                        *on(card, c.values()))
    assert_close(got, R.ct_paged_attention_fused_ref(*c.values()))


@pytest.mark.parametrize("GQ,NB,H", [(4, 1, 8), (4, 6, 3), (100, 6, 8),
                                     (64, 12, 3), (1, 6, 8)])
def test_batched_pool_attention_head_dim_16(card, GQ, NB, H):
    """K2 at head_dim 16, with one share (NB 1) and with the walk split
    over several blocks and merged (merge_splits_kernel, two rows per
    warp at D 16)."""
    c = pool_case(torch.Generator().manual_seed(GQ + NB + H), L=1, R_=2,
                  H=H, GQ=GQ, D=16, BS=8, NB=NB)
    args = batched_args(c)
    ns = ops.kv_splits(2, H, GQ, NB, ops._sm_count(0), 16)
    assert ns == 1 if NB == 1 else ns > 1
    got = launched_once("ct_paged_attention_batched",
                        ops.paged_decode_attention_batched, *on(card, args))
    assert_close(got, R.ct_paged_attention_batched_ref(*args))


def test_paged_wrappers_refuse_head_dims_without_an_instance(card):
    """K1 and K2 have instances for head_dim 16, 32, 64, 112, 128 and 256
    (K2's 112 since it gained one); 48 and 512 are refused by both."""
    for d in (48, 512):
        c = pool_case(torch.Generator().manual_seed(d), L=1, R_=1, H=2, GQ=2,
                      D=d, BS=8, NB=2)
        with pytest.raises(ValueError,
                           match="head_dim 16, 32, 64, 112, 128, 256"):
            ops.paged_decode_attention_fused(*on(card, c.values()))
        with pytest.raises(ValueError,
                           match="head_dim 16, 32, 64, 112, 128, 256"):
            ops.paged_decode_attention_batched(*on(card, batched_args(c)))


def commit_buffers(gen, L, G, H, D):
    """bf16 K/V buffers with groups whose amax falls in the E4M3 subnormal
    scale range, at zero, and at and past the 448 saturation edge."""
    x = torch.randn((2, L * G * H, D), generator=gen)
    x[:, 0, :16] *= 1e-4
    x[:, 1, :16] *= 1e-6
    x[:, 2, :16] = 0.0
    x[:, 3, :16] *= 3000.0
    x[:, 4, :16] = 448.0 * 127.0 * 1.5
    x[:, 5, :16] = 448.0
    x[1] *= 40.0
    return [a.reshape(L, G, H, D).to(torch.bfloat16) for a in x]


def same_quant(got, want):
    for g, w in zip(got, want):
        g = g.cpu()
        if w.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert torch.equal(g, w)


@pytest.mark.parametrize("D", (16, 128, 256))
@pytest.mark.parametrize("thought", (0, 1, 2))
@pytest.mark.parametrize("precision", [(2, 4, 4), (2, 4, 8), (8, 8, 8)])
def test_commit_quant_bit_exact(card, precision, thought, D):
    """A commit's quantization, one K4 launch reading the thought's width
    on the card, bit-exact to the plain version (every level quantized,
    the thought's selected): codes, scale bits and the bits."""
    from repro_torch.config import ThinKVConfig as TKC
    k, v = commit_buffers(torch.Generator().manual_seed(D + thought), L=3,
                          G=16, H=8, D=D)
    cfg = TKC(precision=precision)
    t = torch.tensor(thought, dtype=torch.int32)
    want = CT._quantize_group_by_thought(cfg, k, v, t)
    got = launched_once("group_quant", CT._quantize_group_by_thought, cfg,
                        k.to(card), v.to(card), t.to(card))
    same_quant(got, want)
    assert int(got[4]) == precision[thought]


def test_commit_quant_takes_the_first_level_for_other_bits(card):
    k, v = commit_buffers(torch.Generator().manual_seed(1), L=2, G=16, H=8,
                          D=128)
    for bits in (8, 3, 0, 4):
        b = torch.tensor(bits, dtype=torch.int32)
        got = launched_once("group_quant", ops.tbq_commit_quant, k.to(card),
                            v.to(card), b.to(card), (2, 4))
        same_quant(got, R.group_quant_commit_ref(k, v, b, (2, 4)))


def test_a_cuda_commit_is_one_group_quant_launch(card):
    """commit_group on the card: one K4 launch and no other kernel of the
    port; the pool and metadata it writes equal the CPU commit's."""
    tk = ThinKVConfig(group_size=16, block_size=16, precision=(2, 4, 8))
    dims = CT.make_dims(tk, 4, 8, 128)
    k, v = commit_buffers(torch.Generator().manual_seed(2), L=4, G=16, H=8,
                          D=128)
    out = {}
    for dev in (torch.device("cpu"), card):
        cache = CT.init_cache(dims, dev)
        view = CT.init_pool_view(dims, dims.NB, dev)
        cache.buf_k.copy_(k)
        cache.buf_v.copy_(v)
        cache.buf_len.fill_(16)
        cache.num_tokens.fill_(16)
        cache.cur_thought.fill_(1)
        before = dict(ops.LAUNCHES)
        CT.commit_group(tk, dims, cache, view)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[dev.type] = (cache, view, {n: ops.LAUNCHES[n] - before[n]
                                       for n in before})
    assert out["cuda"][2] == dict(out["cpu"][2], group_quant=1)
    assert not any(out["cpu"][2].values())
    same_quant(out["cuda"][1], out["cpu"][1])
    for f in ("slot_state", "slot_bits", "slot_pos", "block_type"):
        assert torch.equal(getattr(out["cuda"][0], f).cpu(),
                           getattr(out["cpu"][0], f)), f


def test_flash_trace_on_the_card_gives_the_jax_record(card):
    """The flash trace (head_dim 16, 8 kv heads, a 128-token big chunk,
    g-chunks, eviction and refresh) on the card with the JAX engine's
    parameters, held to the JAX reference engine's record
    (``tests/golden/torch_flash_trace.npz``, checked against the live
    engine on the CPU by ``tests/test_torch_trace_fixture.py``): identical
    tokens, per-request logits within 1e-3, equal counters and pool audit,
    on the kernel backend (K1 once per tick, K2, K3 and K4 launched, K4
    once per commit) and on the reference backend."""
    rec = TR.load(FLASH_RECORD)
    params = None
    for backend in ("kernel", "reference"):
        eng, done, launches = TR.replay(rec, backend, card, params)
        params = eng.model
        bad, worst = TR.mismatches(rec, eng, done)
        assert not bad, (backend, bad)
        assert launches["group_quant"] == TR.expected_commits(rec)
        if backend == "kernel":
            assert launches["ct_paged_attention_fused"] == \
                eng.metrics["ticks"] > 0
            assert all(launches[k] > 0 for k in (
                "ct_paged_attention_batched", "flash_prefill")), launches
        else:
            assert launches["ct_paged_attention_fused"] == 0


def test_pressure_trace_on_the_card_gives_the_jax_record(card):
    """The pressure trace (a 14-block pool for 3 slots, the prefix cache on:
    preemptions, resumes, prefix hits and COW faults, block tables that
    alias shared physical blocks) on the card with the JAX engine's
    parameters, held to the JAX reference engine's record
    (``tests/golden/torch_pressure_trace.npz``): identical tokens, logits
    within 1e-3, equal counters and pool audit, on the kernel backend (K1
    once per tick, K4 once per commit the run made) and on the reference
    backend."""
    rec = TR.load(PRESSURE_RECORD)
    params = None
    for backend in ("kernel", "reference"):
        eng, done, launches = TR.replay(rec, backend, card, params)
        params = eng.model
        bad, worst = TR.mismatches(rec, eng, done)
        assert not bad, (backend, bad)
        assert eng.metrics["preemptions"] > 0 and eng.metrics["cow_faults"] > 0
        assert launches["group_quant"] == eng.metrics["commits"] > 0
        assert launches["ct_paged_attention_fused"] == (
            eng.metrics["ticks"] if backend == "kernel" else 0)


def test_sampled_trace_on_the_card_gives_the_jax_record(card):
    """The pressure trace at temperature 0.7, top-p 0.9 and 8 ticks per
    dispatch on the card, held to the JAX reference engine's record
    (``tests/golden/torch_sampled_trace.npz``): identical sampled tokens,
    logits within 1e-3, equal counters (dispatches, early exits,
    preemptions among them) and pool audit, on the kernel backend (K1 once
    per tick, K4 once per commit) and on the reference backend.  The
    record's smallest draw margin lies above 1e-3 / T, so no draw can flip
    under the card's logit error."""
    rec = TR.load(SAMPLED_RECORD)
    assert rec["min_margin"] >= 1e-3 / rec["settings"]["temperature"]
    params = None
    for backend in ("kernel", "reference"):
        eng, done, launches = TR.replay(rec, backend, card, params)
        params = eng.model
        bad, worst = TR.mismatches(rec, eng, done)
        assert not bad, (backend, bad)
        m = eng.metrics
        assert m["dispatches"] < m["ticks"] and m["preemptions"] > 0
        assert launches["group_quant"] == m["commits"] > 0
        assert launches["ct_paged_attention_fused"] == (
            m["ticks"] if backend == "kernel" else 0)


def test_prng_on_the_card_equals_the_cpu(card):
    """Keys, 32-bit words and uniforms bit-exact on the card; the Gumbel
    noise within two ulps (the card's ``log``)."""
    from repro_torch.serving import prng
    keys = prng.split(prng.prng_key(7), 4)
    for f in (lambda k: prng.split(k, 3), lambda k: prng.fold_in(k, 5),
              lambda k: prng.random_bits(k, 128256),
              lambda k: prng.uniform(k, 128256, prng.TINY, 1.0)):
        assert torch.equal(f(keys.to(card)).cpu(), f(keys))
    g_cpu, g_dev = prng.gumbel(keys, 128256), \
        prng.gumbel(keys.to(card), 128256).cpu()
    ulp = torch.maximum(g_cpu.abs(), torch.ones(())) * 2.0 ** -23
    assert ((g_dev - g_cpu).abs() <= 2 * ulp).all()


@pytest.mark.parametrize("temperature,top_p", [(0.0, 1.0), (0.6, 1.0),
                                               (0.6, 0.95)])
def test_sample_slots_on_the_card_equals_the_cpu(card, temperature, top_p):
    """The engine's sampler on card tensors at [4, 128256] (greedy, T 0.6,
    T 0.6 with top-p 0.95): the CPU result's tokens and next keys for the
    same keys and logits."""
    from repro_torch.serving import prng
    from repro_torch.serving.engine import _sample_slots
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((4, 128256), generator=gen) * 3
    keys = prng.split(prng.prng_key(0), 4)
    want = _sample_slots(keys, logits, temperature, top_p)
    got = _sample_slots(keys.to(card), logits.to(card), temperature, top_p)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def fork_engine(dev, params):
    mcfg = get_smoke_config("r1-llama-8b")
    tk = ThinKVConfig(refresh_interval=16, group_size=8, block_size=8,
                      token_budget=48, retention_schedule=(16, 8, 4),
                      min_retention=4, max_segments=64, kmeans_iters=4)
    return ThinKVEngine(ServeConfig(model=mcfg, thinkv=tk, max_seqs=2,
                                    temperature=0.7),
                        params=params, backend="reference", device=dev,
                        allow_forks=True)


def test_fork_slot_on_the_card_equals_the_cpu(card):
    """A prefill into slot 0 and its fork into slot 1 on the card: the
    refcounts (every parent block + 1), tables, cache metadata, host
    mirrors, keys and fork counters equal the CPU engine's."""
    import copy
    params = init_params(get_smoke_config("r1-llama-8b"), 0, "cpu")
    prompt = np.random.default_rng(0).integers(0, 256, 24)
    out = {}
    for dev, p in (("cpu", params), (card, copy.deepcopy(params).to(card))):
        eng = fork_engine(dev, p)
        pre = eng.prefill(prompt, 0, arrival=0)
        eng.insert(pre, 0)
        before = eng.pool.refcount.cpu().clone()
        eng.fork_slot(0, 1, arrival=1)
        out[str(dev)] = (eng, before, pre.first_token)
    (ec, bc, tc), (ed, bd, td) = out["cpu"], out[str(card)]
    assert td == tc and torch.equal(bd, bc)
    assert torch.equal(ed.pool.refcount.cpu(), ec.pool.refcount)
    assert torch.equal(ed.tables.cpu(), ec.tables)
    assert torch.equal(ed.tables[1].cpu(), ed.tables[0].cpu())
    mapped = ec.tables[0] >= 0
    ids = ec.tables[0][mapped].long()
    layer = torch.arange(ec.dims.L)[:, None].expand_as(mapped)[mapped]
    assert (ec.pool.refcount[layer, ids] == bc[layer, ids] + 1).all()
    for f in ("slot_state", "slot_bits", "slot_pos", "block_type",
              "num_tokens", "buf_len"):
        assert torch.equal(getattr(ed.caches, f).cpu(),
                           getattr(ec.caches, f)), f
    assert torch.equal(ed._slot_keys.cpu(), ec._slot_keys)
    assert (ed._slot_ntok == ec._slot_ntok).all()
    assert (ed._feed == ec._feed).all()
    assert ed.metrics["forks"] == ec.metrics["forks"] == 1
    assert ed.metrics["peak_refcount"] == ec.metrics["peak_refcount"] == 2


def test_packs_of_eight_equal_single_ticks_on_the_card(card):
    """The kernel backend at smoke width on the card, sampled (T 0.7,
    top-p 0.9), four requests on three slots: 8 ticks per dispatch give the
    single-tick run's tokens and bit-identical logits in fewer dispatches;
    K1 launches once per tick in both."""
    mcfg = dataclasses.replace(get_smoke_config("r1-llama-8b"), num_heads=8,
                               num_kv_heads=4, head_dim=32)
    tk = ThinKVConfig(refresh_interval=16, group_size=16, block_size=16,
                      token_budget=64, retention_schedule=(16, 8, 4))
    cfg = ServeConfig(model=mcfg, thinkv=tk, max_seqs=3, temperature=0.7,
                      top_p=0.9)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mcfg.vocab_size, n) for n in (150, 40, 9, 30)]
    params = init_params(mcfg, 0, card)
    runs = {}
    for tpd in (1, 8):
        ops.reset_launches()
        eng = ThinKVEngine(cfg, params=params, backend="kernel", device=card,
                           record_logits=True, ticks_per_dispatch=tpd)
        eng.submit(prompts, max_new_tokens=40)
        done = eng.run()
        runs[tpd] = (eng, {r.arrival: r.output for r in done},
                     dict(ops.LAUNCHES))
        assert runs[tpd][2]["ct_paged_attention_fused"] == \
            eng.metrics["ticks"]
        eng.audit_pool()
    (e1, t1, _), (e8, t8, _) = runs[1], runs[8]
    assert t1 == t8
    for a, seq in e1.request_logits.items():
        np.testing.assert_array_equal(np.stack(seq),
                                      np.stack(e8.request_logits[a]))
    assert e8.metrics["dispatches"] < e8.metrics["ticks"]


@pytest.mark.parametrize("name", ["cow_ok", "cow_fail", "fresh_fail",
                                  "mixed", "no_dirty"])
def test_sync_block_tables_on_the_card_equals_the_cpu(card, name):
    """``sync_block_tables`` with a dirty mask on card tensors gives the CPU
    result (which ``tests/test_torch_pool.py`` holds to the JAX package)."""
    import test_torch_pool as TP
    case = TP.pool_case(name, 0)
    TP.assert_equal_trees(TP.port_sync(case, card), TP.port_sync(case), name)


@pytest.mark.parametrize("name", ["ok", "fail"])
def test_pool_ops_on_the_card_equal_the_cpu(card, name):
    """incref / release, ``cow_blocks``, extract -> restore and
    ``claim_blocks`` on card tensors give the CPU results; and
    ``changed_slots`` on the card."""
    import test_torch_pool as TP
    case = TP.pool_case(name, 3)
    TP.assert_equal_trees(TP.port_ops(case, card), TP.port_ops(case), name)
    rng = np.random.default_rng(0)
    old = TP.planes(rng, TP.DIMS["NB"])
    new = [p.copy() for p in old]
    new[2][0, 1, 2, 0, 0] ^= np.uint16(1)
    got = CT.changed_slots(*(CT.PoolView(*(TP.torch_of(p, card) for p in v))
                             for v in (old, new)))
    want = np.zeros(got.shape, bool)
    want[0, 1 * TP.DIMS["BS"] + 2] = True
    np.testing.assert_array_equal(got.cpu().numpy(), want)


POLICY_RECORDS = {name: os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "golden", f"torch_{name}_trace.npz")
    for name in ("rkv", "uniform")}


@pytest.mark.parametrize("name", sorted(POLICY_RECORDS))
def test_policy_traces_on_the_card_give_the_jax_records(card, name):
    """The pressure trace under the rkv and the uniform retention policy with
    the drift probe on, held to the JAX engine's records
    (``tests/golden/torch_{rkv,uniform}_trace.npz``): identical tokens,
    logits within 1e-3, equal counters and pool audit, each request's
    drift (steps and top-1 agreement equal, magnitudes within 2e-3), on
    the kernel backend (K1 once per tick, K4 once per commit) and on the
    reference backend."""
    rec = TR.load(POLICY_RECORDS[name])
    params = None
    for backend in ("kernel", "reference"):
        eng, done, launches = TR.replay(rec, backend, card, params)
        params = eng.model
        assert eng.policy.name == name
        bad, worst = TR.mismatches(rec, eng, done)
        assert not bad, (backend, bad)
        m = eng.metrics
        assert m["drift_probes"] == len(rec["prompts"])
        assert launches["group_quant"] == m["commits"] > 0
        assert launches["ct_paged_attention_fused"] == (
            m["ticks"] if backend == "kernel" else 0)


@pytest.mark.parametrize("name", ["rkv", "uniform"])
def test_policy_selection_on_the_card_equals_the_cpu(card, name):
    """``redundancy_select`` (rkv) and uniform's newest-first selection on
    card tensors: the CPU's masks, for every valid count and keep value
    (layer-batched as the anneal calls them)."""
    from repro_torch.core.policy import get_policy
    pol = get_policy(name)
    tk = ThinKVConfig()
    gen = torch.Generator().manual_seed(7)
    L, n, d = 8, 64, 1024
    x = torch.randn((L, n, d), generator=gen)
    for n_valid in (0, 1, 5, 40, 64):
        valid = torch.zeros((L, n), dtype=torch.bool)
        for li in range(L):
            valid[li, torch.randperm(n, generator=gen)[:n_valid]] = True
        keep = torch.randint(1, 70, (L,), generator=gen)
        want = pol.select_tokens(x, valid, keep, tk)
        got = pol.select_tokens(x.to(card), valid.to(card), keep.to(card),
                                tk)
        assert torch.equal(got.cpu(), want), n_valid
        assert torch.equal(want.sum(-1), torch.minimum(
            keep.clamp_min(1), valid.sum(-1).clamp_max(
                max(tk.retention_schedule) if name == "rkv" else n)))


def uniform_commit_buffers():
    return commit_buffers(torch.Generator().manual_seed(3), L=4, G=16, H=8,
                          D=128)


def test_uniform_single_level_commit_is_bit_exact(card):
    """Uniform's commit: one K4 launch at the single level (4,), bit-exact
    to ``group_quant_commit_ref`` for every thought type."""
    from repro_torch.core.policy import UniformPolicy
    k, v = uniform_commit_buffers()
    for thought in (0, 1, 2):
        t = torch.tensor(thought, dtype=torch.int32)
        got = launched_once("group_quant", CT._quantize_group_by_thought,
                            ThinKVConfig(), k.to(card), v.to(card),
                            t.to(card), UniformPolicy())
        want = R.group_quant_commit_ref(
            k, v, torch.tensor(4, dtype=torch.int32), (4,))
        same_quant(got[:4], want)
        assert int(got[4]) == 4


def thinkv_step_batch(gen, cfg, tk, B):
    """A ThinKV step's batch of B requests: random pool planes (codes,
    E4M3-valued scales, valid / evicted / free slots, bits 2, 4, 8), bf16
    buffers with buf_len 0 .. G - 1."""
    dims = CT.make_dims(tk, cfg.num_layers, cfg.num_kv_heads, cfg.head_dim)
    L, NB, BS, H, D, G = dims.L, dims.NB, dims.BS, dims.H, dims.D, dims.G
    shape = (B, L, NB, BS, H)
    u = torch.rand((B, L, dims.NS), generator=gen)
    return {
        "tokens": torch.randint(0, cfg.vocab_size, (B,), generator=gen),
        "positions": torch.randint(40, 400, (B,), generator=gen),
        "k_codes": torch.randint(0, 256, shape + (D,), generator=gen,
                                 dtype=torch.uint8),
        "v_codes": torch.randint(0, 256, shape + (D,), generator=gen,
                                 dtype=torch.uint8),
        "k_scales": Q.e4m3_round(torch.rand(shape + (D // 16,),
                                            generator=gen) * 0.04 + 0.004)
        .to(torch.bfloat16),
        "v_scales": Q.e4m3_round(torch.rand(shape + (D // 16,),
                                            generator=gen) * 0.04 + 0.004)
        .to(torch.bfloat16),
        "slot_state": torch.where(u < 0.6, 1, torch.where(u < 0.8, 2, 0))
        .to(torch.uint8),
        "slot_bits": torch.tensor([2, 4, 8], dtype=torch.uint8)[
            torch.randint(0, 3, (B, L, dims.NS), generator=gen)],
        "buf_k": torch.randn((B, L, G, H, D), generator=gen)
        .to(torch.bfloat16),
        "buf_v": torch.randn((B, L, G, H, D), generator=gen)
        .to(torch.bfloat16),
        "buf_len": torch.arange(B, dtype=torch.int32) * (G - 1) // max(
            B - 1, 1)}


@pytest.mark.parametrize("D", (16, 128))
def test_dense_thinkv_step_kernel_path_on_the_card(card, D):
    """The dense ThinKV decode step on ``backend="kernel"``: one K1 launch
    per layer for the whole batch, and the step's logits within 1e-4 of
    the same step on the CPU (K1's plain version), buffers within one bf16
    step, buf_len exact."""
    from repro_torch.serving import serve_step as SS
    cfg = dataclasses.replace(get_smoke_config("r1-llama-8b"),
                              num_heads=16, num_kv_heads=4, head_dim=D)
    tk = ThinKVConfig(token_budget=128)
    params = init_params(cfg, 0, "cpu")
    batch = thinkv_step_batch(torch.Generator().manual_seed(D), cfg, tk, 4)
    step = SS.make_decode_step_thinkv(cfg, tk, backend="kernel")
    want = step(params, batch)
    before = dict(ops.LAUNCHES)
    got = step(copy.deepcopy(params).to(card),
               {k: v.to(card) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ct_paged_attention_fused"] - \
        before["ct_paged_attention_fused"] == cfg.num_layers
    assert (got[0].cpu() - want[0]).abs().max() <= ATOL
    for g, w in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(g.cpu().float(), w.float(), rtol=2 ** -7,
                                   atol=0)
    assert torch.equal(got[3].cpu(), want[3])


ARCH_RECORDS = {name: os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "golden", f"torch_{name}_trace.npz")
    for name in ("moe", "qwen2", "vlm")}


@pytest.mark.parametrize("name", sorted(ARCH_RECORDS))
def test_arch_traces_on_the_card_give_the_jax_records(card, name):
    """The pressure trace on mixtral-8x7b's smoke config (MoE), on
    qwen2-7b's (non-zero qkv biases) and on paligemma-3b's (tied, scaled
    embeddings, GeGLU, one kv head), held to the JAX engine's records
    (``tests/golden/torch_{moe,qwen2,vlm}_trace.npz``): identical tokens,
    logits within 1e-3, equal counters and pool audit, on the kernel
    backend (K1 once per tick, K2 and K3 launched, K4 once per commit)
    and on the reference backend."""
    rec = TR.load(ARCH_RECORDS[name])
    params = None
    for backend in ("kernel", "reference"):
        eng, done, launches = TR.replay(rec, backend, card, params)
        params = eng.model
        bad, worst = TR.mismatches(rec, eng, done)
        assert not bad, (backend, bad)
        m = eng.metrics
        assert launches["group_quant"] == m["commits"] > 0
        assert launches["ct_paged_attention_fused"] == (
            m["ticks"] if backend == "kernel" else 0)
        assert (launches["flash_prefill"] > 0) == (backend == "kernel")


@pytest.mark.parametrize("H", [4, 8])
@pytest.mark.parametrize("GQ", [5, 7, 8, 12])
def test_paged_attention_at_the_new_query_groups(card, GQ, H):
    """K1 and K2 at D 128 with the query-group sizes of this slice's
    configs (llama4-scout 5, qwen2-7b 7, yi 8, mistral-large 12): K1 tiles
    query rows 8 at a time, so 5, 7 and 12 take partial tiles; K2 at the
    g-chunk's and the big chunk's folded GQ (16 and 128 queries)."""
    c = pool_case(torch.Generator().manual_seed(100 * GQ + H), L=3, R_=3,
                  H=H, GQ=GQ, D=128, BS=16, NB=12)
    got = launched_once("ct_paged_attention_fused",
                        ops.paged_decode_attention_fused,
                        *on(card, c.values()))
    assert_close(got, R.ct_paged_attention_fused_ref(*c.values()))
    for rows in (16, 128):
        c = pool_case(torch.Generator().manual_seed(rows * GQ + H), L=1,
                      R_=1, H=H, GQ=rows * GQ, D=128, BS=16, NB=12)
        args = batched_args(c)
        got = launched_once("ct_paged_attention_batched",
                            ops.paged_decode_attention_batched,
                            *on(card, args))
        assert_close(got[:2], R.ct_paged_attention_batched_ref(*args)[:2])
        assert_close(got, batched_f64(*args))


@pytest.mark.parametrize("S,n_valid", [(128, None), (16, 11)])
def test_prefill_attention_stats_at_qwen2_grouping(card, S, n_valid):
    """K3 at qwen2-7b's heads (Hq 28, H 4: 7 q heads per kv head), D 128,
    the big chunk and a ragged g-chunk."""
    gen = torch.Generator().manual_seed(700 + S)
    q = torch.randn((S, 28, 128), generator=gen)
    k = torch.randn((S, 4, 128), generator=gen)
    v = torch.randn((S, 4, 128), generator=gen)
    got = launched_once(
        "flash_prefill", lambda *a: ops.prefill_attention_stats(
            *a, n_valid=n_valid), *on(card, (q, k, v)))
    kv_valid = None if n_valid is None else torch.arange(S) < n_valid
    assert_close(got, R.flash_prefill_stats_ref(q, k, v, kv_valid=kv_valid))


@pytest.mark.parametrize("GQ,H", [(1, 1), (2, 2), (4, 1), (8, 1), (5, 2)])
def test_fused_decode_attention_head_dim_256(card, GQ, H):
    """K1 at head_dim 256 (a key row over a whole warp) with 1, 2, 4 and 8
    query rows per tile and a partial tile (GQ 5), one launch."""
    c = pool_case(torch.Generator().manual_seed(256 + 10 * GQ + H), L=3,
                  R_=3, H=H, GQ=GQ, D=256, BS=16, NB=12)
    got = launched_once("ct_paged_attention_fused",
                        ops.paged_decode_attention_fused,
                        *on(card, c.values()))
    assert_close(got, R.ct_paged_attention_fused_ref(*c.values()))


def test_fused_decode_attention_paligemma_tick(card):
    """K1 at paligemma-3b's tick (L 18, 4 slots, one kv head, GQ 8, D 256;
    BS 16, NB 128, G 16), one launch for the whole tick."""
    c = pool_case(torch.Generator().manual_seed(18), L=18, R_=4, H=1, GQ=8,
                  D=256, BS=16, NB=128)
    c["buf_len"] = torch.tensor([0, 5, 16, 16], dtype=torch.int32)
    got = launched_once("ct_paged_attention_fused",
                        ops.paged_decode_attention_fused,
                        *on(card, c.values()))
    assert_close(got, R.ct_paged_attention_fused_ref(*c.values()))


@pytest.mark.parametrize("GQ,NB", [(1024, 128), (128, 128), (8, 128),
                                   (8, 1), (100, 6)])
def test_batched_pool_attention_head_dim_256(card, GQ, NB):
    """K2 at head_dim 256 (two column slices of 128 per row tile) at
    paligemma-3b's big chunk (GQ 1024), g-chunk (128) and single request
    (8) over its full pool (NB 128; l also against the f64 evaluation),
    with one share and no merge (NB 1), and a ragged row tile."""
    c = pool_case(torch.Generator().manual_seed(GQ + NB), L=1, R_=1, H=1,
                  GQ=GQ, D=256, BS=16, NB=NB)
    args = batched_args(c)
    ns = ops.kv_splits(1, 1, GQ, NB, ops._sm_count(0), 256)
    assert ns == 1 if NB == 1 else ns > 1
    got = launched_once("ct_paged_attention_batched",
                        ops.paged_decode_attention_batched, *on(card, args))
    assert_close(got[:2], R.ct_paged_attention_batched_ref(*args)[:2])
    assert_close(got, batched_f64(*args))


@pytest.mark.parametrize("S,n_valid,window,Hq,H", [
    (128, None, 0, 8, 1), (16, 11, 0, 8, 1), (16, 1, 0, 8, 1),
    (200, None, 0, 8, 1), (128, None, 40, 8, 1), (64, None, 0, 16, 2)])
def test_prefill_attention_stats_head_dim_256(card, S, n_valid, window, Hq,
                                              H):
    """K3 at head_dim 256 (two column slices of 128): paligemma-3b's heads
    (Hq 8, H 1) at the big chunk, the g-chunk with 11 and 1 valid keys, a
    ragged S and a window, and two kv heads."""
    gen = torch.Generator().manual_seed(256 + S + (n_valid or 0) + window)
    q = torch.randn((S, Hq, 256), generator=gen)
    k = torch.randn((S, H, 256), generator=gen)
    v = torch.randn((S, H, 256), generator=gen)
    got = launched_once(
        "flash_prefill", lambda *a: ops.prefill_attention_stats(
            *a, window=window, n_valid=n_valid), *on(card, (q, k, v)))
    kv_valid = None if n_valid is None else torch.arange(S) < n_valid
    assert_close(got, R.flash_prefill_stats_ref(q, k, v, window=window,
                                                kv_valid=kv_valid))


def test_vlm_serve_steps_on_the_card(card):
    """paligemma-3b's smoke config widened to head_dim 256 (4 q / 1 kv
    head) through the three serve steps on the card against the same
    steps on the CPU: the prefill step over a 4-patch image prefix and
    the text, one FullKV step and one ThinKV step on ``backend="kernel"``
    (one K1 launch per layer, at D 256) past the prefix; logits within
    1e-4, buf_len exact.  The new buffer rows of layer 0 are within one
    bf16 step; deeper layers' rows take their inputs from K1's output,
    which is held to its plain version at 1e-4, so they are held within
    one bf16 step plus that bar."""
    from repro_torch.models import lm
    from repro_torch.serving import serve_step as SS
    cfg = dataclasses.replace(get_smoke_config("paligemma-3b"), head_dim=256)
    tk = ThinKVConfig(token_budget=128)
    params = init_params(cfg, 0, "cpu")
    dev_params = copy.deepcopy(params).to(card)
    gen = torch.Generator().manual_seed(256)
    P, B = cfg.num_image_tokens, 4
    pre = {"tokens": torch.randint(0, cfg.vocab_size, (B, 40), generator=gen),
           "patches": torch.randn((B, P, cfg.frontend_dim), generator=gen)}
    step = SS.make_prefill_step(None, cfg)
    want = step(params, pre)
    got = step(dev_params, {k: v.to(card) for k, v in pre.items()})
    assert (got.cpu() - want).abs().max() <= ATOL
    _, kc, vc = lm.prefill(params, pre, cfg)
    clen = torch.tensor([P + 40, P + 31, P + 9, P + 40], dtype=torch.int32)
    full = {"tokens": torch.randint(0, cfg.vocab_size, (B,), generator=gen),
            "positions": clen.clone(),
            "k_cache": torch.cat([kc.transpose(0, 1), torch.zeros(
                (B, cfg.num_layers, 8, 1, 256))], 2),
            "v_cache": torch.cat([vc.transpose(0, 1), torch.zeros(
                (B, cfg.num_layers, 8, 1, 256))], 2), "cache_len": clen}
    step = SS.make_decode_step_fullkv(cfg)
    want = step(params, full)
    got = step(dev_params, {k: v.to(card) for k, v in full.items()})
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max() <= ATOL
    batch = thinkv_step_batch(gen, cfg, tk, B)
    batch["positions"] += P
    step = SS.make_decode_step_thinkv(cfg, tk, backend="kernel")
    want = step(params, batch)
    before = dict(ops.LAUNCHES)
    got = step(dev_params, {k: v.to(card) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ct_paged_attention_fused"] - \
        before["ct_paged_attention_fused"] == cfg.num_layers
    assert (got[0].cpu() - want[0]).abs().max() <= ATOL
    for g, w in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(g[:, 0].cpu().float(), w[:, 0].float(),
                                   rtol=2 ** -7, atol=0)
        torch.testing.assert_close(g.cpu().float(), w.float(), rtol=2 ** -7,
                                   atol=ATOL)
    assert torch.equal(got[3].cpu(), want[3])


@pytest.mark.parametrize("GQ,H,BS", [(1, 3, 16), (1, 4, 16), (1, 1, 4),
                                     (2, 5, 16), (4, 7, 8), (8, 2, 16)])
def test_fused_decode_attention_head_dim_112(card, GQ, H, BS):
    """K1 at head_dim 112 (zamba2-7b's: a key row over a warp of which 28
    lanes hold dimensions; 7 scale groups a row, so a head's scales start
    2-byte aligned at odd heads, and at H 1 every other row) over odd and
    even kv head counts, bits 2/4/8, 1-8 query rows per tile; slot 0 of
    layer 0 a fully masked row (pool masked, buffer empty: output 0)."""
    c = pool_case(torch.Generator().manual_seed(112 + 10 * GQ + H), L=3,
                  R_=3, H=H, GQ=GQ, D=112, BS=BS, NB=6)
    c["slot_state"][0, 0] = 0
    got = launched_once("ct_paged_attention_fused",
                        ops.paged_decode_attention_fused,
                        *on(card, c.values()))
    assert_close(got, R.ct_paged_attention_fused_ref(*c.values()))
    assert float(got[0, 0].abs().max()) == 0.0


def test_fused_decode_attention_zamba2_serve_step(card):
    """K1 at zamba2-7b's ThinKV serve step (one launch per shared-block
    invocation: L 1, 4 requests, 32 kv heads, GQ 1, D 112; BS 16, NB
    128)."""
    c = pool_case(torch.Generator().manual_seed(7112), L=1, R_=4, H=32,
                  GQ=1, D=112, BS=16, NB=128)
    c["buf_len"] = torch.tensor([1, 6, 16, 16], dtype=torch.int32)
    got = launched_once("ct_paged_attention_fused",
                        ops.paged_decode_attention_fused,
                        *on(card, c.values()))
    assert_close(got, R.ct_paged_attention_fused_ref(*c.values()))


@pytest.mark.parametrize("GQ,H,NB", [(1, 32, 128), (2, 32, 128), (1, 3, 6),
                                     (2, 5, 1), (16, 1, 6)])
def test_batched_pool_attention_head_dim_112(card, GQ, H, NB):
    """K2 at head_dim 112 (7 scale groups a row: a (slot, head) row's
    scales start 2-byte aligned at every other row; the merge folds 28
    lanes of 4 columns in a 32-lane warp): zamba2-7b's shared block (32 kv
    heads, GQ 1 as zamba2 serves it, and 2) over a full pool (NB 128: split
    and merged; l also against the f64 evaluation), odd head counts, one
    share and no merge (NB 1), and a ragged row tile (GQ 16 at H 1)."""
    c = pool_case(torch.Generator().manual_seed(1120 + 10 * GQ + H + NB),
                  L=1, R_=2, H=H, GQ=GQ, D=112, BS=16, NB=NB)
    args = batched_args(c)
    got = launched_once("ct_paged_attention_batched",
                        ops.paged_decode_attention_batched, *on(card, args))
    assert_close(got[:2], R.ct_paged_attention_batched_ref(*args)[:2])
    assert_close(got, batched_f64(*args))


@pytest.mark.parametrize("S,n_valid,Hq,H", [
    (128, None, 32, 32), (16, 11, 32, 32), (128, None, 4, 2),
    (16, 11, 4, 2), (200, None, 2, 1), (16, 1, 4, 2)])
def test_prefill_attention_stats_head_dim_112(card, S, n_valid, Hq, H):
    """K3 at head_dim 112: zamba2-7b's shared block (32 q / 32 kv heads) at
    a big chunk (S 128) and a g-chunk (S 16 with 11 valid keys), GQ 2 at
    both, a ragged S and a chunk with one valid key."""
    gen = torch.Generator().manual_seed(112 + S + Hq + (n_valid or 0))
    q = torch.randn((S, Hq, 112), generator=gen)
    k = torch.randn((S, H, 112), generator=gen)
    v = torch.randn((S, H, 112), generator=gen)
    got = launched_once(
        "flash_prefill", lambda *a: ops.prefill_attention_stats(
            *a, n_valid=n_valid), *on(card, (q, k, v)))
    kv_valid = None if n_valid is None else torch.arange(S) < n_valid
    assert_close(got, R.flash_prefill_stats_ref(q, k, v, kv_valid=kv_valid))


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_quantization_extras_on_the_card_equal_the_cpu(card, bits):
    """The KIVI per-channel baseline, per-tensor FP8 and the packing on
    card tensors bit-equal to their CPU results (plain torch on both
    devices: no kernel)."""
    gen = torch.Generator().manual_seed(bits)
    x = torch.randn((16, 128), generator=gen) * 3
    x[:, 0] *= 1e-6
    x[:, 1] = 0.0
    c, s = Q.quantize_per_channel(x, bits)
    cd, sd = Q.quantize_per_channel(x.to(card), bits)
    assert torch.equal(cd.cpu(), c) and torch.equal(
        sd.cpu().view(torch.int32), s.view(torch.int32))
    assert torch.equal(Q.dequantize_per_channel(cd, sd, bits).cpu(),
                       Q.dequantize_per_channel(c, s, bits))
    f, fs = Q.quantize_fp8(x * 10 ** bits)
    fd, fsd = Q.quantize_fp8((x * 10 ** bits).to(card))
    assert torch.equal(fd.cpu().view(torch.uint8), f.view(torch.uint8))
    assert torch.equal(fsd.cpu().view(torch.int32), fs.view(torch.int32))
    assert torch.equal(Q.dequantize_fp8(fd, fsd).cpu(), Q.dequantize_fp8(f, fs))
    codes = torch.randint(0, 256, (4, 3, 64), generator=gen,
                          dtype=torch.uint8)
    for pack, unpack in ((Q.pack_nibbles, Q.unpack_nibbles),
                         (Q.pack_ternary, Q.unpack_ternary)):
        p = pack(codes)
        pd = pack(codes.to(card))
        assert torch.equal(pd.cpu(), p)
        assert torch.equal(unpack(pd).cpu(), unpack(p))


def load_example(name):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"examples_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_the_card_gives_the_cpu_numbers(card):
    """``examples/quickstart_torch.py`` on the card: its commits go through
    K4 and its decode read through K2 (the single-request wrapper), and it
    gives the CPU run's numbers (integers equal, codes and scales
    bit-exact, floats within 1e-5)."""
    qs = load_example("quickstart_torch")
    want = qs.main(["--device", "cpu"])
    ops.reset_launches()
    got = qs.main([])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["group_quant"] > 0
    assert ops.LAUNCHES["ct_paged_attention"] == 1
    for key in ("retained", "seg_types", "shared", "cow_ok"):
        assert got[key] == want[key], key
    for key in ("codes", "scales", "refcount"):
        assert torch.equal(got[key].cpu(), want[key]), key
    for t, w in zip(got["tables"], want["tables"]):
        assert torch.equal(t.cpu(), w)
    for key in ("rel_rmse", "avg_bits", "footprint_frac"):
        assert abs(got[key] - want[key]) <= 1e-5, key
    torch.testing.assert_close(got["out"].cpu(), want["out"], rtol=0,
                               atol=1e-5)


def test_calibration_on_the_card_gives_the_cpu_numbers(card):
    cal = load_example("calibrate_thoughts_torch")
    want = cal.main(["--device", "cpu"])
    got = cal.main([])
    assert got["result"] == want["result"]
    assert (got["pred"] == want["pred"]).all()
    assert got["accuracy"] == want["accuracy"]


@pytest.mark.parametrize("argv", [[], ["--stream"], ["--samples", "2"],
                                  ["--ticks-per-dispatch", "4"]],
                         ids=["batch", "stream", "samples2", "tpd4"])
def test_serve_reasoning_on_the_card_gives_the_cpu_tokens(card, argv):
    """``examples/serve_reasoning_torch.py`` at its default sizes on the
    card's kernel backend (K1 once per tick, K2 and K3 per prefill chunk
    and layer, K4 per commit) gives the tokens of the CPU's reference
    backend, with the same weights on both (made on the CPU from the
    config's seed: a generator on the card draws other numbers)."""
    sr = load_example("serve_reasoning_torch")
    mc = get_smoke_config("r1-llama-8b")
    params = init_params(mc, ServeConfig(model=mc).seed, "cpu")
    want, _ = sr.main(["--device", "cpu"] + argv, params=params)
    ops.reset_launches()
    got, eng = sr.main(argv, params=copy.deepcopy(params).to(card))
    torch.cuda.synchronize()
    assert eng.backend == "kernel"
    for name in ("ct_paged_attention_fused", "ct_paged_attention_batched",
                 "flash_prefill", "group_quant"):
        assert ops.LAUNCHES[name] > 0, name
    assert {r.uid: list(r.output) for r in got} == \
        {r.uid: list(r.output) for r in want}


@pytest.mark.parametrize("name", ["hybrid", "encdec"])
def test_steps_records_on_the_card_give_the_jax_records(card, name):
    """The hybrid (zamba2 smoke form with a tail, head_dim 112) and encdec
    (whisper smoke form) records of the JAX serve steps replayed on the
    card's kernel backend: prefill and FullKV logits within 1e-4, the 8
    chained ThinKV steps within 1e-3 of JAX's Pallas-kernel backend with
    one K1 launch per attention layer and step, the final buffers within
    one bf16 step, buf_len exact (``test_torch_steps_record.replay``)."""
    import test_torch_steps_record as SR
    rec = SR.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "golden", f"torch_{name}_steps.npz"))
    res = SR.replay(rec, "kernel", card)
    assert not res["failed"], res
    cfg = SR.config(rec["settings"])
    assert res["k1_launches"] == \
        cfg.num_attention_layers() * rec["thinkv_tokens"].shape[0]


# ----------------------------------------------------------------------
# single-card training


def test_train_record_on_the_card_gives_the_jax_record(card):
    """The JAX train record (4 steps of r1-llama-8b's and mixtral-8x7b's
    smoke forms) replayed by the port's train step on the card: losses,
    grad norms, learning rates and per-parameter digests within 1e-4
    relative, launching no kernel (``test_torch_train_record``)."""
    import test_torch_train_record as TRR
    rec = TRR.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "golden", "torch_train_steps.npz"))
    before = dict(ops.LAUNCHES)
    assert TRR.mismatches(rec, TRR.replay(rec, card)) == []
    assert ops.LAUNCHES == before


def test_trainer_resumes_on_the_card(card, tmp_path):
    """A smoke run on the card that fails at step 5 and resumes from its
    step-4 checkpoint ends on the uninterrupted run's last loss within
    1e-4 relative."""
    from repro_torch.config import OptimizerConfig, TrainConfig
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.ft.failures import FailureInjector, InjectedFailure
    from repro_torch.training.trainer import Trainer
    m = get_smoke_config("yi-6b")
    cfg = TrainConfig(model=m, optimizer=OptimizerConfig(
        lr=1e-3, warmup_steps=2, decay_steps=8), seq_len=16,
        global_batch=4, steps=8, checkpoint_every=2, keep_checkpoints=2,
        checkpoint_dir=str(tmp_path / "ckpt"))

    def data_fn(start):
        it = lm_batches(m.vocab_size, 4, 16, seed=7)
        for _ in range(start):
            next(it)
        return it
    ref = Trainer(dataclasses.replace(cfg, checkpoint_dir=str(
        tmp_path / "ref")), data_fn, device=card).run()
    with pytest.raises(InjectedFailure):
        Trainer(cfg, data_fn, failure_injector=FailureInjector(
            fail_at_steps=(5,)), device=card).run()
    res = Trainer(cfg, data_fn, device=card).run()
    assert (res.resumed_from, res.final_step) == (4, 8)
    np.testing.assert_allclose(res.losses[-1], ref.losses[-1], rtol=1e-4)


# ----------------------------------------------------------------------
# tensor-parallel serving: a launch over one rank's share of the kv heads
# ----------------------------------------------------------------------


def rank_share(t, dim, r, n=2):
    return ops.local_heads(t, dim, r, n).contiguous()


@pytest.mark.parametrize("r", [0, 1])
def test_k1_over_half_the_heads_is_that_half_of_the_full_launch(card, r):
    """K1 at the serve tick's shape (r1-llama-8b: L 32, R 4, H 8, GQ 4, D
    128, NB 128) over kv heads [4r, 4r + 4) equals that share of the
    8-head launch bit for bit: no choice of the launch depends on H."""
    c = pool_case(torch.Generator().manual_seed(32), L=32, R_=4, H=8, GQ=4,
                  D=128, BS=16, NB=128)
    c["buf_len"] = torch.tensor([0, 5, 16, 16], dtype=torch.int32)
    full = ops.paged_decode_attention_fused(*on(card, c.values()))
    heads = {"qh": 2, "k_codes": 3, "v_codes": 3, "k_scales": 3,
             "v_scales": 3, "buf_k": 3, "buf_v": 3}
    part = launched_once("ct_paged_attention_fused",
                         ops.paged_decode_attention_fused,
                         *on(card, [rank_share(v, heads[k], r)
                                    if k in heads else v
                                    for k, v in c.items()]))
    assert torch.equal(part, rank_share(full, 2, r))


def batched_share(args, r):
    """K2's arguments (``batched_args``) for rank ``r``'s 4 of 8 heads."""
    qh, kc, vc, ks, vs, *meta = args
    return [rank_share(qh, 1, r), *(rank_share(p, 2, r)
                                    for p in (kc, vc, ks, vs)), *meta]


@pytest.mark.parametrize("r", [0, 1])
@pytest.mark.parametrize("GQ", [512, 64])
def test_k2_with_split_heads_over_half_the_heads_is_that_half(card, GQ, r):
    """K2 at r1-llama-8b's big chunk (GQ 512) and g-chunk (GQ 64) over 4
    of its 8 kv heads, told the model's 8 (``split_heads``): every head's
    walk is split as in the 8-head launch, so out, m and l equal that
    share of it bit for bit."""
    c = pool_case(torch.Generator().manual_seed(GQ), L=1, R_=1, H=8, GQ=GQ,
                  D=128, BS=16, NB=128)
    args = on(card, batched_args(c))
    full = ops.paged_decode_attention_batched(*args)
    part = launched_once(
        "ct_paged_attention_batched",
        lambda *a: ops.paged_decode_attention_batched(*a, split_heads=8),
        *batched_share(args, r))
    for p, f in zip(part, full):
        assert torch.equal(p, rank_share(f, 1, r))


def test_k2_without_split_heads_differs_over_half_the_heads(card):
    """The trap ``split_heads`` closes: at the big chunk a launch over 4
    kv heads sized its own split count (8 shares of each walk where the
    8-head launch cuts 4), so the merge adds other partial sums and the
    output differs from that share of the 8-head launch."""
    c = pool_case(torch.Generator().manual_seed(512), L=1, R_=1, H=8,
                  GQ=512, D=128, BS=16, NB=128)
    args = on(card, batched_args(c))
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert ops.kv_splits(1, 4, 512, 128, sms, 128) != \
        ops.kv_splits(1, 8, 512, 128, sms, 128)
    full = ops.paged_decode_attention_batched(*args)
    part = ops.paged_decode_attention_batched(*batched_share(args, 0))
    torch.cuda.synchronize()
    assert not torch.equal(part[0], rank_share(full[0], 1, 0))
    assert_close(part[:2], tuple(rank_share(f, 1, 0).cpu()
                                 for f in full[:2]))


@pytest.mark.parametrize("r", [0, 1])
@pytest.mark.parametrize("S,n_valid", [(128, None), (16, 11)])
def test_k3_over_half_the_heads_is_that_half_of_the_full_launch(card, S,
                                                                n_valid, r):
    """K3 at r1-llama-8b's heads (Hq 32 / H 8, D 128), the big chunk and a
    g-chunk with 11 valid keys, over 16 / 4 of them equals that share of
    the full launch bit for bit."""
    gen = torch.Generator().manual_seed(S)
    q = torch.randn((S, 32, 128), generator=gen)
    k = torch.randn((S, 8, 128), generator=gen)
    v = torch.randn((S, 8, 128), generator=gen)
    q, k, v = on(card, (q, k, v))
    full = ops.prefill_attention_stats(q, k, v, n_valid=n_valid)
    part = launched_once(
        "flash_prefill",
        lambda *a: ops.prefill_attention_stats(*a, n_valid=n_valid),
        *(rank_share(t, 1, r) for t in (q, k, v)))
    for p, f in zip(part, full):
        assert torch.equal(p, rank_share(f, 1, r))


# ----------------------------------------------------------------------
# the RetraceGuard where a build can happen: a fresh process on the card
# ----------------------------------------------------------------------


def retrace_child(mesh, steady_first):
    """A smoke engine (8 q / 4 kv heads) under the guard in a fresh
    process, which has built or loaded no kernel library yet (a
    module-level function: the rank imports it).  A warm batch, then a
    steady phase of staggered prefix-sharing arrivals over an
    oversubscribed pool; with ``steady_first`` warmup is declared over
    before the first launch.  Returns the build counter at each stage, the
    guard's report and what ``assert_steady_state`` raised."""
    from repro_torch.analysis import RetraceGuard, RetraceViolation
    from repro_torch.kernels import build
    from repro_torch.launch.audit import _stream
    builds = [build.BUILDS]
    mc = dataclasses.replace(get_smoke_config("r1-llama-8b"), num_heads=8,
                             num_kv_heads=4)
    tk = ThinKVConfig(refresh_interval=16, group_size=8, block_size=8,
                      token_budget=48, retention_schedule=(16, 8, 4),
                      min_retention=4, max_segments=64, kmeans_iters=4)
    eng = ThinKVEngine(ServeConfig(model=mc, thinkv=tk, max_seqs=3,
                                   temperature=0.0),
                       backend="kernel", device=mesh.device,
                       prefix_cache=True, pool_blocks=20,
                       ticks_per_dispatch=1)
    rng = np.random.default_rng(0)
    raised = ""
    with RetraceGuard(eng) as guard:
        if steady_first:
            guard.mark_steady()
        _stream(eng, [rng.integers(0, 256, 12) for _ in range(2)], 8)
        builds.append(build.BUILDS)
        guard.mark_steady()
        shared = rng.integers(0, 256, 16)
        _stream(eng, [np.concatenate([shared, rng.integers(0, 256, 4)])
                      for _ in range(5)], 16, 2)
        builds.append(build.BUILDS)
        try:
            guard.assert_steady_state()
        except RetraceViolation as e:
            raised = str(e)
        return {"builds": builds, "report": guard.report(),
                "raised": raised}


@pytest.mark.parametrize("steady_first", [False, True],
                         ids=["warm", "cold"])
def test_retrace_guard_in_a_fresh_process(card, steady_first):
    """In a process of its own the port builds or loads its kernel
    libraries once, at the first launch: after a warm batch the counter is
    1 and the steady phase leaves it there, so the guard passes; a process
    whose first launch comes after ``mark_steady`` fails it, naming the
    entry point and its first call."""
    from repro_torch.launch import mesh as M
    res, = M.run_ranks(retrace_child, 1, "cuda", steady_first, timeout=600)
    assert res["builds"] == [0, 1, 1]
    events = res["report"]["events"]
    assert len(events) == 1 and events[0]["call_index"] == 1
    assert events[0]["steady"] is steady_first
    assert res["report"]["steady_retraces"] == int(steady_first)
    if steady_first:
        assert f"{events[0]['entry']} built a kernel library at its call " \
            "#1" in res["raised"]
    else:
        assert res["raised"] == ""


def gloo_helpers_rank(mesh) -> dict:
    """Every collective helper of ``distributed/sharding.py`` on card
    tensors over 2 gloo ranks (rank r's ``x`` is 0..7 + 10 r); returns
    the results on the host, whether each came back on the card, and the
    host-staged calls."""
    from repro_torch.distributed import sharding as SH
    SH.reset_collectives()
    x = torch.arange(8.0, device=mesh.device) + 10 * mesh.rank
    got = {"all_gather": SH.all_gather(x, mesh, "data", 0),
           "all_reduce": SH.all_reduce_sum(x, mesh, "data"),
           "broadcast": SH.broadcast(x, mesh, "data", 1),
           "permute": SH.permute(x, mesh, "data", 1),
           "all_to_all": SH.all_to_all(x.reshape(2, 4), mesh, "data"),
           "reduce_scatter": SH.reduce_scatter_sum(x, mesh, "data", 0),
           "all_reduce_max": SH.all_reduce_max(x, mesh, "data")}
    SH.barrier(mesh)
    return {"values": {k: v.cpu() for k, v in got.items()},
            "on_card": {k: v.device.type == "cuda" for k, v in got.items()},
            "staged": sorted(k for k, _ in SH.COLLECTIVES
                             if k.endswith("_host_staged"))}


def gloo_raw_rank(mesh) -> dict:
    """Gloo's own collectives on card tensors over 2 ranks (a probe: each
    either gives its values or raises, recorded by kind; send and receive
    are left out, since gloo reads the card address as host memory)."""
    import torch.distributed as dist
    x = torch.arange(8.0, device=mesh.device) + 10 * mesh.rank
    calls = {
        "all_gather": lambda: torch.cat(_gathered(dist, x)),
        "all_reduce": lambda: _reduced(dist, x),
        "broadcast": lambda: _broadcast(dist, x),
        "all_to_all": lambda: _all_to_all(dist, x),
        "reduce_scatter": lambda: _reduce_scattered(dist, x),
        "all_reduce_max": lambda: _reduced(dist, x, dist.ReduceOp.MAX)}
    out = {}
    for kind, call in calls.items():
        try:
            out[kind] = call().cpu()
        except RuntimeError as e:
            out[kind] = str(e)
    return out


def _gathered(dist, x):
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x)
    return parts


def _reduced(dist, x, op=None):
    y = x.clone()
    dist.all_reduce(y, op=op or dist.ReduceOp.SUM)
    return y


def _reduce_scattered(dist, x):
    y = torch.empty(4, device=x.device)
    dist.reduce_scatter_tensor(y, x)
    return y


def _broadcast(dist, x):
    y = x.clone()
    dist.broadcast(y, src=1)
    return y


def _all_to_all(dist, x):
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x)
    return y.reshape(2, 4)


@pytest.fixture(scope="module")
def gloo_raw_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: gloo's CUDA paths run only there")
    from repro_torch.launch import mesh as M
    return M.run_ranks(gloo_raw_rank, "data=2", "cuda", timeout=300)


@pytest.mark.parametrize("kind", ["all_gather", "all_reduce", "broadcast",
                                  "all_to_all", "reduce_scatter",
                                  "all_reduce_max"])
def test_gloo_raw_collectives_on_card_tensors(gloo_raw_on_card, kind):
    """Gloo takes card tensors in each collective the helpers send
    straight (exact values), and a kind the helpers stage through the host
    (``sharding.HOST_STAGED``) is one gloo refuses or gets wrong here."""
    from repro_torch.distributed import sharding as SH
    ok = [torch.is_tensor(res[kind])
          and torch.equal(res[kind], _gloo_want(kind, r))
          for r, res in enumerate(gloo_raw_on_card)]
    assert all(ok) != (kind in SH.HOST_STAGED), \
        [res[kind] for res in gloo_raw_on_card]


@pytest.fixture(scope="module")
def gloo_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: gloo's CUDA paths run only there")
    from repro_torch.launch import mesh as M
    return M.run_ranks(gloo_helpers_rank, "data=2", "cuda", timeout=300)


def _gloo_want(kind: str, r: int) -> torch.Tensor:
    x = [torch.arange(8.0) + 10 * i for i in range(2)]
    return {"all_gather": torch.cat(x), "all_reduce": x[0] + x[1],
            "reduce_scatter": (x[0] + x[1])[4 * r:4 * r + 4],
            "all_reduce_max": x[1],
            "broadcast": x[1], "permute": x[1 - r],
            "all_to_all": torch.stack([x[0].reshape(2, 4)[r],
                                       x[1].reshape(2, 4)[r]])}[kind]


@pytest.mark.parametrize("kind", ["all_gather", "all_reduce", "broadcast",
                                  "permute", "all_to_all", "reduce_scatter",
                                  "all_reduce_max"])
def test_gloo_helpers_on_card_tensors(gloo_on_card, kind):
    """Each helper gives the exact values on card tensors and hands back a
    card tensor; the kinds in ``sharding.HOST_STAGED`` (gloo's send and
    receive) go through the host and are counted so."""
    from repro_torch.distributed import sharding as SH
    for r, res in enumerate(gloo_on_card):
        assert torch.equal(res["values"][kind], _gloo_want(kind, r)), r
        assert res["on_card"][kind]
        assert res["staged"] == sorted(f"{k}_host_staged"
                                       for k in SH.HOST_STAGED)


def smoke_step_rank(mesh, arch: str) -> dict:
    """One sharded step of ``arch``'s smoke form on the card: the loss and
    the gathered new parameters (on the host)."""
    from repro_torch.config import OptimizerConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.factory import build_model
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step, \
        shard_params
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    sp = shard_params(model.init_params(0, mesh.device).requires_grad_(True),
                      mesh)
    step = make_train_step(model.loss, cfg, OptimizerConfig(warmup_steps=1),
                           mesh=mesh, split=model.split)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (8, 17), generator=g)
    batch = {"tokens": toks[:, :-1].to(mesh.device),
             "targets": toks[:, 1:].to(mesh.device)}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(8, cfg.encoder_seq, cfg.d_model,
                                      generator=g).to(mesh.device)
    sp, _, m = step(sp, adamw_init(sp.blocks), batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": {k: SH.unshard(b, sp.specs[k], mesh).detach().cpu()
                       for k, b in sp.blocks.items()}}


@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x7b", "falcon-mamba-7b",
                                  "zamba2-7b", "whisper-medium"])
def test_model_split_step_on_the_card_is_the_one_rank_step(card, arch):
    """The same at data 1 x model 2: the attention heads, the MLP (yi,
    zamba2's shared block, whisper's GELU MLP), the experts (mixtral),
    Mamba-1's and Mamba-2's d_inner (their activations regrouped over
    ``model``: gloo's all-gather and reduce-scatter, both of even blocks)
    and the vocabulary split over ``model`` on card tensors, no parameter
    gathered over ``model``, against the one-rank step at the same
    bars."""
    from repro_torch.config import MeshConfig
    from repro_torch.launch import mesh as M
    one = M.make_mesh(MeshConfig((1, 1), ("data", "model")), 0, "cuda")
    want = smoke_step_rank(one, arch)
    got = M.run_ranks(smoke_step_rank, "data=1,model=2", "cuda", arch,
                      timeout=300)
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=2e-5)
        np.testing.assert_allclose(r["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
    for k, w in want["params"].items():
        np.testing.assert_allclose(got[0]["params"][k].numpy(), w.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x7b"])
def test_data_parallel_step_on_the_card_is_the_one_rank_step(card, arch):
    """yi-6b's and mixtral's smoke forms, one step on 2 gloo ranks on the
    card (data 2) against the one-rank step there: loss within rtol 2e-5,
    every parameter within rtol 2e-4 / atol 2e-5 (the reference's bars for
    a sharded step), at the full learning rate on step 1 (warmup 1) so
    that the update is over the bar, and the gradient norm within rtol
    1e-5 (AdamW's first step does not see the gradient's scale)."""
    from repro_torch.config import MeshConfig
    from repro_torch.launch import mesh as M
    one = M.make_mesh(MeshConfig((1, 1), ("data", "model")), 0, "cuda")
    want = smoke_step_rank(one, arch)
    got = M.run_ranks(smoke_step_rank, "data=2,model=1", "cuda", arch,
                      timeout=300)
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=2e-5)
        np.testing.assert_allclose(r["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
    for k, w in want["params"].items():
        np.testing.assert_allclose(got[0]["params"][k].numpy(), w.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
