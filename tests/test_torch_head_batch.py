"""A rank's share of the kv heads rounds as the same heads inside the whole
batch, in every plain attention product the tensor-parallel engine runs.

The trap (seen on this project's CPU test host, PyTorch's CPU build):
``torch.einsum("rhgd,rnhd->rhgn")`` at a decode shape (one query row)
folds a head axis of size 1 out of its batch and takes another BLAS
layout, so one head computed alone differs from the same head inside a
wider call (up to 1.9e-6 on the scores, 8.3e-7 on the logits of a
4-rank engine run).  ``kernels/ref.py::head_matmul`` computes every such
product in one form whatever the number of heads.  Here each repaired
product runs at a decode shape (S 1) and at a chunk's (S 16), at 2 and 4
query rows per kv head (the trap shows at 2, the tensor-parallel tests'
grouping), over the head shares of 1, 2 and 4 ranks (and of 8 over 8 kv
heads), bit for bit against the whole batch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.serving.engine import _joint_attend  # noqa: E402

H = 8
GQS = (2, 4)       # query rows per kv head: the tp tests' 8 q / 4 kv, and 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shares(h: int):
    """(ranks, heads per rank) for 1, 2 and 4 ranks and one head each."""
    return sorted({(n, h // n) for n in (1, 2, 4, h)})


def rand(gen, *shape):
    return torch.randn(shape, generator=gen)


def pool(gen, r, n, h, d):
    """A pool's worth of plain inputs for K2's plain version: codes,
    E4M3-valued bf16 scales, slot state and bits, an identity table."""
    nb, bs = n // 8, 8
    codes = torch.randint(0, 256, (r * nb, bs, h, d), generator=gen,
                          dtype=torch.uint8)
    scales = (2.0 ** torch.randint(-6, -3, (r * nb, bs, h, d // 16),
                                   generator=gen)).to(torch.bfloat16)
    state = torch.randint(0, 3, (r, nb, bs), generator=gen,
                          dtype=torch.uint8)
    bits = torch.tensor([2, 4, 8], dtype=torch.uint8)[
        torch.randint(0, 3, (r, nb, bs), generator=gen)]
    table = torch.arange(r * nb, dtype=torch.int32).reshape(r, nb)
    return codes, codes.flip(0), scales, scales.flip(0), state, bits, table


@pytest.mark.parametrize("gq", GQS)
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("h", [4, H])
def test_head_matmul_slices_equal_the_whole_batch(h, d, gq):
    """Scores (q [R, H, GQ·S, D] @ k^T) and values (p @ v) at S 1 and 16:
    every rank's share of the heads equals its slice of the whole call,
    where ``torch.einsum`` of the same product may not."""
    gen = torch.Generator().manual_seed(h * d)
    for s in (1, 16):
        q, k = rand(gen, 4, h, gq * s, d), rand(gen, 4, 96, h, d)
        p, v = torch.softmax(rand(gen, 4, h, gq * s, 96), -1), \
            rand(gen, 4, 96, h, d)
        whole_s = R.head_matmul(q, k.permute(0, 2, 3, 1))
        whole_o = R.head_matmul(p, v.permute(0, 2, 1, 3))
        for ranks, per in shares(h):
            for i in range(ranks):
                sl = slice(i * per, (i + 1) * per)
                got_s = R.head_matmul(q[:, sl], k[:, :, sl].permute(
                    0, 2, 3, 1))
                got_o = R.head_matmul(p[:, sl], v[:, :, sl].permute(
                    0, 2, 1, 3))
                trap = int((torch.einsum("rhgd,rnhd->rhgn", q[:, sl],
                                         k[:, :, sl])
                            != whole_s[:, sl]).sum())
                assert torch.equal(got_s, whole_s[:, sl]), \
                    (s, ranks, f"einsum differs in {trap} scores")
                assert torch.equal(got_o, whole_o[:, sl]), (s, ranks)


@pytest.mark.parametrize("gq", GQS)
@pytest.mark.parametrize("h", [4, H])
def test_plain_k1_k2_and_buffer_slices_equal_the_whole_batch(h, gq):
    """K2's plain version over a quantized pool, the plain TBQ-buffer
    attention and K1's (their flash merge) at a decode tick's shape (R 4,
    one query row per kv head group): each rank's share of the kv heads
    gives its slice of the whole call's (out, m, l) bit for bit."""
    gen = torch.Generator().manual_seed(h)
    r, d, n = 4, 16, 96
    qh = rand(gen, r, h, gq, d)
    planes = pool(gen, r, n, h, d)
    buf_k, buf_v = rand(gen, r, 16, h, d), rand(gen, r, 16, h, d)
    buf_len = torch.tensor([0, 5, 16, 9])
    whole_p = R.ct_paged_attention_batched_ref(qh, *planes)
    whole_b = R.buffer_attention_batched_ref(qh, buf_k, buf_v, buf_len)
    whole_f = R.ct_paged_attention_fused_ref(
        qh[None], *(x[None] for x in planes[:6]), planes[6][:, None],
        buf_k[None], buf_v[None], buf_len)
    for ranks, per in shares(h):
        for i in range(ranks):
            sl = slice(i * per, (i + 1) * per)
            mine = (planes[0][:, :, sl], planes[1][:, :, sl],
                    planes[2][:, :, sl], planes[3][:, :, sl], *planes[4:])
            got_p = R.ct_paged_attention_batched_ref(qh[:, sl], *mine)
            got_b = R.buffer_attention_batched_ref(
                qh[:, sl], buf_k[:, :, sl], buf_v[:, :, sl], buf_len)
            got_f = R.ct_paged_attention_fused_ref(
                qh[None, :, sl], *(x[None] for x in mine[:6]),
                mine[6][:, None], buf_k[None, :, :, sl],
                buf_v[None, :, :, sl], buf_len)
            for got, whole in zip(got_p + got_b, whole_p + whole_b):
                assert torch.equal(got, whole[:, sl]), (ranks, i)
            assert torch.equal(got_f, whole_f[:, :, sl]), (ranks, i)


@pytest.mark.parametrize("gq", GQS)
@pytest.mark.parametrize("s", [1, 16])
def test_joint_attention_and_k3_slices_equal_the_whole_batch(s, gq):
    """The reference backend's joint attention over pool and buffer (a
    decode tick at S 1, a g-chunk at S 16: output and probabilities) and
    K3's plain version with its stats over a chunk: each rank's share of
    the kv heads gives its slice of the whole call bit for bit."""
    gen = torch.Generator().manual_seed(s)
    b, n, g, d = 3, 40, 16, 16
    q = rand(gen, b, s, H * gq, d)
    kp, vp = rand(gen, b, n, H, d), rand(gen, b, n, H, d)
    valid = torch.rand((b, n), generator=gen) > 0.3
    bk, bv = rand(gen, b, g, H, d), rand(gen, b, g, H, d)
    mask = torch.rand((b, s, g), generator=gen) > 0.4
    whole = _joint_attend(q, kp, vp, valid, bk, bv, mask)
    fq, fk, fv = rand(gen, s, H * gq, d), rand(gen, s, H, d), \
        rand(gen, s, H, d)
    whole_f = R.flash_prefill_stats_ref(fq, fk, fv)
    for ranks, per in shares(H):
        for i in range(ranks):
            hs, qs = slice(i * per, (i + 1) * per), \
                slice(i * per * gq, (i + 1) * per * gq)
            out, p, _ = _joint_attend(q[:, :, qs], kp[:, :, hs],
                                      vp[:, :, hs], valid, bk[:, :, hs],
                                      bv[:, :, hs], mask)
            assert torch.equal(out, whole[0][:, :, qs]), (ranks, i)
            assert torch.equal(p, whole[1][:, :, hs]), (ranks, i)
            got_f = R.flash_prefill_stats_ref(fq[:, qs], fk[:, hs],
                                              fv[:, hs])
            for got, w in zip(got_f, whole_f):
                assert torch.equal(got, w[:, qs]), (ranks, i)
    assert np.isfinite(whole[0].numpy()).all()
