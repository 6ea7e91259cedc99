"""The CUDA kernels (window MIPS over f32/bf16 items- and queries-major and
over int8, fold MIPS, in-batch BPR forward and backward, int8 quantize, row
gather) against their plain PyTorch twins.

The ``cuda`` tests need an NVIDIA GPU and nvcc and skip without them. On
the card run ``python -m pytest tests/test_torch_kernels.py -m cuda
--noconftest``: this file imports torch only, and ``tests/conftest.py``
imports jax, which the card's machine does not have.

Tolerances: window maxima within 1e-4 absolute — both sides sum the same
f32 products (bf16 x bf16-rounded products are exact in f32) in different
orders; positions must name a row whose twin score equals the kernel's
maximum within the same 1e-4. BPR: the loss within 1e-5 relative, du and dv
within 1e-4 of the twin's largest entry (f32 sums of up to B·D terms in
another order). The int8 window kernel and the quantize kernel are held to
their twins bit for bit: integer sums are exact in any order, and the
epilogues are the same single f32 operations. The queries-major window
kernel runs kernel 1's arithmetic, so it equals kernel 1's output
transposed bit for bit. The fold kernel: values within 1e-4 of the twin,
and on integer-valued inputs (exact sums, ties everywhere) values and rows
equal to the twin's. The gather copies bytes: equal.
"""
import pytest
import torch

from recommendit_tpu_torch.ops import bpr
from recommendit_tpu_torch.ops import gather
from recommendit_tpu_torch.ops import mips_fold as mf
from recommendit_tpu_torch.ops import mips_window as mw
from recommendit_tpu_torch.ops import quantize as qz
from recommendit_tpu_torch.ops.topk import mm_operands, quantize_queries


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _corpus(n, d, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    items = torch.randn(n, d, generator=g)
    items = items / items.norm(dim=1, keepdim=True)
    q = torch.randn(100, d, generator=g)
    return q.to(device), items.to(dtype).to(device)


def _row_scores(q, items, cand_args, window, precision="default"):
    """Twin scores (n_cand, Q) of the rows the kernel chose."""
    n_cand, n_q = cand_args.shape
    rows = (torch.arange(n_cand, device=items.device)[:, None] * window
            + cand_args.long()).clamp(max=items.shape[0] - 1)
    qq, it = mm_operands(q, items, precision)
    return (it[rows] * qq[None, :, :]).sum(-1)


def test_cpu_tensor_takes_the_twin():
    q, items = _corpus(500, 16, torch.float32, "cpu")
    before = dict(mw.LAUNCHES)
    got = mw.window_candidates(q, items, 8, 490)
    want = mw.window_candidates_ref(q, items, 8, 490)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert mw.LAUNCHES == before


def test_other_device_raises():
    q = torch.empty(4, 16, device="meta")
    items = torch.empty(64, 16, device="meta")
    with pytest.raises(ValueError, match="no window kernel"):
        mw.window_candidates(q, items, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [1, 8, 64, 128, 512])
@pytest.mark.parametrize("n,n_valid", [(4096, 4096), (5000, 4801)])
def test_kernel_matches_twin(cuda_device, dtype, window, n, n_valid):
    q, items = _corpus(n, 136, dtype, cuda_device)
    before = mw.LAUNCHES["window_mips"]
    kv, ka = mw.window_candidates(q, items, window, n_valid)
    torch.cuda.synchronize()
    assert mw.LAUNCHES["window_mips"] == before + 1
    rv, ra = mw.window_candidates_ref(q, items, window, n_valid)
    assert kv.shape == rv.shape == (-(-n // window), 100)
    assert ka.dtype == torch.int32
    torch.testing.assert_close(kv, rv, atol=1e-4, rtol=0)
    # the kernel's position holds its maximum (ties may pick another row
    # only if the twin sees them within the tolerance)
    real = kv > -1e38
    picked = _row_scores(q, items, ka, window)
    assert (picked[real] - kv[real]).abs().max() <= 1e-4
    assert (ka == ra).float().mean() >= 0.999
    assert (ka[~real] == 0).all()          # fully masked windows: first row


@pytest.mark.cuda
def test_topk_matches_twin_at_serve_width(cuda_device):
    """k=500 over a padded 262,144-row bf16 corpus, W=64, D=136."""
    q, items = _corpus(262_144, 136, torch.bfloat16, cuda_device, seed=3)
    v, i = mw.mips_topk_window_im(q, items, 500, 4096, 64, n_valid=260_000)
    rv, ri = mw.mips_topk_window_im_ref(q, items, 500, 4096, 64,
                                        n_valid=260_000)
    torch.testing.assert_close(v, rv, atol=1e-4, rtol=0)
    assert int(i.max()) < 260_000
    overlap = sum(len(set(a) & set(b)) for a, b in zip(i.tolist(), ri.tolist()))
    assert overlap / i.numel() >= 0.99


@pytest.mark.cuda
def test_highest_precision_keeps_f32_queries(cuda_device):
    q, items = _corpus(2048, 136, torch.bfloat16, cuda_device, seed=4)
    kv, _ = mw.window_candidates(q, items, 8, precision="highest")
    rv, _ = mw.window_candidates_ref(q, items, 8, precision="highest")
    torch.testing.assert_close(kv, rv, atol=1e-4, rtol=0)
    dv, _ = mw.window_candidates_ref(q, items, 8, precision="default")
    assert not torch.equal(rv, dv)


@pytest.mark.cuda
def test_kernel_rejects_bad_arguments(cuda_device):
    q, items = _corpus(1024, 136, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="power of two"):
        mw.window_candidates(q, items, 24)
    with pytest.raises(ValueError, match="multiple of 8"):
        mw.window_candidates(q[:, :129], items[:, :129].contiguous(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        mw.window_candidates(q[:, :64], items[:, :64], 8)
    with pytest.raises(TypeError):
        mw.window_candidates(q, items.half(), 8)


def _unit_pair(b, d, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    u, v = (torch.nn.functional.normalize(torch.randn(b, d, generator=g), dim=1)
            for _ in "uv")
    return u.to(device), v.to(device)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 3, 20, 1000, 1024, 1100])
@pytest.mark.parametrize("d", [8, 64, 128, 256])
def test_bpr_kernels_match_twins(cuda_device, b, d):
    u, v = _unit_pair(b, d, cuda_device, seed=b * d)
    g = torch.tensor(1.3, device=cuda_device)
    before = dict(bpr.LAUNCHES)
    loss = bpr.bpr_forward(u, v)
    du, dv = bpr.bpr_backward(u, v, g)
    torch.cuda.synchronize()
    assert bpr.LAUNCHES == {k: n + 1 for k, n in before.items()}
    ref = bpr.in_batch_bpr_loss_ref(u, v)
    rdu, rdv = bpr._bpr_bwd_ref(u, v, g)
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    assert _rel(du, rdu) <= 1e-4 and _rel(dv, rdv) <= 1e-4


@pytest.mark.cuda
def test_bpr_autograd_on_the_card_matches_the_cpu_twins(cuda_device):
    u, v = _unit_pair(1024, 64, "cpu", seed=5)
    grads = []
    for dev in ("cpu", cuda_device):
        a, c = (t.detach().to(dev).clone().requires_grad_() for t in (u, v))
        loss = bpr.InBatchBPR.apply(a, c)
        loss.backward()
        grads.append((float(loss.detach()), a.grad.cpu(), c.grad.cpu()))
    (lc, uc, vc), (lg, ug, vg) = grads
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert _rel(ug, uc) <= 1e-4 and _rel(vg, vc) <= 1e-4


@pytest.mark.cuda
def test_bpr_kernels_reject_bad_arguments(cuda_device):
    u, v = _unit_pair(64, 64, cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        bpr.bpr_forward(u[:, :62].contiguous(), v[:, :62].contiguous())
    with pytest.raises(ValueError, match="at most 256"):
        w = torch.zeros(64, 260, device=cuda_device)
        bpr.bpr_forward(w, w)
    with pytest.raises(ValueError, match="at least 2 rows"):
        bpr.bpr_forward(u[:1], v[:1])
    with pytest.raises(ValueError, match="contiguous"):
        bpr.bpr_forward(u[:, :32], v[:, :32])
    with pytest.raises(TypeError):
        bpr.bpr_forward(u.double(), v.double())


def _int8_corpus(n, d, n_valid, device, seed=0, negative=False):
    """Int8 unit rows with their scales (0 past ``n_valid``, as the fused
    index pads) and 100 int8 queries. ``negative``: every real score < 0."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    items = torch.nn.functional.normalize(torch.randn(n, d, generator=g), dim=1)
    q = torch.randn(100, d, generator=g)
    if negative:
        items, q = items.abs(), -q.abs()
    e8, scales = qz.quantize_int8(items, seed)
    scales[n_valid:] = 0.0
    e8[n_valid:] = 0
    q8, _ = quantize_queries(q)
    return q8.to(device), e8.to(device), scales.to(device)


def test_int8_cpu_tensor_takes_the_twin():
    q8, e8, s = _int8_corpus(500, 16, 490, "cpu")
    before = dict(mw.LAUNCHES)
    got = mw.window_candidates_i8(q8, e8, s, 8, 490)
    want = mw.window_candidates_i8_ref(q8, e8, s, 8, 490)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert mw.LAUNCHES == before


def test_quantize_cpu_tensor_takes_the_twin():
    x = torch.randn(300, 129, generator=torch.Generator().manual_seed(1))
    before = dict(qz.LAUNCHES)
    got = qz.quantize_int8_hash(x, 7)
    want = qz.quantize_int8_hash_ref(x, 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert qz.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 144])
@pytest.mark.parametrize("window", [1, 8, 64, 128, 512])
@pytest.mark.parametrize("n,n_valid", [(4096, 4096), (5000, 4801)])
def test_int8_kernel_matches_twin_bit_for_bit(cuda_device, d, window, n, n_valid):
    q8, e8, s = _int8_corpus(n, d, n_valid, cuda_device, seed=window + d)
    before = mw.LAUNCHES["window_mips_i8"]
    kv, ka = mw.window_candidates_i8(q8, e8, s, window, n_valid)
    torch.cuda.synchronize()
    assert mw.LAUNCHES["window_mips_i8"] == before + 1
    rv, ra = mw.window_candidates_i8_ref(q8, e8, s, window, n_valid)
    assert kv.shape == rv.shape == (-(-n // window), 100)
    assert ka.dtype == torch.int32
    assert torch.equal(kv, rv) and torch.equal(ka, ra)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [8, 512])
def test_int8_kernel_masks_after_the_scale(cuda_device, window):
    """Every real score negative, pad rows at scale 0: a pad row scores
    -3e38, never -0, so no window past ``n_valid`` holds a real maximum and
    no valid window picks a pad row."""
    n, n_valid = 8192, 5001
    q8, e8, s = _int8_corpus(n, 144, n_valid, cuda_device, seed=3, negative=True)
    kv, ka = mw.window_candidates_i8(q8, e8, s, window, n_valid)
    rv, ra = mw.window_candidates_i8_ref(q8, e8, s, window, n_valid)
    assert torch.equal(kv, rv) and torch.equal(ka, ra)
    n_real = -(-n_valid // window)          # the last one holds pad rows too
    assert bool((kv[:n_real] < 0).all())
    assert bool((kv[n_real:] == -3e38).all())
    assert int(ka[n_real - 1].max()) <= (n_valid - 1) % window


@pytest.mark.cuda
def test_int8_topk_matches_twin_at_serve_width(cuda_device):
    """k=500 over a padded 262,144-row int8 corpus, W=64, D=144: the same
    ids and values as the twin, the query scale applied after."""
    g = torch.Generator().manual_seed(5)
    items = torch.nn.functional.normalize(torch.randn(260_000, 129, generator=g), dim=1)
    e8, s = qz.quantize_int8(items.to(cuda_device), 5)
    e8 = torch.nn.functional.pad(e8, (0, 15, 0, 2144))
    s = torch.nn.functional.pad(s, (0, 2144))
    q = torch.nn.functional.pad(torch.randn(400, 129, generator=g), (0, 15)).to(cuda_device)
    v, i = mw.mips_topk_window_im_int8(q, e8, s, 500, 4096, 64, n_valid=260_000)
    rv, ri = mw.mips_topk_window_im_int8_ref(q, e8, s, 500, 4096, 64,
                                             n_valid=260_000)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    assert int(i.max()) < 260_000


@pytest.mark.cuda
def test_int8_kernel_rejects_bad_arguments(cuda_device):
    q8, e8, s = _int8_corpus(1024, 144, 1024, cuda_device)
    with pytest.raises(ValueError, match="power of two"):
        mw.window_candidates_i8(q8, e8, s, 24)
    with pytest.raises(ValueError, match="multiple of 16"):
        mw.window_candidates_i8(q8[:, :136].contiguous(), e8[:, :136].contiguous(), s, 8)
    with pytest.raises(ValueError, match="contiguous"):
        mw.window_candidates_i8(q8[:, :64], e8[:, :64], s, 8)
    with pytest.raises(TypeError):
        mw.window_candidates_i8(q8.float(), e8, s, 8)
    with pytest.raises(ValueError, match="scales"):
        mw.window_candidates_i8(q8, e8, s[:-1], 8)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 7, -1])
@pytest.mark.parametrize("n,d", [(1, 5), (1000, 129), (4097, 128), (3, 1030)])
def test_quantize_kernel_matches_twin_bit_for_bit(cuda_device, seed, n, d):
    g = torch.Generator().manual_seed(n + d)
    x = (3.0 * torch.randn(n, d, generator=g)).to(cuda_device)
    before = qz.LAUNCHES["quantize_i8"]
    v, s = qz.quantize_int8_hash(x, seed)
    torch.cuda.synchronize()
    assert qz.LAUNCHES["quantize_i8"] == before + 1
    rv, rs = qz.quantize_int8_hash_ref(x, seed)
    cv, cs = qz.quantize_int8_hash_ref(x.cpu(), seed)
    assert torch.equal(s, rs) and torch.equal(v, rv)
    assert torch.equal(s.cpu(), cs) and torch.equal(v.cpu(), cv)


@pytest.mark.cuda
def test_quantize_kernel_rejects_bad_arguments(cuda_device):
    x = torch.randn(64, 32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        qz.quantize_int8_hash(x[:, :16], 0)
    with pytest.raises(TypeError):
        qz.quantize_int8_hash(x.double(), 0)
    with pytest.raises(ValueError, match="int32"):
        qz.quantize_int8_hash(x, 2 ** 31)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [1, 8, 64, 128, 512])
@pytest.mark.parametrize("n,n_valid", [(4096, 4096), (5000, 4801)])
def test_queries_major_kernel_is_kernel_1_transposed(cuda_device, dtype, window,
                                                     n, n_valid):
    q, items = _corpus(n, 136, dtype, cuda_device, seed=window)
    before = mw.LAUNCHES["window_mips_qm"]
    kv, ka = mw.window_candidates_qm(q, items, window, n_valid)
    torch.cuda.synchronize()
    assert mw.LAUNCHES["window_mips_qm"] == before + 1
    iv, ia = mw.window_candidates(q, items, window, n_valid)
    assert kv.shape == (100, -(-n // window)) and ka.dtype == torch.int32
    assert torch.equal(kv, iv.T) and torch.equal(ka, ia.T)
    rv, _ = mw.window_candidates_qm_ref(q, items, window, n_valid)
    torch.testing.assert_close(kv, rv, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_mips_topk_window_matches_twin(cuda_device):
    """JAX's defaults (block 16384, W=128) over a padded bf16 corpus."""
    q, items = _corpus(262_144, 136, torch.bfloat16, cuda_device, seed=6)
    v, i = mw.mips_topk_window(q, items, 500, n_valid=260_000)
    rv, ri = mw.mips_topk_window_ref(q, items, 500, n_valid=260_000)
    torch.testing.assert_close(v, rv, atol=1e-4, rtol=0)
    assert int(i.max()) < 260_000
    overlap = sum(len(set(a) & set(b)) for a, b in zip(i.tolist(), ri.tolist()))
    assert overlap / i.numel() >= 0.99


# (N, D, block_items, reduction): bins narrower than a 64-row tile, exactly
# one tile, wider (several bin tiles), a bias pad, a tiny block, R = 1
FOLD_CASES = [(4096, 136, 2048, 64), (5000, 136, 2048, 32), (9000, 24, 2048, 8),
              (301, 4, 16, 4), (3000, 16, 1024, 1), (70_000, 129, 2048, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FOLD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fold_kernel_matches_twin(cuda_device, dtype, case):
    n, d, block, r = case
    q, items = _corpus(n, d, dtype, cuda_device, seed=n + r)
    before = mf.LAUNCHES["fold_mips"]
    kv, ki = mf.fold_candidates(q, items, block, r)
    torch.cuda.synchronize()
    assert mf.LAUNCHES["fold_mips"] == before + 1
    rv, ri = mf.fold_candidates_ref(q, items, block, r)
    assert kv.shape == rv.shape and ki.dtype == torch.int32
    torch.testing.assert_close(kv, rv, atol=1e-4, rtol=0)
    assert (ki == ri).float().mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FOLD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fold_kernel_keeps_the_tournament_ties(cuda_device, dtype, case):
    n, d, block, r = case
    g = torch.Generator().manual_seed(n)
    q = torch.randint(-1, 2, (70, d), generator=g).float().to(cuda_device)
    items = torch.randint(-1, 2, (n, d), generator=g).float().to(dtype).to(cuda_device)
    kv, ki = mf.fold_candidates(q, items, block, r)
    rv, ri = mf.fold_candidates_ref(q, items, block, r)
    assert torch.equal(kv, rv) and torch.equal(ki, ri)


@pytest.mark.cuda
def test_fold_topk_matches_twin(cuda_device):
    q, items = _corpus(100_000, 136, torch.bfloat16, cuda_device, seed=8)
    v, i = mf.mips_topk_fused(q, items, 500, 2048, 64)
    rv, ri = mf.mips_topk_fused_ref(q, items, 500, 2048, 64)
    torch.testing.assert_close(v, rv, atol=1e-4, rtol=0)
    overlap = sum(len(set(a) & set(b)) for a, b in zip(i.tolist(), ri.tolist()))
    assert overlap / i.numel() >= 0.99


@pytest.mark.cuda
def test_fold_kernel_rejects_bad_arguments(cuda_device):
    q, items = _corpus(1024, 16, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        mf.fold_candidates(q, items.half(), 256, 4)
    with pytest.raises(ValueError, match="contiguous"):
        mf.fold_candidates(q[:, :8], items[:, :8], 256, 4)
    with pytest.raises(ValueError, match="power-of-two"):
        mf.fold_candidates(q, items, 384, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.float64])
@pytest.mark.parametrize("d", [1, 3, 23, 64, 129])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64, torch.int16])
def test_gather_kernel_matches_twin(cuda_device, dtype, d, idx_dtype):
    g = torch.Generator().manual_seed(d)
    table = (100 * torch.randn(5000, d, generator=g)).to(dtype).to(cuda_device)
    idx = torch.randint(-50, 5050, (37, 16), generator=g).to(idx_dtype).to(cuda_device)
    before = gather.LAUNCHES["gather_rows"]
    got = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["gather_rows"] == before + 1
    assert got.shape == (37, 16, d)
    assert torch.equal(got, gather.gather_rows_ref(table, idx))


@pytest.mark.cuda
def test_gather_kernel_odd_offsets_and_shapes(cuda_device):
    """A table view that starts off a 16-byte boundary takes the narrower
    copies; a 0-d index and an empty one."""
    base = torch.arange(6000 * 8, dtype=torch.float32, device=cuda_device)
    table = base[1:1 + 5000 * 8].view(5000, 8)          # 4-byte aligned only
    idx = torch.tensor([[0, 4999], [7, 10 ** 9]], device=cuda_device)
    assert torch.equal(gather.gather_rows(table, idx), gather.gather_rows_ref(table, idx))
    assert torch.equal(gather.gather_rows(table, idx[0, 1]), table[4999])
    before = gather.LAUNCHES["gather_rows"]
    empty = gather.gather_rows(table, idx[:0])
    assert empty.shape == (0, 2, 8) and gather.LAUNCHES["gather_rows"] == before
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows(table.T.contiguous().T, idx)
