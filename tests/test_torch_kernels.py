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
maximum within the same 1e-4; on integer-valued bf16 inputs (exact sums,
ties everywhere) the maxima and first-occurrence positions of the
tensor-core body equal the twin's. BPR: the loss within 1e-5 relative, du
and dv within 1e-4 of the twin's largest entry (f32 sums of up to B·D terms in
another order; the kernels' products are 3xTF32, about f32's accuracy), and
two calls on the same inputs equal bit for bit. The int8 window kernel and the quantize kernel are held to
their twins bit for bit: integer sums are exact in any order, and the
epilogues are the same single f32 operations. The queries-major window
kernel runs kernel 1's arithmetic, so it equals kernel 1's output
transposed bit for bit. Both bodies of the int8 window kernel (tensor cores
up to 384 columns, dp4a above) are held to the twin bit for bit. The fold
kernel, both bodies (tensor cores over the three bf16 pieces of the f32
queries for bf16 rows up to 144 columns, CUDA cores otherwise): values
within 1e-4 of the twin, rows equal for at least 99.9 % of the bins (f32
sums in another order may swap near-ties), every score within
``chip_smoke.FOLD_F64_LIMIT`` (2e-6) of its f64 value relative to its
Σ|q_k·x_k| — below what dropping the third bf16 piece costs on queries
whose third piece is large, which the twin fed two pieces shows each
time — and on integer-valued inputs
(exact sums, ties everywhere) values and rows equal to the twin's; two
calls equal bit for bit. The query split equals its twin bit for bit. The
gather copies bytes: equal.
"""
import pytest
import torch

import chip_smoke
from recommendit_tpu_torch.ops import bpr
from recommendit_tpu_torch.ops import gather
from recommendit_tpu_torch.ops import mips_fold as mf
from recommendit_tpu_torch.ops import mips_window as mw
from recommendit_tpu_torch.ops import quantize as qz
from recommendit_tpu_torch.ops.topk import mm_operands, quantize_queries, score_matrix


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


@pytest.mark.parametrize("dtype,precision,d,body", [
    (torch.bfloat16, "default", 136, "tensor_cores"),   # the serve corpus
    (torch.bfloat16, "default", 16, "tensor_cores"),
    (torch.bfloat16, "default", 192, "tensor_cores"),   # the widest query tile
    (torch.bfloat16, "default", 200, "cuda_cores"),
    (torch.bfloat16, "highest", 136, "cuda_cores"),     # f32 queries
    (torch.float32, "default", 136, "cuda_cores"),
    (torch.float32, "highest", 136, "cuda_cores"),
])
def test_window_body_follows_dtype_and_precision(dtype, precision, d, body):
    assert mw.window_body(dtype, precision, d) == body


def test_bf16_cpu_tensor_takes_the_twin():
    q, items = _corpus(700, 136, torch.bfloat16, "cpu")
    before = dict(mw.LAUNCHES)
    for major in (mw.window_candidates, mw.window_candidates_qm):
        got = major(q, items, 64, 650)
        ref = (mw.window_candidates_ref if major is mw.window_candidates
               else mw.window_candidates_qm_ref)
        want = ref(q, items, 64, 650)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert mw.LAUNCHES == before


@pytest.mark.parametrize("n_q,route", [(8, "scan"), (400, "kernel")])
def test_fused_auto_runs_the_route_it_picks(n_q, route):
    """``mips_topk_fused_auto`` is ``mips_topk_fused_route`` on the route
    ``fused_route`` picks: the scan for a small batch over a corpus above
    65,536 rows, the window kernel (its twin here) for a large one."""
    _, items = _corpus(70_000, 16, torch.bfloat16, "cpu")
    q = _queries(n_q, 16, "cpu", seed=n_q)
    picked, window = mw.fused_route(n_q, items.shape[0], 50)
    assert picked == route
    got = mw.mips_topk_fused_auto(q, items, 50)
    want = mw.mips_topk_fused_route(route, window, q, items, 50)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _queries(n_q, d, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(n_q, d, generator=g).to(device)


def _check_against_twin(q, items, window, n_valid, kv, ka):
    """The window checks of ``test_kernel_matches_twin`` at "default"
    precision, with the chosen rows' twin scores read from one score
    matrix."""
    rv, ra = mw.window_candidates_ref(q, items, window, n_valid)
    assert kv.shape == rv.shape == (-(-items.shape[0] // window), q.shape[0])
    assert ka.dtype == torch.int32
    torch.testing.assert_close(kv, rv, atol=1e-4, rtol=0)
    scores = score_matrix(q, items, "default")                  # (Q, N)
    rows = (torch.arange(kv.shape[0], device=items.device)[:, None] * window
            + ka.long()).clamp(max=items.shape[0] - 1)
    picked = scores.gather(1, rows.T).T
    real = kv > -1e38
    assert (picked[real] - kv[real]).abs().max() <= 1e-4
    assert (ka == ra).float().mean() >= 0.999
    assert (ka[~real] == 0).all()          # fully masked windows: first row


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 136, 144])
@pytest.mark.parametrize("n_q", [1, 100, 257, 1024])
@pytest.mark.parametrize("window", [1, 8, 64, 128, 512])
@pytest.mark.parametrize("n,n_valid", [(4096, 4096), (5000, 4801)])
def test_tensor_core_body_matches_twin(cuda_device, d, n_q, window, n, n_valid):
    """bf16 at "default": the K tail (d=136 is not a multiple of 16), query
    counts off the 256-query tile, n_valid inside a 128-row tile."""
    assert mw.window_body(torch.bfloat16, "default", d) == "tensor_cores"
    _, items = _corpus(n, d, torch.bfloat16, cuda_device, seed=d + window)
    q = _queries(n_q, d, cuda_device, seed=n_q)
    before = mw.LAUNCHES["window_mips"]
    kv, ka = mw.window_candidates(q, items, window, n_valid)
    torch.cuda.synchronize()
    assert mw.LAUNCHES["window_mips"] == before + 1
    _check_against_twin(q, items, window, n_valid, kv, ka)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [2 ** i for i in range(10)])
def test_tensor_core_body_every_window(cuda_device, window):
    """Every power of two from 1 to 512, both layouts: the twin's maxima,
    and the queries-major launch equal to the items-major one transposed."""
    _, items = _corpus(5000, 136, torch.bfloat16, cuda_device, seed=window)
    q = _queries(257, 136, cuda_device, seed=window)
    kv, ka = mw.window_candidates(q, items, window, 4801)
    _check_against_twin(q, items, window, 4801, kv, ka)
    qv, qa = mw.window_candidates_qm(q, items, window, 4801)
    assert torch.equal(qv, kv.T) and torch.equal(qa, ka.T)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 4, 8, 64, 128, 512])
def test_tensor_core_body_keeps_the_first_of_ties(cuda_device, window):
    """Integer-valued bf16 rows and queries in {-1, 0, 1}: every sum is
    exact in any order, windows are full of ties, and the kernel's maxima
    and first-occurrence positions equal the twin's in both layouts."""
    g = torch.Generator().manual_seed(window)
    q = torch.randint(-1, 2, (300, 136), generator=g).float().to(cuda_device)
    items = torch.randint(-1, 2, (5000, 136), generator=g).to(torch.bfloat16)
    items = items.to(cuda_device)
    kv, ka = mw.window_candidates(q, items, window, 4801)
    rv, ra = mw.window_candidates_ref(q, items, window, 4801)
    assert torch.equal(kv, rv) and torch.equal(ka, ra)
    qv, qa = mw.window_candidates_qm(q, items, window, 4801)
    assert torch.equal(qv, rv.T) and torch.equal(qa, ra.T)


@pytest.mark.cuda
def test_wide_bf16_rows_take_the_cuda_core_body(cuda_device):
    q, items = _corpus(3000, 200, torch.bfloat16, cuda_device, seed=9)
    assert mw.window_body(items.dtype, "default", 200) == "cuda_cores"
    kv, ka = mw.window_candidates(q, items, 64, 2900)
    _check_against_twin(q, items, 64, 2900, kv, ka)


@pytest.mark.cuda
def test_tensor_core_body_rejects_a_misaligned_corpus(cuda_device):
    _, items = _corpus(1025, 136, torch.bfloat16, cuda_device)
    shifted = items.view(-1)[1:1 + 1024 * 136].view(1024, 136)   # 2-byte offset
    with pytest.raises(ValueError, match="16-byte aligned"):
        mw.window_candidates(torch.zeros(8, 136, device=cuda_device), shifted, 8)


@pytest.mark.cuda
def test_kernel_rejects_bad_arguments(cuda_device):
    q, items = _corpus(1024, 136, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="power of two"):
        mw.window_candidates(q, items, 24)
    with pytest.raises(ValueError, match="shape mismatch"):
        mw.window_candidates(q[:, :129], items, 8)
    with pytest.raises(ValueError, match="contiguous"):
        mw.window_candidates(q[:, :64], items[:, :64], 8)
    with pytest.raises(TypeError):
        mw.window_candidates(q, items.half(), 8)


@pytest.mark.parametrize("dtype,align", [(torch.float32, 8), (torch.bfloat16, 8),
                                         (torch.int8, 16)])
def test_pad_columns_changes_no_score(dtype, align):
    """The zero columns the CUDA wrappers append to widths the kernels do
    not take: the width rounds up, the window maxima stay."""
    g = torch.Generator().manual_seed(align)
    q = torch.randint(-3, 4, (20, 100), generator=g).float()
    items = torch.randint(-3, 4, (700, 100), generator=g).to(dtype)
    pq, pit = mw.pad_columns(q, align), mw.pad_columns(items, align)
    assert pit.shape == (700, -(-100 // align) * align) and pit.dtype == dtype
    assert not pit[:, 100:].any() and mw.pad_columns(pit, align) is pit
    if dtype == torch.int8:
        s = torch.ones(700)
        got = mw.window_candidates_i8(pq.to(torch.int8), pit, s, 8, 650)
        want = mw.window_candidates_i8(q.to(torch.int8), items, s, 8, 650)
    else:
        got = mw.window_candidates(pq, pit, 8, 650)
        want = mw.window_candidates(q, items, 8, 650)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_kernels_take_any_width(cuda_device, dtype):
    """d=100, not a multiple of 8: the wrapper zero-pads queries and
    corpus; both layouts and the top-k against the twins."""
    q, items = _corpus(5000, 100, dtype, cuda_device, seed=100)
    kv, ka = mw.window_candidates(q, items, 64, 4801)
    _check_against_twin(q, items, 64, 4801, kv, ka)
    qv, qa = mw.window_candidates_qm(q, items, 64, 4801)
    assert torch.equal(qv, kv.T) and torch.equal(qa, ka.T)
    v, i = mw.mips_topk_window_im(q, items, 50, 4096, 64, n_valid=4801)
    rv, ri = mw.mips_topk_window_im_ref(q, items, 50, 4096, 64, n_valid=4801)
    torch.testing.assert_close(v, rv, atol=1e-4, rtol=0)
    assert int(i.max()) < 4801


def _unit_pair(b, d, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    u, v = (torch.nn.functional.normalize(torch.randn(b, d, generator=g), dim=1)
            for _ in "uv")
    return u.to(device), v.to(device)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _check_bpr_against_twins(b, d, device):
    u, v = _unit_pair(b, d, device, seed=b * d)
    g = torch.tensor(1.3, device=device)
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
@pytest.mark.parametrize("b", [2, 3, 20, 1000, 1024, 1100])
@pytest.mark.parametrize("d", [8, 64, 128, 256])
def test_bpr_kernels_match_twins(cuda_device, b, d):
    _check_bpr_against_twins(b, d, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [63, 65, 129, 1000])
@pytest.mark.parametrize("d", [4, 12, 100])
def test_bpr_kernels_partial_tiles(cuda_device, b, d):
    """B off the 64-row tiles, d off the 8-column k-steps (a zero-filled
    K tail)."""
    _check_bpr_against_twins(b, d, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1024, 1100])
def test_bpr_kernels_are_deterministic(cuda_device, b):
    """No float atomics: two calls give bit-identical loss, du and dv
    (B=1100 takes more tiles than blocks)."""
    u, v = _unit_pair(b, 64, cuda_device, seed=11)
    g = torch.tensor(0.7, device=cuda_device)
    first = (bpr.bpr_forward(u, v), *bpr.bpr_backward(u, v, g))
    second = (bpr.bpr_forward(u, v), *bpr.bpr_backward(u, v, g))
    assert all(torch.equal(a, c) for a, c in zip(first, second))


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


@pytest.mark.parametrize("offset", [0, 1])
def test_int8_cpu_tensor_records_no_body(offset):
    """The twin launches no body, so the record of the last launched one
    stays as it was; scales that start at any element of their storage are
    taken, as the kernel wrapper takes them."""
    q8, e8, s = _int8_corpus(501, 16, 490, "cpu")
    s = s[offset:offset + 500]
    mw.LAST_BODY["window_mips_i8"] = "sentinel"
    try:
        got = mw.window_candidates_i8(q8, e8[:500], s, 8, 490)
        assert mw.LAST_BODY["window_mips_i8"] == "sentinel"
    finally:
        mw.LAST_BODY["window_mips_i8"] = None
    want = mw.window_candidates_i8_ref(q8, e8[:500], s.clone(), 8, 490)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_quantize_cpu_tensor_takes_the_twin():
    x = torch.randn(300, 129, generator=torch.Generator().manual_seed(1))
    before = dict(qz.LAUNCHES)
    got = qz.quantize_int8_hash(x, 7)
    want = qz.quantize_int8_hash_ref(x, 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert qz.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 100, 144])    # 100: zero-padded to 112
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
    no valid window picks a pad row. d = 144: the tensor-core body."""
    n, n_valid = 8192, 5001
    assert mw.int8_window_body(144) == "tensor_cores"
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
    with pytest.raises(ValueError, match="at most 1024"):
        wide = torch.zeros((1024, 1040), dtype=torch.int8, device=cuda_device)
        mw.window_candidates_i8(wide[:8], wide, s, 8)
    with pytest.raises(ValueError, match="contiguous"):
        mw.window_candidates_i8(q8[:, :64], e8[:, :64], s, 8)
    with pytest.raises(TypeError):
        mw.window_candidates_i8(q8.float(), e8, s, 8)
    with pytest.raises(ValueError, match="scales"):
        mw.window_candidates_i8(q8, e8, s[:-1], 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        mw.window_candidates_i8(q8[:, :128], e8, s, 8)
    with pytest.raises(ValueError, match="scales must be contiguous"):
        mw.window_candidates_i8(q8, e8, torch.stack([s, s], 1)[:, 0], 8)
    # the tensor-core entry refuses rows past its limit: an error, never
    # the dp4a body in its place
    wide = torch.zeros((1024, 400), dtype=torch.int8, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        mw._window_candidates_i8_cuda(wide[:8], wide, s, 8, 1024,
                                      body="tensor_cores")


@pytest.mark.parametrize("d,body", [
    (144, "tensor_cores"),    # the serve corpus: 128 + the bias, padded
    (129, "tensor_cores"),    # padded to 144 first
    (16, "tensor_cores"),
    (256, "tensor_cores"),
    (384, "tensor_cores"),    # INT8_TC_MAX_DIM: the 384-byte query rows
    (385, "cuda_cores"),      # one column above: padded to 400
    (400, "cuda_cores"),
    (1024, "cuda_cores"),     # INT8_MAX_DIM
])
def test_int8_window_body_follows_width(d, body):
    assert mw.int8_window_body(d) == body


def test_build_key_follows_every_header(tmp_path):
    """A source's library name hashes the headers beside it: an edited
    header rebuilds every library, other files change nothing."""
    from recommendit_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.source_digest("k", tmp_path)
    assert len(first) == 16 and _build.source_digest("k", tmp_path) == first
    (tmp_path / "notes.py").write_text("x = 1\n")
    assert _build.source_digest("k", tmp_path) == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build.source_digest("k", tmp_path)
    assert second != first
    (tmp_path / "g.cuh").write_text("// one\n")
    assert _build.source_digest("k", tmp_path) not in (first, second)
    assert _build.source_digest("window_mips") != _build.source_digest("window_mips_i8")


def test_processes_started_together_build_a_library_once(tmp_path):
    """Four processes that load one library at once (the ranks of a job)
    run its build once, under the build directory's file lock, and each
    loads the one library: nvcc stands in as a script that counts its
    runs, waits and copies a loadable shared object."""
    import _ctypes
    import os
    import subprocess
    import sys
    from pathlib import Path

    csrc, build, runs = tmp_path / "csrc", tmp_path / "build", tmp_path / "runs"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"""#!{sys.executable}
import shutil, sys, time
with open({str(runs)!r}, "a") as f:
    f.write("run\\n")
time.sleep(1.0)
shutil.copy({_ctypes.__file__!r}, sys.argv[sys.argv.index("-o") + 1])
""")
    nvcc.chmod(0o755)
    code = f"""
from pathlib import Path
from recommendit_tpu_torch.ops import _build
_build.CSRC_DIR, _build.BUILD_DIR = Path({str(csrc)!r}), Path({str(build)!r})
_build._nvcc = lambda: {str(nvcc)!r}
_build.load_library("k")
"""
    root = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert runs.read_text().splitlines() == ["run"]
    assert len(list(build.glob("libk-*.so"))) == 1


def _int8_queries(n_q, d, device, seed):
    g = torch.Generator().manual_seed(seed)
    q8, _ = quantize_queries(torch.randn(n_q, d, generator=g))
    return q8.to(device)


def _check_int8_launch(q8, e8, s, window, n_valid):
    """One counted launch through the wrapper, of the body its width picks,
    bit for bit the twin's."""
    before = mw.LAUNCHES["window_mips_i8"]
    mw.LAST_BODY["window_mips_i8"] = None
    kv, ka = mw.window_candidates_i8(q8, e8, s, window, n_valid)
    torch.cuda.synchronize()
    assert mw.LAUNCHES["window_mips_i8"] == before + 1
    assert mw.LAST_BODY["window_mips_i8"] == mw.int8_window_body(e8.shape[1])
    rv, ra = mw.window_candidates_i8_ref(q8, e8, s, window, n_valid)
    assert kv.shape == rv.shape == (-(-e8.shape[0] // window), q8.shape[0])
    assert ka.dtype == torch.int32
    assert torch.equal(kv, rv) and torch.equal(ka, ra)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 112, 128, 144, 384])
@pytest.mark.parametrize("n_q", [1, 100, 257, 1024])
@pytest.mark.parametrize("window", [1, 8, 64, 128, 512])
@pytest.mark.parametrize("n,n_valid", [(4096, 4096), (5000, 4801)])
def test_int8_tensor_core_body_matches_twin_bit_for_bit(cuda_device, d, n_q,
                                                        window, n, n_valid):
    """A K tail alone (16, 32), one 128-column box (112, 128), a box and a
    tail (144, the serve width), three boxes (384, the limit); query counts off the
    256-query tile; n_valid inside a 128-row tile."""
    assert mw.int8_window_body(d) == "tensor_cores"
    _, e8, s = _int8_corpus(n, d, n_valid, cuda_device, seed=d + window)
    _check_int8_launch(_int8_queries(n_q, d, cuda_device, n_q), e8, s, window,
                       n_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [2 ** i for i in range(10)])
def test_int8_tensor_core_body_every_window(cuda_device, window):
    _, e8, s = _int8_corpus(5000, 144, 4801, cuda_device, seed=window)
    _check_int8_launch(_int8_queries(257, 144, cuda_device, window), e8, s,
                       window, 4801)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 4, 8, 64, 128, 512])
def test_int8_tensor_core_body_keeps_the_first_of_ties(cuda_device, window):
    """Rows and queries in {-1, 0, 1} and one scale for every valid row:
    windows full of equal scores, the first-occurrence positions equal."""
    g = torch.Generator().manual_seed(window)
    q8 = torch.randint(-1, 2, (300, 144), generator=g).to(torch.int8)
    e8 = torch.randint(-1, 2, (5000, 144), generator=g).to(torch.int8)
    s = torch.full((5000,), 0.25)
    s[4801:] = 0.0
    _check_int8_launch(q8.to(cuda_device), e8.to(cuda_device), s.to(cuda_device),
                       window, 4801)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [400, 1024])
@pytest.mark.parametrize("window", [8, 512])
def test_wide_int8_rows_take_the_dp4a_body(cuda_device, d, window):
    assert mw.int8_window_body(d) == "cuda_cores"
    _, e8, s = _int8_corpus(5000, d, 4801, cuda_device, seed=d)
    _check_int8_launch(_int8_queries(100, d, cuda_device, d), e8, s, window, 4801)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["cuda_cores", "tensor_cores"])
def test_int8_bodies_agree_at_the_serve_width(cuda_device, body):
    """At the serve width the dp4a body (through its own entry, which the
    wrapper takes only for wider rows) and the tensor-core body give the
    twin's maxima and positions."""
    q8, e8, s = _int8_corpus(20_000, 144, 19_001, cuda_device, seed=1)
    kv, ka = mw._window_candidates_i8_cuda(q8, e8, s, 64, 19_001, body=body)
    assert mw.LAST_BODY["window_mips_i8"] == body
    rv, ra = mw.window_candidates_i8_ref(q8, e8, s, 64, 19_001)
    assert torch.equal(kv, rv) and torch.equal(ka, ra)


@pytest.mark.cuda
def test_int8_tensor_core_body_rejects_misaligned_operands(cuda_device):
    """A corpus that starts off a 16-byte boundary raises; scales that do
    are copied to an aligned start, and the tensor cores give the twin's
    output."""
    q8, e8, s = _int8_corpus(1025, 144, 1025, cuda_device)
    shifted = e8.view(-1)[1:1 + 1024 * 144].view(1024, 144)   # 1-byte offset
    with pytest.raises(ValueError, match="16-byte aligned"):
        mw.window_candidates_i8(q8, shifted, s[:1024], 8)
    assert s[1:].data_ptr() % 16
    _check_int8_launch(q8, e8[:1024], s[1:], 8, 1024)


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
    assert chip_smoke.fold_f64_err(q, items, kv, ki) <= chip_smoke.FOLD_F64_LIMIT


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


# The tensor-core body: bins of 8-64 rows (R = 32, 16, 8, 4 at bn = 256),
# widths 8 and 16 (the tail box alone), 129 (zero-padded to 136) and 136,
# one query to a full 1,024 (a ragged second query tile at 129), N a
# multiple of the block, not, and 2·bn + 1 (a block of one real row and a
# tile wholly past the corpus).
FOLD_TC_BLOCK = 256
FOLD_TC_OUTS = [8, 16, 32, 64]
FOLD_TC_DIMS = [8, 16, 129, 136]
FOLD_TC_QS = [1, 100, 129, 1024]
FOLD_TC_NS = [2048, 1900, 2 * FOLD_TC_BLOCK + 1]


def _fold_tc_launch(q, items, out):
    """One fold call that must take the tensor-core body: one fold and one
    split launch."""
    before = dict(mf.LAUNCHES)
    mf.LAST_BODY["fold_mips"] = None
    kv, ki = mf.fold_candidates(q, items, FOLD_TC_BLOCK, FOLD_TC_BLOCK // out)
    torch.cuda.synchronize()
    assert mf.LAST_BODY["fold_mips"] == "tensor_cores"
    assert mf.LAUNCHES == {"fold_mips": before["fold_mips"] + 1,
                           "fold_split": before["fold_split"] + 1}
    return kv, ki


@pytest.mark.cuda
@pytest.mark.parametrize("n", FOLD_TC_NS)
@pytest.mark.parametrize("n_q", FOLD_TC_QS)
@pytest.mark.parametrize("d", FOLD_TC_DIMS)
@pytest.mark.parametrize("out", FOLD_TC_OUTS)
def test_fold_tensor_core_body_matches_twin(cuda_device, out, d, n_q, n):
    g = torch.Generator().manual_seed(n + d + out)
    q = torch.randn(n_q, d, generator=g).to(cuda_device)
    items = torch.randn(n, d, generator=g)
    items = (items / items.norm(dim=1, keepdim=True)).to(torch.bfloat16).to(cuda_device)
    kv, ki = _fold_tc_launch(q, items, out)
    rv, ri = mf.fold_candidates_ref(q, items, FOLD_TC_BLOCK, FOLD_TC_BLOCK // out)
    assert kv.shape == rv.shape and ki.dtype == torch.int32
    torch.testing.assert_close(kv, rv, atol=1e-4, rtol=0)
    assert (ki == ri).float().mean() >= 0.999
    assert chip_smoke.fold_f64_err(q, items, kv, ki) <= chip_smoke.FOLD_F64_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("n", FOLD_TC_NS)
@pytest.mark.parametrize("n_q", FOLD_TC_QS)
@pytest.mark.parametrize("d", FOLD_TC_DIMS)
@pytest.mark.parametrize("out", FOLD_TC_OUTS)
def test_fold_tensor_core_body_keeps_the_tournament_ties(cuda_device, out, d, n_q, n):
    """Integer queries split with mid = lo = 0, so every sum is exact and
    only the tie rule and the pad rows can differ."""
    g = torch.Generator().manual_seed(n * out + d)
    q = torch.randint(-1, 2, (n_q, d), generator=g).float().to(cuda_device)
    items = torch.randint(-1, 2, (n, d), generator=g).to(torch.bfloat16).to(cuda_device)
    kv, ki = _fold_tc_launch(q, items, out)
    rv, ri = mf.fold_candidates_ref(q, items, FOLD_TC_BLOCK, FOLD_TC_BLOCK // out)
    assert torch.equal(kv, rv) and torch.equal(ki, ri)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 129, 136])
@pytest.mark.parametrize("out", FOLD_TC_OUTS)
def test_fold_tensor_core_body_keeps_the_third_piece(cuda_device, out, d):
    """Queries whose lo piece moves every score by ~4e-6·Σ|q_k·x_k|: the
    kernel's scores stay within the f64 limit, the twin fed hi + mid alone
    (what a kernel without lo computes) reads above it."""
    q, items = chip_smoke.lo_heavy_inputs(1900, d, 129, cuda_device, seed=out + d)
    kv, ki = _fold_tc_launch(q, items, out)
    assert chip_smoke.fold_f64_err(q, items, kv, ki) <= chip_smoke.FOLD_F64_LIMIT
    hi, mid, _ = mf.split_bf16x3(q).float()
    tv, ti = mf.fold_candidates_ref(hi + mid, items, FOLD_TC_BLOCK, FOLD_TC_BLOCK // out)
    assert chip_smoke.fold_f64_err(q, items, tv, ti) > 2 * chip_smoke.FOLD_F64_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("out", FOLD_TC_OUTS)
def test_fold_tensor_core_body_is_deterministic(cuda_device, out):
    q, items = _corpus(70_000, 136, torch.bfloat16, cuda_device, seed=out)
    a = mf.fold_candidates(q, items, 2048, 2048 // out)
    b = mf.fold_candidates(q, items, 2048, 2048 // out)
    assert mf.LAST_BODY["fold_mips"] == "tensor_cores"
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,block,r", [
    (torch.float32, 136, 2048, 64),    # an f32 corpus
    (torch.float32, 8, 256, 32),
    (torch.bfloat16, 136, 2048, 16),   # out = 128
    (torch.bfloat16, 136, 2048, 8),    # out = 256
    (torch.bfloat16, 136, 2048, 1024),   # out = 2
    (torch.bfloat16, 152, 2048, 64),   # rows past FOLD_TC_MAX_DIM
    (torch.bfloat16, 200, 2048, 32),
    (torch.bfloat16, 136, 64, 8),      # a block below one 128-row tile
])
def test_fold_other_shapes_take_the_cuda_core_body(cuda_device, dtype, d, block, r):
    q, items = _corpus(5000, d, dtype, cuda_device, seed=d + r)
    split = mf.LAUNCHES["fold_split"]
    kv, ki = mf.fold_candidates(q, items, block, r)
    torch.cuda.synchronize()
    assert mf.LAST_BODY["fold_mips"] == "cuda_cores"
    assert mf.LAUNCHES["fold_split"] == split
    rv, ri = mf.fold_candidates_ref(q, items, block, r)
    torch.testing.assert_close(kv, rv, atol=1e-4, rtol=0)
    assert (ki == ri).float().mean() >= 0.999
    assert chip_smoke.fold_f64_err(q, items, kv, ki) <= chip_smoke.FOLD_F64_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["cuda_cores", "tensor_cores"])
def test_fold_bodies_agree_on_ties(cuda_device, body):
    """Both entries on one tensor-core shape, through the wrapper's body
    argument: equal to the twin bit for bit on integer inputs."""
    g = torch.Generator().manual_seed(3)
    q = torch.randint(-1, 2, (300, 129), generator=g).float().to(cuda_device)
    items = torch.randint(-1, 2, (9000, 129), generator=g).to(torch.bfloat16).to(cuda_device)
    kv, ki = mf._fold_candidates_cuda(q, items, 2048, 64, body=body)
    assert mf.LAST_BODY["fold_mips"] == body
    rv, ri = mf.fold_candidates_ref(q, items, 2048, 64)
    assert torch.equal(kv, rv) and torch.equal(ki, ri)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8), (100, 129), (1024, 136)])
def test_split_kernel_matches_twin_bit_for_bit(cuda_device, shape):
    g = torch.Generator().manual_seed(shape[0])
    q = torch.randn(shape, generator=g) * 10.0 ** torch.randint(-20, 20, (shape[0], 1),
                                                               generator=g)
    before = mf.LAUNCHES["fold_split"]
    got = mf.split_queries(q.to(cuda_device))
    torch.cuda.synchronize()
    assert mf.LAUNCHES["fold_split"] == before + 1
    want = mf.split_bf16x3(q)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_fold_tensor_core_body_refuses_an_f32_corpus(cuda_device):
    q, items = _corpus(4096, 136, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="bf16 corpus"):
        mf._fold_candidates_cuda(q, items, 2048, 64, body="tensor_cores")


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
