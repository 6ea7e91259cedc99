"""The port's fold MIPS (plain twin of ``csrc/fold_mips.cu`` on the CPU)
against the JAX package's ``mips_topk_fused`` with its Pallas fold kernel in
interpret mode.

Random float inputs: ids equal after ``canonical_tie_order``, values within
1e-5 (f32 sums in another order). Integer-valued inputs full of ties: every
candidate (k = the candidate count, so no tie straddles the k-th place),
values and ids equal bit for bit after ``canonical_tie_order`` — the sums
are exact, so only the tie rule can differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from recommendit_tpu.ops import pallas_mips as jpm
from recommendit_tpu.ops import topk as jtopk
from recommendit_tpu_torch import ops
from recommendit_tpu_torch.ops import mips_fold as mf
from recommendit_tpu_torch.ops import topk


def _canon(v, i):
    if isinstance(v, torch.Tensor):
        return [a.numpy() for a in topk.canonical_tie_order(v, i)]
    return [np.asarray(a) for a in jtopk.canonical_tie_order(jnp.asarray(v),
                                                             jnp.asarray(i))]


def _both(qs, items, k, block, r, dtype=np.float32):
    jit_items = jnp.asarray(items, dtype)
    j = jpm.mips_topk_fused(jnp.asarray(qs), jit_items, k, block, r, True)
    t_items = torch.tensor(np.asarray(jit_items, np.float32))
    if dtype != np.float32:
        t_items = t_items.to(torch.bfloat16)
    t = mf.mips_topk_fused_ref(torch.as_tensor(qs), t_items, k, block, r)
    return _canon(*t), _canon(*j)


# (Q, N, D, k, block_items, reduction): N % bn == 0 (no bias column) and not
FLOAT_CASES = [
    (8, 4096, 32, 50, 1024, 32),
    (8, 5000, 32, 50, 1024, 32),
    (5, 3001, 16, 40, 512, 8),
    (4, 700, 24, 20, 2048, 16),
]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("case", FLOAT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fold_matches_jax(case, dtype):
    q, n, d, k, block, r = case
    rng = np.random.default_rng(n + r)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    items = rng.normal(size=(n, d)).astype(np.float32)
    (tv, ti), (jv, ji) = _both(qs, items, k, block, r,
                               np.float32 if dtype == np.float32 else jnp.bfloat16)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", range(6))
def test_integer_ties_bit_for_bit(seed):
    """Values in {-1, 0, 1}: most bins hold ties, and N is rarely a
    multiple of the block, so pad bins take part too."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 300))
    qs = rng.integers(-1, 2, size=(3, 4)).astype(np.float32)
    items = rng.integers(-1, 2, size=(n, 4)).astype(np.float32)
    bn, out, n_blocks = mf.fold_shape(n, 1, 16, 4)
    (tv, ti), (jv, ji) = _both(qs, items, n_blocks * out, 16, 4)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_pad_bins_score_the_pad_value(dtype):
    """N = 2·bn + 1: the last block holds one real row and bn − 1 pad rows,
    so bins of pad rows alone are candidates, at -3e38 in the corpus dtype
    and with ids past N, as in JAX."""
    rng = np.random.default_rng(11)
    n, block, r = 2 * 64 + 1, 64, 4
    qs = rng.normal(size=(3, 8)).astype(np.float32)
    items = rng.normal(size=(n, 8)).astype(np.float32)
    k = 3 * (64 // r)
    jdt = np.float32 if dtype == np.float32 else jnp.bfloat16
    (tv, ti), (jv, ji) = _both(qs, items, k, block, r, jdt)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    pad = mf.pad_score(tdt)
    assert (tv[:, -15:] == pad).all() and (ti[:, -15:] >= n).all()
    assert (tv[:, :-15] > pad).all()


def test_ties_go_to_the_smallest_bit_reversed_slab():
    """R = 4: bin 0 collects rows 0, 4, 8, 12 (slabs j = 0..3). With slabs 1
    and 2 tied at the maximum, the halving keeps slab 2 (bit-reversed 1 <
    2); with 1 and 3 tied, slab 1."""
    q = torch.ones(1, 1)
    for tied, winner in (((1, 2), 2), ((1, 3), 1), ((0, 3), 0)):
        items = torch.zeros(16, 1)
        for j in tied:
            items[4 * j] = 5.0
        vals, ids = mf.fold_candidates_ref(q, items, 16, 4)
        assert float(vals[0, 0]) == 5.0 and int(ids[0, 0]) == 4 * winner


@pytest.mark.parametrize("kwargs,match", [
    (dict(n=300, k=301), "exceeds corpus size"),
    (dict(n=4096, k=200, block_items=1024, reduction=32), "exceeds candidate count"),
])
def test_guards_match_jax(kwargs, match):
    rng = np.random.default_rng(0)
    n, k = kwargs.pop("n"), kwargs.pop("k")
    qs = rng.normal(size=(2, 8)).astype(np.float32)
    items = rng.normal(size=(n, 8)).astype(np.float32)
    block, r = kwargs.get("block_items", 2048), kwargs.get("reduction", 32)
    with pytest.raises(ValueError, match=match):
        jpm.mips_topk_fused(jnp.asarray(qs), jnp.asarray(items), k, block, r, True)
    with pytest.raises(ValueError, match=match):
        ops.mips_topk_fused(torch.as_tensor(qs), torch.as_tensor(items), k, block, r)


def test_non_power_of_two_block_raises():
    with pytest.raises(ValueError, match="power-of-two"):
        mf.fold_shape(5000, 10, 3000, 32)


def test_queries_are_not_rounded():
    """bf16 corpus: the fold scores f32 queries against the widened rows,
    where the window kernels round the queries to bf16 first."""
    rng = np.random.default_rng(3)
    qs = torch.as_tensor(rng.normal(size=(4, 32)).astype(np.float32))
    items = torch.as_tensor(rng.normal(size=(1024, 32)).astype(np.float32))
    items = items.to(torch.bfloat16)
    vals, ids = mf.mips_topk_fused_ref(qs, items, 1, 1024, 1024)
    exact = (qs.double() @ items.double().T).max(dim=1)
    np.testing.assert_allclose(vals[:, 0].numpy(), exact.values.numpy(), rtol=1e-6)
    assert torch.equal(ids[:, 0], exact.indices)


def test_cpu_tensor_takes_the_twin():
    rng = np.random.default_rng(5)
    qs = torch.as_tensor(rng.normal(size=(6, 16)).astype(np.float32))
    items = torch.as_tensor(rng.normal(size=(3001, 16)).astype(np.float32))
    before = dict(mf.LAUNCHES)
    a = mf.fold_candidates(qs, items, 512, 8)
    b = mf.fold_candidates_ref(qs, items, 512, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[1].dtype == torch.int32 and a[0].shape == (6, 6 * 64)
    assert mf.LAUNCHES == before


def test_other_device_raises():
    q = torch.empty(4, 16, device="meta")
    items = torch.empty(64, 16, device="meta")
    with pytest.raises(ValueError, match="no fold kernel"):
        mf.fold_candidates(q, items, 16, 4)


# --- the tensor-core body's arithmetic and epilogue, checked on the CPU ---

@pytest.mark.parametrize("dtype,d,bn,out,body", [
    (torch.bfloat16, 136, 2048, 32, "tensor_cores"),
    (torch.bfloat16, 129, 2048, 64, "tensor_cores"),   # zero-padded to 136
    (torch.bfloat16, 144, 2048, 32, "tensor_cores"),   # the widest
    (torch.bfloat16, 145, 2048, 32, "cuda_cores"),     # 152: one stage left
    (torch.bfloat16, 1, 128, 8, "tensor_cores"),       # zero-padded to 8
    (torch.float32, 136, 2048, 32, "cuda_cores"),
    (torch.float32, 8, 128, 8, "cuda_cores"),
    (torch.bfloat16, 136, 64, 8, "cuda_cores"),        # block below a tile
    (torch.bfloat16, 136, 128, 8, "tensor_cores"),
    (torch.bfloat16, 136, 2048, 4, "cuda_cores"),
    (torch.bfloat16, 136, 2048, 8, "tensor_cores"),
    (torch.bfloat16, 136, 2048, 64, "tensor_cores"),
    (torch.bfloat16, 136, 2048, 128, "cuda_cores"),
    (torch.bfloat16, 136, 16384, 512, "cuda_cores"),
])
def test_fold_body_boundaries(dtype, d, bn, out, body):
    assert mf.fold_body(dtype, d, bn, out) == body


def _wide_f32(rng, shape):
    """Random f32 bit patterns with exponents 2^-87 .. 2^88 and both signs:
    far from bf16's subnormals, so the three pieces stay exact."""
    exp = rng.integers(40, 216, size=shape, dtype=np.uint32)
    mant = rng.integers(0, 1 << 23, size=shape, dtype=np.uint32)
    sign = rng.integers(0, 2, size=shape, dtype=np.uint32)
    return torch.as_tensor((sign << 31 | exp << 23 | mant).view(np.float32))


@pytest.mark.parametrize("seed", range(3))
def test_split_bf16x3_is_exact(seed):
    """hi + mid + lo == q bit for bit, summed in f32 in that order and in
    f64; two pieces are not enough."""
    rng = np.random.default_rng(seed)
    q = torch.cat([_wide_f32(rng, (512, 129)),
                   torch.as_tensor(rng.normal(size=(64, 129)).astype(np.float32)),
                   torch.tensor([[0.0, -0.0, 1.0, -2.0 ** -60, 3.0e38] + [0.0] * 124])])
    pieces = mf.split_bf16x3(q)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (3, *q.shape)
    hi, mid, lo = pieces.float()
    assert torch.equal(hi + mid + lo, q)
    assert torch.equal(hi.double() + mid.double() + lo.double(), q.double())
    assert (hi + mid != q).float().mean() > 0.9


def test_split_queries_on_the_cpu_takes_the_twin():
    q = torch.as_tensor(np.random.default_rng(2).normal(size=(7, 24)).astype(np.float32))
    before = dict(mf.LAUNCHES)
    assert torch.equal(mf.split_queries(q), mf.split_bf16x3(q))
    assert mf.LAUNCHES == before
    with pytest.raises(ValueError, match="no split kernel"):
        mf.split_queries(torch.empty(4, 8, device="meta"))


def _to_f32(x: torch.Tensor, truncate: bool) -> torch.Tensor:
    """f64 ``x`` rounded to f32 (to nearest, or toward zero), as f64."""
    near = x.float()
    if truncate:
        toward = torch.nextafter(near, torch.zeros_like(near))
        near = torch.where(near.double().abs() > x.abs(), toward, near)
    return near.double()


def _kernel_order_scores(pieces, items, n_pieces: int, truncate: bool):
    """The tensor-core body's sums: per 16-column k-step the first
    ``n_pieces`` pieces in turn, each m64n128k16 product (16 exact terms)
    added into one f32 accumulator, rounded to f32 at each add."""
    acc = torch.zeros(pieces.shape[1], items.shape[0], dtype=torch.float64)
    for k0 in range(0, items.shape[1], 16):
        for p in pieces[:n_pieces]:
            acc = _to_f32(acc + p[:, k0:k0 + 16].double() @ items[:, k0:k0 + 16].double().T,
                          truncate)
    return acc


@pytest.mark.parametrize("seed", range(2))
def test_three_piece_scores_hold_the_f32_bound(seed):
    """The tensor-core scores, the three pieces' exact products summed in
    f32, stay within the C.22 bound of the f32 twin's scores: two f32 sums
    of n = 3·D terms in different orders, 2(n−1)·2⁻²⁴·Σ|t| apart at most.
    That bound is loose enough for two pieces too, so the kernel's own
    order of sums (rounded to nearest or truncated at each wgmma) is also
    held to half of ``chip_smoke.FOLD_F64_LIMIT``·Σ|t| of f64 (the card's
    tensor cores read about 0.36 of the limit, this model 0.25), on
    wide-scale queries and on queries whose third piece is large
    (``lo_heavy_inputs``), where every score of two pieces reads above the
    limit."""
    rng = np.random.default_rng(seed)
    d = 136
    q = torch.as_tensor((rng.normal(size=(64, d))
                         * 10.0 ** rng.uniform(-3, 3, size=(64, 1))).astype(np.float32))
    items = torch.as_tensor(rng.normal(size=(2048, d)).astype(np.float32))
    items = (items / items.norm(dim=1, keepdim=True)).to(torch.bfloat16).float()
    pieces = mf.split_bf16x3(q).float()
    with topk.full_f32_matmul():
        three = pieces[0] @ items.T + pieces[1] @ items.T + pieces[2] @ items.T
        twin = q @ items.T
    terms = sum(p.double().abs() @ items.double().abs().T for p in pieces)
    bound = 2 * (3 * d - 1) * 2.0 ** -24 * terms
    assert ((three.double() - twin.double()).abs() <= bound).all()
    exact = q.double() @ items.double().T
    assert ((three.double() - exact).abs() <= bound / 2).all()

    lq, li = chip_smoke.lo_heavy_inputs(512, d, 64, "cpu", seed)
    lo_pieces = mf.split_bf16x3(lq)
    assert torch.equal(lo_pieces.double().sum(0), lq.double())
    lo_share = (lo_pieces[2].double().abs() / lq.double().abs()).median()
    assert 2.0 ** -19 < lo_share < 2.0 ** -17
    limit = chip_smoke.FOLD_F64_LIMIT
    for x, rows in ((q, items), (lq, li.float())):
        p = mf.split_bf16x3(x)
        exact = x.double() @ rows.double().T
        mag = x.double().abs() @ rows.double().abs().T
        for truncate in (False, True):
            err = (_kernel_order_scores(p, rows, 3, truncate) - exact).abs() / mag
            assert err.max() <= limit / 2
    # the lo-heavy inputs, the last of the loop: every score off without lo
    two = (_kernel_order_scores(p, rows, 2, False) - exact).abs() / mag
    assert two.min() > limit and two.max() > 2 * limit


def _brev32(x):
    x = np.asarray(x, np.uint32)
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                        (8, 0x00FF00FF)):
        x = ((x >> shift) & np.uint32(mask)) | ((x & np.uint32(mask)) << shift)
    return (x >> 16) | (x << 16)


def _emulate_tc_fold(scores, n, bn, out, pad, sms=132):
    """numpy mirror of ``fold_tc_kernel``'s grid and epilogue: consumer
    thread (warpgroup wg, warp w, lane l) and accumulator register i give the
    query row 64wg + 16w + l/4 + 8((i>>1)&1) and the tile column
    8(i>>2) + 2(l%4) + (i&1); each bin's running (max, bit-reversed slab)
    is carried across a corpus block's 128-row tiles and stored two bins at
    a time at the block's end. Columns past the corpus score ``pad``."""
    n_q = scores.shape[0]
    n_blocks = -(-n // bn)
    kg, km = out // 8, 128 // out
    wg, w, lane = (a.ravel() for a in np.meshgrid(np.arange(2), np.arange(4),
                                                  np.arange(32), indexing="ij"))
    c = lane % 4
    vals = np.full((n_q, n_blocks * out), np.nan, np.float32)
    ids = np.full((n_q, n_blocks * out), -1, np.int64)
    n_qtiles = -(-n_q // 128)
    per = max(1, min(sms // n_qtiles, n_blocks))
    for x in range(n_qtiles * per):
        qt, p = x % n_qtiles, x // n_qtiles
        q_row = qt * 128 + wg * 64 + w * 16 + lane // 4
        for blk in range(p, n_blocks, per):
            v = np.full((256, 2, out // 4), -np.inf, np.float32)
            vr = np.full((256, 2, out // 4), 0xFFFFFFFF, np.uint32)
            for t in range(bn // 128):
                r0 = blk * bn + t * 128
                lim = min(max(n - r0, 0), 128)
                for i in range(64):
                    jj, h, e = i >> 2, (i >> 1) & 1, i & 1
                    col = 8 * jj + 2 * c + e
                    s = scores[np.minimum(q_row + 8 * h, n_q - 1),
                               np.minimum(r0 + col, n - 1)]
                    s = np.where(col < lim, s, np.float32(pad))
                    rj = _brev32(t * km + jj // kg)
                    b = 2 * (jj % kg) + e
                    win = (s > v[:, h, b]) | ((s == v[:, h, b]) & (rj < vr[:, h, b]))
                    v[:, h, b] = np.where(win, s, v[:, h, b])
                    vr[:, h, b] = np.where(win, rj, vr[:, h, b])
            for h in range(2):
                q = q_row + 8 * h
                ok = q < n_q
                for b in range(out // 4):
                    col = blk * out + 8 * (b // 2) + 2 * c[ok] + b % 2
                    assert np.isnan(vals[q[ok], col]).all()      # written once
                    vals[q[ok], col] = v[ok, h, b]
                    ids[q[ok], col] = (blk * bn + 8 * (b // 2) + 2 * c[ok] + b % 2
                                       + _brev32(vr[ok, h, b]).astype(np.int64) * out)
    assert not np.isnan(vals).any()
    return vals, ids


@pytest.mark.parametrize("out", [8, 16, 32, 64])
@pytest.mark.parametrize("n,n_q,bn", [(1024, 129, 256), (1000, 100, 256),
                                      (2 * 256 + 1, 129, 256), (700, 3, 128)])
def test_tensor_core_epilogue_emulation_matches_the_twin(out, n, n_q, bn):
    """Integer inputs full of ties (every score exact, through the three
    pieces too): the kernel's lane mapping, tie rule, pad columns, tiles
    wholly past the corpus (N = 2·bn + 1) and stores give the twin's values
    and ids bit for bit."""
    rng = np.random.default_rng(n + out)
    q = torch.as_tensor(rng.integers(-1, 2, size=(n_q, 4)).astype(np.float32))
    items = torch.as_tensor(rng.integers(-1, 2, size=(n, 4)).astype(np.float32))
    items = items.to(torch.bfloat16)
    assert mf.fold_body(items.dtype, 4, bn, out) == "tensor_cores"
    pieces = mf.split_bf16x3(q).double()
    scores = sum(p @ items.double().T for p in pieces).float().numpy()
    vals, ids = _emulate_tc_fold(scores, n, bn, out, mf.pad_score(torch.bfloat16))
    rv, ri = mf.fold_candidates_ref(q, items, bn, bn // out)
    np.testing.assert_array_equal(vals, rv.numpy())
    np.testing.assert_array_equal(ids, ri.numpy())

