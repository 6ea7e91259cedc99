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
