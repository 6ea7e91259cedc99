"""The port's row gather (plain twin of ``csrc/gather_rows.cu`` on the CPU)
against the JAX package's Pallas gather in interpret mode, at the shapes of
``tests/test_gather.py``. Row copies: equal bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.ops.gather import gather_rows as jax_gather_rows
from recommendit_tpu.ops.gather import take_rows as jax_take_rows
from recommendit_tpu_torch.ops import gather


def _table(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# (N, D, index shape, JAX block, JAX lag, seed): tests/test_gather.py's cases
CASES = [
    (5000, 23, (16, 37), 256, 8, 0),
    (1000, 128, (300,), 128, 4, 1),
    (500, 16, (131,), 128, 4, 2),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}-{c[2]}")
@pytest.mark.parametrize("fn", ["gather_rows", "take_rows"])
def test_matches_jax_gather(case, fn):
    n, d, shape, block, lag, seed = case
    tbl = _table(n, d, seed)
    idx = np.random.default_rng(seed).integers(0, n, size=shape).astype(np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(tbl), jnp.asarray(idx),
                                      block, lag, True))
    got = getattr(gather, fn)(torch.as_tensor(tbl), torch.as_tensor(idx))
    assert tuple(got.shape) == shape + (d,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_out_of_range_indices_clamp_like_jax(dtype):
    tbl = _table(200, 16, 4)
    idx = np.asarray([-5, 0, 199, 200, 10_000])
    want = np.asarray(jax_gather_rows(jnp.asarray(tbl),
                                      jnp.asarray(idx, jnp.int32), 128, 4, True))
    np.testing.assert_array_equal(
        want, np.asarray(jax_take_rows(jnp.asarray(tbl), jnp.asarray(idx))))
    got = gather.gather_rows(torch.as_tensor(tbl), torch.as_tensor(idx).to(dtype))
    np.testing.assert_array_equal(got.numpy(), want)


def test_zero_dim_index_and_other_dtypes():
    tbl = torch.arange(60, dtype=torch.float32).view(12, 5)
    assert torch.equal(gather.gather_rows(tbl, torch.tensor(3)), tbl[3])
    assert torch.equal(gather.gather_rows(tbl, torch.tensor(99)), tbl[11])
    small = torch.tensor([[1, -1], [40, 2]], dtype=torch.int16)
    assert torch.equal(gather.gather_rows(tbl.to(torch.bfloat16), small),
                       tbl.to(torch.bfloat16)[torch.tensor([[1, 0], [11, 2]])])
    assert gather.gather_rows(tbl, torch.empty(0, 4, dtype=torch.int64)).shape == (0, 4, 5)


def test_cpu_tensor_takes_the_twin():
    tbl = torch.as_tensor(_table(300, 23, 5))
    idx = torch.randint(-10, 320, (7, 9), generator=torch.Generator().manual_seed(0))
    before = dict(gather.LAUNCHES)
    assert torch.equal(gather.gather_rows(tbl, idx), gather.gather_rows_ref(tbl, idx))
    assert gather.LAUNCHES == before


@pytest.mark.parametrize("table,idx,err", [
    (torch.zeros(4, 3, 2), torch.tensor([0]), ValueError),
    (torch.zeros(0, 3), torch.tensor([0]), ValueError),
    (torch.zeros(4, 3), torch.tensor([0.5]), TypeError),
    (torch.zeros(4, 3), torch.tensor([True]), TypeError),
])
def test_bad_arguments_raise(table, idx, err):
    with pytest.raises(err):
        gather.gather_rows(table, idx)


def test_other_device_raises():
    with pytest.raises(ValueError, match="no gather kernel"):
        gather.gather_rows(torch.empty(4, 3, device="meta"),
                           torch.empty(2, dtype=torch.int64, device="meta"))
