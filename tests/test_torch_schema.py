"""The port's copy of the feature contract equals the JAX package's, and
its torch assembly equals ``assemble_packed_np`` (atol 1e-6: the genre
affinity is a dot of 18 terms summed in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import recommendit_tpu.features.schema as jax_schema
import recommendit_tpu_torch.features.schema as schema

CONSTANTS = [
    "N_GENRES", "USER_SCALAR_COLS", "ITEM_SCALAR_COLS", "INTERACTION_COLS",
    "USER_GENRE_COLS", "ITEM_GENRE_COLS", "USER_PACKED_DIM",
    "ITEM_PACKED_DIM", "N_FEATURES", "GATHER_PAD_WIDTH", "FEATURE_COLUMNS",
]


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_matches_jax(name):
    assert getattr(schema, name) == getattr(jax_schema, name)


def _inputs(seed, c, width):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=schema.USER_PACKED_DIM).astype(np.float32)
    u[1] = abs(u[1])
    items = rng.normal(size=(c, width)).astype(np.float32)
    items[:, 1] = np.abs(items[:, 1]) + 0.1
    items[:, 5:23] = rng.integers(0, 2, size=(c, 18))
    return u, items


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), c=st.integers(1, 70),
       width=st.sampled_from([23, 30, 64]))
def test_assemble_packed_matches_numpy(seed, c, width):
    u, items = _inputs(seed, c, width)
    want = jax_schema.assemble_packed_np(u, items)
    got = schema.assemble_packed(torch.as_tensor(u), torch.as_tensor(items))
    assert got.shape == (c, 50)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_batched_assembly_matches_rowwise(seed):
    rows = [_inputs(100 * seed + b, 17, 64) for b in range(5)]
    u = torch.as_tensor(np.stack([r[0] for r in rows]))
    items = torch.as_tensor(np.stack([r[1] for r in rows]))
    got = schema.assemble_packed(u, items)
    assert got.shape == (5, 17, 50)
    for b, (ub, ib) in enumerate(rows):
        np.testing.assert_allclose(got[b].numpy(),
                                   jax_schema.assemble_packed_np(ub, ib),
                                   atol=1e-6, rtol=0)


def test_assembly_matches_jnp():
    u, items = _inputs(9, 500, 64)
    want = np.asarray(jax_schema.assemble_packed_jnp(jnp.asarray(u),
                                                     jnp.asarray(items)))
    got = schema.assemble_packed(torch.as_tensor(u), torch.as_tensor(items))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_pad_packed_width(kind):
    table = np.arange(46, dtype=np.float32).reshape(2, 23)
    want = jax_schema.pad_packed_width(table)
    arg = table if kind == "numpy" else torch.as_tensor(table)
    got = schema.pad_packed_width(arg)
    assert got.shape == (2, 64)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert schema.pad_packed_width(want) is want
