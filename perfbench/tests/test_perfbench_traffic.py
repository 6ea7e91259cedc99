"""The one generator: the same seed gives the same batches."""
from __future__ import annotations

import pytest
import torch

from perfbench.traffic import make_batches

MIX = {"loop": "closed", "batch": 33, "pool": 5, "trace_seconds": 1,
       "columns": {"user": {"over": "users", "dist": "uniform"},
                   "item": {"over": "items", "dist": "uniform"}}}
SIZES = {"users": 1000, "items": 50}


def test_same_seed_same_batches():
    a = make_batches(MIX, 2**31 + 99, SIZES, "cpu")
    b = make_batches(MIX, 2**31 + 99, SIZES, "cpu")
    assert len(a) == 5
    for x, y in zip(a, b):
        assert torch.equal(x["user"], y["user"]) and torch.equal(x["item"], y["item"])


def test_other_seed_other_ids_same_sizes():
    a = make_batches(MIX, 1, SIZES, "cpu")
    b = make_batches(MIX, 2, SIZES, "cpu")
    assert any(not torch.equal(x["user"], y["user"]) for x, y in zip(a, b))
    for x in a + b:
        assert x["user"].shape == (33,) and x["item"].shape == (33,)
        assert int(x["user"].min()) >= 1 and int(x["user"].max()) <= 1000
        assert int(x["item"].min()) >= 1 and int(x["item"].max()) <= 50


def test_batches_of_a_pool_differ():
    a = make_batches(MIX, 5, SIZES, "cpu")
    assert not torch.equal(a[0]["user"], a[1]["user"])


def test_unknown_distribution_is_refused():
    mix = dict(MIX, columns={"user": {"over": "users", "dist": "zipf"}})
    with pytest.raises(ValueError):
        make_batches(mix, 1, SIZES, "cpu")
