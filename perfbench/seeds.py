"""Seeded generators: every input of a run is drawn from ``--seed`` and a
tag naming what it is, so any part (one block of a table's rows, one
batch) can be drawn again alone."""
from __future__ import annotations

import hashlib

import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed of ``seed`` (any whole number) and ``tags``."""
    h = hashlib.blake2b(repr((int(seed),) + tuple(tags)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by ``derive(seed, *tags)``."""
    return torch.Generator(device=torch.device(device)).manual_seed(derive(seed, *tags))
