"""Train-state checkpoints — torch port of ``recommendit_tpu/utils/checkpoint.py``.

A train state is a nested dict of tensors (params, optimizer moments and
step count, epoch, loss). It is written with ``torch.save`` to one file,
through a temporary file and a rename so a crash mid-write leaves the
previous checkpoint whole, and read back with ``torch.load(weights_only=True)``,
which unpickles tensors and containers only. The JAX package writes Orbax
directories; neither package reads the other's checkpoints.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any, Dict

import torch

logger = logging.getLogger(__name__)


def save_train_state(path: str, state: Dict[str, Any]) -> None:
    """Save ``state`` at ``path`` (overwrites); tensors are copied to the CPU."""
    p = Path(path).absolute()
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + ".tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, p)
    logger.info("Saved train state to %s", p)


def load_train_state(path: str, device="cpu") -> Dict[str, Any]:
    """The state saved at ``path``, its tensors on ``device``."""
    p = Path(path).absolute()
    if p.is_dir():
        raise ValueError(
            f"{p} is a directory (an Orbax checkpoint of the JAX package?); "
            "the port reads only its own torch.save files")
    if not p.exists():
        raise FileNotFoundError(f"No checkpoint at {p}")
    return torch.load(p, map_location=device, weights_only=True)


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x
