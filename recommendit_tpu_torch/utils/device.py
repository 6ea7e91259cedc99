"""Where the port's entry points run: the card unless the caller names the
CPU. Without a card a call that names no device raises; nothing falls
back."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} needs an NVIDIA GPU and none is available; "
            "pass device='cpu' to run on the CPU")
    return dev
