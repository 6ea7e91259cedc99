"""Where the port's entry points run: the card unless the caller names the
CPU. Without a card a call that names no device raises; nothing falls
back."""
from __future__ import annotations

import subprocess

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


def platform_name(device) -> str:
    """What a report's ``platform`` names: "cpu", or the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (``torch.cuda.get_device_name``
    and "power limit not read" where ``nvidia-smi`` cannot be run)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"
