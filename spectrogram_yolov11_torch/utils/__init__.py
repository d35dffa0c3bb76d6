"""Small helpers shared by the port."""

from __future__ import annotations

import math

import torch


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round a channel count up to the nearest multiple of `divisor`."""
    return math.ceil(x / divisor) * divisor


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default and is never
    replaced by the CPU: without a card a CUDA request raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA card is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
