"""Small helpers shared by the port."""

from __future__ import annotations

import contextlib
import math
import os
import threading
from pathlib import Path

import torch

REPO_ROOT = Path(__file__).resolve().parents[2]
RUNS_DIR = Path(os.getenv("SYT_RUNS_DIR", REPO_ROOT / "runs"))


class SimpleClass:
    """Readable repr and attribute errors that list the class's docstring."""

    def __str__(self):
        attr = []
        for a in dir(self):
            v = getattr(self, a)
            if not callable(v) and not a.startswith("_"):
                attr.append(f"{a}: {v.__class__.__module__}.{v.__class__.__name__} object")
        return f"{self.__class__.__module__}.{self.__class__.__name__} object with attributes:\n\n" + "\n".join(attr)

    def __repr__(self):
        return self.__str__()

    def __getattr__(self, attr):
        raise AttributeError(f"'{self.__class__.__name__}' object has no attribute '{attr}'. "
                             f"See valid attributes below.\n{self.__doc__}")


def increment_path(path: str | Path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    """runs/exp -> runs/exp2, runs/exp3, ... unless exist_ok."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{path}{sep}{n}{suffix}"
            if not os.path.exists(p):
                path = Path(p)
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round a channel count up to the nearest multiple of `divisor`."""
    return math.ceil(x / divisor) * divisor


_f32_lock = threading.Lock()
_f32_state = {"inside": 0, "saved": None}  # callers inside full_f32, and the settings to restore when the last leaves


@contextlib.contextmanager
def full_f32():
    """The port's precision policy, as a context or a decorator: f32 work on
    the card runs in full f32, with TF32 off for cuDNN convolutions (torch
    leaves it on by default) and cuBLAS matmuls while any caller is inside;
    the settings, which are process-wide, come back when the last one leaves,
    so nested and concurrent callers (threads) all run in f32. The network's
    forward and the plain bottleneck run under it, and so does the device
    function of a predict or serve batch (engine/pipeline.py)."""
    with _f32_lock:
        if _f32_state["inside"] == 0:
            _f32_state["saved"] = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        _f32_state["inside"] += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_state["inside"] -= 1
            if _f32_state["inside"] == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _f32_state["saved"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default and is never
    replaced by the CPU: without a card a CUDA request raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA card is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
