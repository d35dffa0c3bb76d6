"""Box coordinate ops (torch). Counterpart of spectrogram_yolov11_tpu/ops/boxes.py:23."""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4+) center-size boxes -> corner boxes; trailing columns ride along."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh / 2
    return torch.cat([xy - half, xy + half, x[..., 4:]], dim=-1)
