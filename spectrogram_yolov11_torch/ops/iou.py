"""IoU (torch). Counterpart of spectrogram_yolov11_tpu/ops/iou.py:17 box_iou."""

from __future__ import annotations

import torch


def box_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M).

    The operation order is the JAX one, inter / (area1 + area2 - inter + eps),
    which the NMS kernel repeats bit for bit."""
    a1, a2 = box1[..., :, None, 0:2], box1[..., :, None, 2:4]
    b1, b2 = box2[..., None, :, 0:2], box2[..., None, :, 2:4]
    wh = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    s1 = (a2 - a1).clamp(min=0)
    s2 = (b2 - b1).clamp(min=0)
    return inter / (s1[..., 0] * s1[..., 1] + s2[..., 0] * s2[..., 1] - inter + eps)
