"""IoU (torch). Counterpart of spectrogram_yolov11_tpu/ops/iou.py: box_iou (:17)
and bbox_iou (:27), whose CIoU drives both the TAL assigner's metric and the
box loss."""

from __future__ import annotations

import math

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


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, GIoU: bool = False, DIoU: bool = False,
             CIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU (or GIoU, DIoU, CIoU) of broadcastable box pairs, last
    dim 4 -> the broadcast shape without it. The JAX form term for term: in
    xyxy mode eps is added to the heights only, and CIoU's alpha carries no
    gradient."""
    if xywh:
        (x1, y1, w1, h1), (x2, y2, w2, h2) = box1.chunk(4, -1), box2.chunk(4, -1)
        w1_, h1_, w2_, h2_ = w1 / 2, h1 / 2, w2 / 2, h2 / 2
        b1x1, b1x2, b1y1, b1y2 = x1 - w1_, x1 + w1_, y1 - h1_, y1 + h1_
        b2x1, b2x2, b2y1, b2y2 = x2 - w2_, x2 + w2_, y2 - h2_, y2 + h2_
    else:
        (b1x1, b1y1, b1x2, b1y2), (b2x1, b2y1, b2x2, b2y2) = box1.chunk(4, -1), box2.chunk(4, -1)
        w1, h1 = b1x2 - b1x1, (b1y2 - b1y1) + eps
        w2, h2 = b2x2 - b2x1, (b2y2 - b2y1) + eps

    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0) * (
        torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (GIoU or DIoU or CIoU):
        return iou.squeeze(-1)
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    if CIoU or DIoU:
        c2 = cw**2 + ch**2 + eps
        rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
        if CIoU:
            v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
            with torch.no_grad():
                alpha = v / (v - iou + (1 + eps))
            return (iou - (rho2 / c2 + v * alpha)).squeeze(-1)
        return (iou - rho2 / c2).squeeze(-1)
    c_area = cw * ch + eps
    return (iou - (c_area - union) / c_area).squeeze(-1)
