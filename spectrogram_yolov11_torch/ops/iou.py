"""IoU (torch). Counterpart of spectrogram_yolov11_tpu/ops/iou.py: box_iou (:17)
and bbox_iou (:27), whose CIoU drives both the TAL assigner's metric and the
box loss, mask_iou (:118), the segment validator's mask matching,
kpt_iou (:125), the pose validator's OKS, and the OBB task's probiou (:87,
with _rbox_covariance :78) and batch_probiou (:113): the assigner's metric,
the box loss, rotated NMS and the validator's matching."""

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


def mask_iou(mask1: torch.Tensor, mask2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(N, HW) x (M, HW) binary masks -> (N, M) IoU, summed in f32 (JAX iou.py:118)."""
    m1, m2 = mask1.float(), mask2.float()
    inter = m1 @ m2.T
    return inter / (m1.sum(-1)[:, None] + m2.sum(-1)[None] - inter + eps)


def kpt_iou(kpt1: torch.Tensor, kpt2: torch.Tensor, area: torch.Tensor, sigma, eps: float = 1e-7) -> torch.Tensor:
    """OKS between ground truth (N, K, 3) and predicted (M, K, 2|3) keypoints
    with the ground truths' areas (N,) -> (N, M) (JAX iou.py:125); a ground
    truth's keypoints of visibility 0 count for nothing."""
    d = (kpt1[:, None, :, 0] - kpt2[None, :, :, 0]) ** 2 + (kpt1[:, None, :, 1] - kpt2[None, :, :, 1]) ** 2
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=kpt1.device)
    kpt_mask = kpt1[..., 2] != 0  # (N, K)
    e = d / ((2 * sigma) ** 2) / (area[:, None, None] + eps) / 2
    oks = torch.exp(-e) * kpt_mask[:, None]
    return oks.sum(-1) / (kpt_mask.sum(-1)[:, None] + eps)


def _rbox_covariance(boxes: torch.Tensor):
    """(a, b, c) covariance terms of rotated boxes (..., 5) cx cy w h angle (JAX iou.py:78)."""
    a, b, c = boxes[..., 2] ** 2 / 12, boxes[..., 3] ** 2 / 12, boxes[..., 4]
    cos, sin = torch.cos(c), torch.sin(c)
    cos2, sin2 = cos**2, sin**2
    return a * cos2 + b * sin2, a * sin2 + b * cos2, (a - b) * cos * sin


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, CIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise probabilistic IoU (1 - Hellinger distance of the boxes'
    Gaussians) of broadcastable rotated boxes (..., 5) -> (...) (JAX iou.py:87),
    term for term; with CIoU the aspect term v * alpha, alpha without gradient."""
    x1, y1 = obb1[..., 0], obb1[..., 1]
    x2, y2 = obb2[..., 0], obb2[..., 1]
    a1, b1, c1 = _rbox_covariance(obb1)
    a2, b2, c2 = _rbox_covariance(obb2)
    den = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / (den + eps) * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / (den + eps) * 0.5
    t3 = torch.log(den / (4 * torch.sqrt((a1 * b1 - c1**2).clamp(min=0) * (a2 * b2 - c2**2).clamp(min=0)) + eps)
                   + eps) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    iou = 1 - torch.sqrt(1.0 - torch.exp(-bd) + eps)
    if CIoU:
        w1, h1, w2, h2 = obb1[..., 2], obb1[..., 3], obb2[..., 2], obb2[..., 3]
        v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():
            alpha = v / (v - iou + (1 + eps))
        return iou - v * alpha
    return iou


def batch_probiou(obb1: torch.Tensor, obb2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise probiou: (..., N, 5) x (..., M, 5) -> (..., N, M) (JAX iou.py:113)."""
    return probiou(obb1[..., :, None, :], obb2[..., None, :, :], eps=eps)
