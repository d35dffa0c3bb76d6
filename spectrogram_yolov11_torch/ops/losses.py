"""The detect training loss over padded batches.

Counterpart of the detect part of spectrogram_yolov11_tpu/ops/losses.py:43-175
(_bce_logits, df_loss, bbox_loss, preprocess_targets, detection_loss), with
the same reductions:

  cls   = BCE(logits, target scores).sum() / max(target_scores.sum(), 1)
  box   = sum((1 - CIoU) * w) / target_scores_sum, w = target_scores.sum(-1) on fg anchors
  dfl   = the weighted two-bin cross-entropy, summed the same way
  items = (box * hyp_box, cls * hyp_cls, dfl * hyp_dfl), total = items.sum() * batch

Boxes are masked, not indexed, so every shape is fixed and nothing syncs
with the host. The assigner sees sigmoid(scores) and the decoded boxes
without gradient, and runs under no_grad. The head's maps come in the port's
NCHW (box, cls) pairs and are flattened in the JAX anchor order (level, h, w).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .decode import bbox2dist, dist2bbox, make_anchors
from .iou import bbox_iou
from .tal import task_aligned_assign


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in the JAX form (no reduction)."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def df_loss(pred_dist_logits: torch.Tensor, target: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution focal loss: cross-entropy on the two integer bins around
    each target distance. pred_dist_logits (..., 4, reg_max), target (..., 4)
    within [0, reg_max - 1.01] -> (..., 1), the mean over the four sides."""
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist_logits, -1)
    ce_l = -logp.gather(-1, tl[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr.clamp(max=reg_max - 1)[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(-1, keepdim=True)


def bbox_loss(pred_dist_logits: torch.Tensor, pred_bboxes: torch.Tensor, anchor_points: torch.Tensor,
              target_bboxes: torch.Tensor, target_scores: torch.Tensor, target_scores_sum: torch.Tensor,
              fg_mask: torch.Tensor, reg_max: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(CIoU loss, DFL loss) over the fg anchors, in grid units."""
    weight = target_scores.sum(-1) * fg_mask  # (b, A)
    iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, CIoU=True)
    loss_iou = ((1.0 - iou) * weight).sum() / target_scores_sum
    ldfl = df_loss(pred_dist_logits, bbox2dist(anchor_points, target_bboxes, reg_max - 1), reg_max)[..., 0]
    return loss_iou, (ldfl * weight).sum() / target_scores_sum


def preprocess_targets(cls: torch.Tensor, bboxes: torch.Tensor, mask_gt: torch.Tensor, imgsz: float):
    """Normalised xywh GT (b, g, 4) -> (labels (b, g, 1), xyxy pixels (b, g, 4) zeroed on pad rows, mask (b, g, 1))."""
    xy, wh = bboxes[..., :2] * imgsz, bboxes[..., 2:4] * imgsz
    gt_xyxy = torch.cat([xy - wh / 2, xy + wh / 2], -1) * mask_gt[..., None]
    return cls[..., None], gt_xyxy, mask_gt[..., None]


def detection_loss(feats: List[Tuple[torch.Tensor, torch.Tensor]], cls: torch.Tensor, bboxes: torch.Tensor,
                   mask_gt: torch.Tensor, nc: int, reg_max: int = 16, imgsz: int = 640,
                   strides: Sequence[float] = (8.0, 16.0, 32.0), hyp_box: float = 7.5, hyp_cls: float = 0.5,
                   hyp_dfl: float = 1.5, tal_topk: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """v8DetectionLoss on the head's per-level (box (b, 4*reg_max, H, W), cls
    (b, nc, H, W)) logits and the padded GT: cls (b, g) int, bboxes (b, g, 4)
    normalised xywh, mask_gt (b, g) bool. Returns (total, items (box, cls,
    dfl) without gradient)."""
    b = feats[0][0].shape[0]
    dev = feats[0][0].device
    anchor_points, stride_t = make_anchors([tuple(bx.shape[-2:]) for bx, _ in feats], strides, dev)
    box_flat = torch.cat([bx.flatten(2) for bx, _ in feats], 2).transpose(1, 2).float()  # (b, A, 4*reg_max)
    pred_dist_logits = box_flat.reshape(b, -1, 4, reg_max)
    pred_scores = torch.cat([c.flatten(2) for _, c in feats], 2).transpose(1, 2).float()  # (b, A, nc)

    bins = torch.arange(reg_max, dtype=torch.float32, device=dev)
    pd = F.softmax(pred_dist_logits, -1) @ bins
    pred_bboxes = dist2bbox(pd, anchor_points[None], xywh=False)  # (b, A, 4) grid units

    gt_labels, gt_xyxy, mask_gt3 = preprocess_targets(cls, bboxes, mask_gt, float(imgsz))
    with torch.no_grad():
        assign = task_aligned_assign(torch.sigmoid(pred_scores), pred_bboxes * stride_t[None],
                                     anchor_points * stride_t, gt_labels, gt_xyxy, mask_gt3, topk=tal_topk,
                                     num_classes=nc)
    target_bboxes = assign.target_bboxes / stride_t[None]
    target_scores_sum = assign.target_scores.sum().clamp(min=1.0)

    loss_cls = bce_logits(pred_scores, assign.target_scores).sum() / target_scores_sum
    loss_iou, loss_dfl = bbox_loss(pred_dist_logits, pred_bboxes, anchor_points, target_bboxes,
                                   assign.target_scores, target_scores_sum, assign.fg_mask, reg_max)
    items = torch.stack([hyp_box * loss_iou, hyp_cls * loss_cls, hyp_dfl * loss_dfl])
    return items.sum() * b, items.detach()
