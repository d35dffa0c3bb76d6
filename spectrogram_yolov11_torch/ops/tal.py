"""Task-aligned assignment (TAL) of the detect and OBB losses, on fixed-shape padded GT.

Counterpart of spectrogram_yolov11_tpu/ops/tal.py: select_candidates_in_gts
(:32), select_topk_candidates (:43), select_highest_overlaps (:71) and
task_aligned_assign (:85) with its rotated branch (:106-110: the OBB loss's,
overlaps clip(probiou, 0) and anchors inside a rotated box by
_select_candidates_in_rotated_gts :156 over rbox2corners :173), with the
same masks in place of boolean indexing, so it runs on the card with no host
sync.

Ties decide which anchors a GT gets, and they are common: every anchor of a
real GT inside its box is a top-k candidate, metric 0 included (JAX :47-53).
So the top k is taken by k passes of argmax, each of which returns the first
maximum, as JAX's does; torch.topk orders ties as it likes. The targets are
exact gathers where JAX contracts one-hot matrices (:140-142); in f32 on the
CPU those contractions are exact too.

Constants as in JAX: topk 10, alpha 0.5, beta 6.0, eps 1e-9.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .boxes import xywhr2xyxyxyxy
from .iou import bbox_iou, probiou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (b, A) int64
    target_bboxes: torch.Tensor  # (b, A, 4)
    target_scores: torch.Tensor  # (b, A, nc)
    fg_mask: torch.Tensor  # (b, A) bool
    target_gt_idx: torch.Tensor  # (b, A) int64


def select_candidates_in_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Anchor centers (A, 2) strictly inside xyxy GT boxes (b, g, 4) -> (b, g, A) bool."""
    lt = xy_centers[None, None] - gt_bboxes[:, :, None, :2]
    rb = gt_bboxes[:, :, None, 2:] - xy_centers[None, None]
    return torch.cat([lt, rb], -1).amin(-1) > eps


def select_topk_candidates(metrics: torch.Tensor, topk: int, topk_mask: torch.Tensor) -> torch.Tensor:
    """The top-k anchors of each GT by metric (b, g, A), ties to the lowest
    index, for the GT rows of topk_mask (b, g) -> (b, g, A) bool."""
    hits = torch.zeros_like(metrics, dtype=torch.bool)
    mm = metrics.clone()
    for _ in range(topk):
        idx = mm.argmax(-1, keepdim=True)
        hits.scatter_(-1, idx, True)
        mm.scatter_(-1, idx, float("-inf"))
    return hits & topk_mask[..., None].bool()


def select_highest_overlaps(mask_pos: torch.Tensor, overlaps: torch.Tensor, n_max_boxes: int):
    """An anchor claimed by several GTs goes to the one of highest overlap
    (the first on ties). Returns (target_gt_idx (b, A), fg_mask (b, A), mask_pos (b, g, A))."""
    fg_count = mask_pos.sum(-2)  # (b, A)
    best = torch.zeros_like(mask_pos).scatter_(-2, overlaps.argmax(-2, keepdim=True), True)
    mask_pos = torch.where((fg_count > 1)[:, None], best & (fg_count > 0)[:, None], mask_pos)
    fg_mask = mask_pos.any(-2)
    target_gt_idx = mask_pos.to(torch.uint8).argmax(-2)  # the first GT of each anchor (0 where none)
    return target_gt_idx, fg_mask, mask_pos


def task_aligned_assign(pd_scores: torch.Tensor, pd_bboxes: torch.Tensor, anc_points: torch.Tensor,
                        gt_labels: torch.Tensor, gt_bboxes: torch.Tensor, mask_gt: torch.Tensor, topk: int = 10,
                        num_classes: int = 80, alpha: float = 0.5, beta: float = 6.0,
                        rotated: bool = False, eps: float = 1e-9) -> AssignResult:
    """The assignment: align = score^alpha * CIoU^beta over the anchors inside
    each GT, the top k per GT, conflicts to the highest IoU, target scores
    normalised by align * max IoU / max align per GT.

    pd_scores (b, A, nc) sigmoid scores and pd_bboxes (b, A, 4) xyxy pixels,
    both without gradient; anc_points (A, 2) pixels; gt_labels (b, g, 1),
    gt_bboxes (b, g, 4) xyxy pixels, mask_gt (b, g, 1) the real GT rows.
    rotated=True (the OBB loss): pd_bboxes and gt_bboxes are (b, A, 5) and
    (b, g, 5) cx cy w h angle in pixels and radians, the overlap is
    clip(probiou, 0) and an anchor is inside a GT by the rotated test."""
    b, a, nc = pd_scores.shape
    n_max = gt_bboxes.shape[1]
    mask_gt_b = mask_gt[..., 0].bool()
    if rotated:
        in_gts = select_candidates_in_rotated_gts(anc_points, gt_bboxes)
        ov = probiou(gt_bboxes[:, :, None], pd_bboxes[:, None])
    else:
        in_gts = select_candidates_in_gts(anc_points, gt_bboxes, eps)
        ov = bbox_iou(gt_bboxes[:, :, None], pd_bboxes[:, None], xywh=False, CIoU=True)
    gt_cls = gt_labels[..., 0].long().clamp(0, nc - 1)  # (b, g)
    scores_at_gt = pd_scores.gather(2, gt_cls[:, None, :].expand(b, a, n_max)).transpose(1, 2)  # (b, g, A)

    mask_valid = in_gts & mask_gt_b[..., None]
    zero = pd_scores.new_zeros(())
    overlaps = torch.where(mask_valid, ov.clamp(min=0), zero)
    align_metric = torch.where(mask_valid, scores_at_gt**alpha * overlaps**beta, zero)

    mask_pos = select_topk_candidates(align_metric, topk, mask_gt_b) & mask_valid
    target_gt_idx, fg_mask, mask_pos = select_highest_overlaps(mask_pos, overlaps, n_max)

    target_labels = torch.where(fg_mask, gt_cls.gather(1, target_gt_idx), 0)
    target_bboxes = gt_bboxes.gather(1, target_gt_idx[..., None].expand(b, a, gt_bboxes.shape[-1]))
    target_scores = F.one_hot(target_labels, nc).to(pd_scores.dtype) * fg_mask[..., None]

    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(-1, keepdim=True)  # (b, g, 1)
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_metric * pos_overlap / (pos_align + eps)).amax(-2)  # (b, A)
    return AssignResult(target_labels, target_bboxes, target_scores * norm[..., None], fg_mask, target_gt_idx)


def rbox2corners(rbox: torch.Tensor) -> torch.Tensor:
    """(..., 5) cx cy w h angle -> (..., 4, 2) corners (JAX tal.py:173)."""
    return xywhr2xyxyxyxy(rbox)


def select_candidates_in_rotated_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor) -> torch.Tensor:
    """Anchor centers (A, 2) inside rotated GT boxes (b, g, 5) -> (b, g, A)
    bool (JAX tal.py:156): the projections of corner a -> point onto the
    sides ab and ad lie in [0, |ab|^2] and [0, |ad|^2], ends included."""
    corners = rbox2corners(gt_bboxes)  # (b, g, 4, 2)
    a, b, d = corners[..., 0, :], corners[..., 1, :], corners[..., 3, :]
    ab, ad = b - a, d - a
    ap = xy_centers[None, None] - a[:, :, None]  # (b, g, A, 2)
    norm_ab, norm_ad = (ab * ab).sum(-1)[..., None], (ad * ad).sum(-1)[..., None]
    ap_ab, ap_ad = (ap * ab[:, :, None]).sum(-1), (ap * ad[:, :, None]).sum(-1)
    return (ap_ab >= 0) & (ap_ab <= norm_ab) & (ap_ad >= 0) & (ap_ad <= norm_ad)
