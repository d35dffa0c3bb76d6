"""The detect, segment, pose, OBB and classify training losses over padded batches.

Counterpart of spectrogram_yolov11_tpu/ops/losses.py:43-175 (_bce_logits,
df_loss, bbox_loss, preprocess_targets, detection_loss), :177
classification_loss, :223 segmentation_loss, :285 keypoint_loss_terms, :304
pose_loss, :377 obb_loss and :435 e2e_detection_loss (v10's dual
assignment), with the same reductions:

  cls   = BCE(logits, target scores).sum() / max(target_scores.sum(), 1)
  box   = sum((1 - CIoU) * w) / target_scores_sum, w = target_scores.sum(-1) on fg anchors
  dfl   = the weighted two-bin cross-entropy, summed the same way
  items = (box * hyp_box, cls * hyp_cls, dfl * hyp_dfl), total = items.sum() * batch
  segment: the same terms and seg, the mask BCE below; items = (box, seg * hyp_box, cls, dfl)
  pose: the same terms, the OKS location loss and the visibility BCE;
        items = (box, pose * hyp_pose, kobj * hyp_kobj, cls, dfl)
  obb:  the rotated assignment (probiou), box = sum((1 - probiou) * w) /
        target_scores_sum, DFL on the target's unrotated extent; items (box, cls, dfl)
  classify: the mean softmax cross-entropy of the logits; items = (nll,), total = nll

Boxes are masked, not indexed, so every shape is fixed and nothing syncs
with the host. The assigner sees sigmoid(scores) and the decoded boxes
without gradient, and runs under no_grad. The head's maps come in the port's
NCHW (box, cls) pairs and are flattened in the JAX anchor order (level, h, w).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .decode import bbox2dist, dist2bbox, dist2rbox, make_anchors
from .iou import bbox_iou, probiou
from .masks import crop_mask
from .metrics import OKS_SIGMA
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


def _head_logits(feats: List[Tuple[torch.Tensor, torch.Tensor]], reg_max: int, strides: Sequence[float]):
    """The head's per-level (box, cls) logits flattened in the anchor order:
    (anchor points (A, 2) and strides (A, 1) of make_anchors, DFL logits (b,
    A, 4, reg_max) f32, class logits (b, A, nc) f32, the DFL integral (b, A,
    4) LTRB distances in grid units)."""
    b, dev = feats[0][0].shape[0], feats[0][0].device
    anchor_points, stride_t = make_anchors([tuple(bx.shape[-2:]) for bx, _ in feats], strides, dev)
    box_flat = torch.cat([bx.flatten(2) for bx, _ in feats], 2).transpose(1, 2).float()  # (b, A, 4*reg_max)
    pred_dist_logits = box_flat.reshape(b, -1, 4, reg_max)
    pred_scores = torch.cat([c.flatten(2) for _, c in feats], 2).transpose(1, 2).float()  # (b, A, nc)
    pd = F.softmax(pred_dist_logits, -1) @ torch.arange(reg_max, dtype=torch.float32, device=dev)
    return anchor_points, stride_t, pred_dist_logits, pred_scores, pd


def _detect_terms(feats: List[Tuple[torch.Tensor, torch.Tensor]], cls: torch.Tensor, bboxes: torch.Tensor,
                  mask_gt: torch.Tensor, nc: int, reg_max: int, imgsz: int, strides: Sequence[float], tal_topk: int):
    """The detect loss's terms and the assignment: (assign, loss_iou,
    loss_cls, loss_dfl), unweighted (JAX _assign_for_feats and the head of
    detection_loss)."""
    anchor_points, stride_t, pred_dist_logits, pred_scores, pd = _head_logits(feats, reg_max, strides)
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
    return assign, loss_iou, loss_cls, loss_dfl


def detection_loss(feats: List[Tuple[torch.Tensor, torch.Tensor]], cls: torch.Tensor, bboxes: torch.Tensor,
                   mask_gt: torch.Tensor, nc: int, reg_max: int = 16, imgsz: int = 640,
                   strides: Sequence[float] = (8.0, 16.0, 32.0), hyp_box: float = 7.5, hyp_cls: float = 0.5,
                   hyp_dfl: float = 1.5, tal_topk: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """v8DetectionLoss on the head's per-level (box (b, 4*reg_max, H, W), cls
    (b, nc, H, W)) logits and the padded GT: cls (b, g) int, bboxes (b, g, 4)
    normalised xywh, mask_gt (b, g) bool. Returns (total, items (box, cls,
    dfl) without gradient)."""
    _, loss_iou, loss_cls, loss_dfl = _detect_terms(feats, cls, bboxes, mask_gt, nc, reg_max, imgsz, strides,
                                                    tal_topk)
    items = torch.stack([hyp_box * loss_iou, hyp_cls * loss_cls, hyp_dfl * loss_dfl])
    return items.sum() * feats[0][0].shape[0], items.detach()


def e2e_detection_loss(out: dict, cls: torch.Tensor, bboxes: torch.Tensor, mask_gt: torch.Tensor, nc: int,
                       reg_max: int = 16, imgsz: int = 640, strides: Sequence[float] = (8.0, 16.0, 32.0),
                       hyp_box: float = 7.5, hyp_cls: float = 0.5,
                       hyp_dfl: float = 1.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """v10's dual-assignment loss (JAX losses.py:435): detection_loss of the
    one2many branch with TAL topk 10 plus that of the one2one branch with
    topk 1; the totals and the items summed."""
    kw = dict(nc=nc, reg_max=reg_max, imgsz=imgsz, strides=strides, hyp_box=hyp_box, hyp_cls=hyp_cls,
              hyp_dfl=hyp_dfl)
    t1, i1 = detection_loss(out["one2many"], cls, bboxes, mask_gt, tal_topk=10, **kw)
    t2, i2 = detection_loss(out["one2one"], cls, bboxes, mask_gt, tal_topk=1, **kw)
    return t1 + t2, i1 + i2


def segmentation_loss(feats: List[Tuple[torch.Tensor, torch.Tensor]], mask_coeffs: torch.Tensor, proto: torch.Tensor,
                      cls: torch.Tensor, bboxes: torch.Tensor, mask_gt: torch.Tensor, gt_masks: torch.Tensor, nc: int,
                      reg_max: int = 16, imgsz: int = 640, strides: Sequence[float] = (8.0, 16.0, 32.0),
                      hyp_box: float = 7.5, hyp_cls: float = 0.5, hyp_dfl: float = 1.5, max_fg: int = 128,
                      overlap: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """v8SegmentationLoss as JAX's segmentation_loss (losses.py:223): the
    detect terms, then the mask term over the max_fg foreground anchors of
    each image with the highest target score (a stable descending sort cut
    at max_fg, as jax.lax.top_k breaks ties by the lower index): for each,
    BCE(coeff @ proto, its ground-truth instance of the index-encoded
    gt_masks (b, hm, wm), pixel = index + 1) cropped to its target box in
    mask pixels and divided by the box's area (at least 1), averaged over
    the selected foreground anchors. mask_coeffs (b, A, nm) and proto (b,
    nm, hm, wm) are upcast to f32, as JAX's. overlap=False raises JAX's
    ValueError: its branch takes a (b, K, 1, 1) index along axis 1 of the
    3-D gt_masks; so does max_fg above the anchor count (top_k's check: an
    image under 80 px). Returns (total, items (box, seg, cls, dfl) without
    gradient)."""
    if not overlap:
        raise ValueError(f"indices and arr must have the same number of dimensions; 4 vs. {gt_masks.ndim}")
    assign, loss_iou, loss_cls, loss_dfl = _detect_terms(feats, cls, bboxes, mask_gt, nc, reg_max, imgsz, strides,
                                                         10)
    b, nm, hm, wm = proto.shape
    if max_fg > assign.fg_mask.shape[1]:  # jax.lax.top_k's check
        raise ValueError(f"k argument to top_k must be no larger than size along axis; got k={max_fg} with "
                         f"shape={list(assign.fg_mask.shape)} and axis=1")
    score_rank = assign.target_scores.sum(-1).masked_fill(~assign.fg_mask, -1.0)
    sel = torch.sort(score_rank, dim=1, descending=True, stable=True)[1][:, :max_fg]  # (b, K) anchors
    sel_fg = assign.fg_mask.gather(1, sel).float()
    sel_gt_idx = assign.target_gt_idx.gather(1, sel)
    sel_coeff = mask_coeffs.float().gather(1, sel[..., None].expand(-1, -1, nm))  # (b, K, nm)
    sel_boxes = assign.target_bboxes.gather(1, sel[..., None].expand(-1, -1, 4))  # (b, K, 4) pixels
    pred_masks = torch.einsum("bkn,bnhw->bkhw", sel_coeff, proto.float())
    gt_m = (gt_masks[:, None] == (sel_gt_idx[..., None, None] + 1)).float()
    boxes_m = sel_boxes * (hm / float(imgsz))  # to mask pixels
    cropped = crop_mask(bce_logits(pred_masks, gt_m), boxes_m)
    area = ((boxes_m[..., 2] - boxes_m[..., 0]) * (boxes_m[..., 3] - boxes_m[..., 1])).clamp(min=1.0)
    per_anchor = cropped.sum((-2, -1)) / area  # the crop's BCE averaged over the box's pixels
    loss_mask = (per_anchor * sel_fg).sum() / sel_fg.sum().clamp(min=1.0)
    items = torch.stack([hyp_box * loss_iou, hyp_box * loss_mask, hyp_cls * loss_cls, hyp_dfl * loss_dfl])
    return items.sum() * b, items.detach()


def keypoint_loss_terms(pred_xy: torch.Tensor, gt_xy: torch.Tensor, kpt_mask: torch.Tensor, area: torch.Tensor,
                        sigmas: torch.Tensor) -> torch.Tensor:
    """The OKS keypoint-location loss per entry (JAX losses.py:285): pred_xy
    and gt_xy (..., nk, 2), kpt_mask (..., nk), area (..., 1), sigmas (nk,)
    -> (..., nk) terms (1 - exp(-e)) * mask * nk / (visible count + 1e-9),
    e = d^2 / (2 sigma)^2 / (area + 1e-9) / 2."""
    d2 = ((pred_xy - gt_xy) ** 2).sum(-1)
    e = d2 / (2 * sigmas) ** 2 / (area + 1e-9) / 2
    kpt_loss_factor = kpt_mask.shape[-1] / ((kpt_mask != 0).sum(-1, keepdim=True) + 1e-9)
    return (1 - torch.exp(-e)) * kpt_mask * kpt_loss_factor


def pose_loss(feats: List[Tuple[torch.Tensor, torch.Tensor]], pred_kpts_raw: torch.Tensor, cls: torch.Tensor,
              bboxes: torch.Tensor, mask_gt: torch.Tensor, gt_kpts: torch.Tensor, nc: int,
              kpt_shape: Tuple[int, int] = (17, 3), reg_max: int = 16, imgsz: int = 640,
              strides: Sequence[float] = (8.0, 16.0, 32.0), hyp_box: float = 7.5, hyp_cls: float = 0.5,
              hyp_dfl: float = 1.5, hyp_pose: float = 12.0, hyp_kobj: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """v8PoseLoss as JAX's pose_loss (losses.py:304): the detect terms, then
    over the foreground anchors the OKS location loss of the keypoints
    decoded in grid units (raw xy * 2 + anchor - 0.5) against each anchor's
    ground truth (gt_kpts (b, g, nk, nd), normalised xy and visibility, in
    grid units of the anchor's stride), with OKS_SIGMA at 17 keypoints and
    1 / nk otherwise, and the visibility BCE when nd = 3 (0 when nd = 2),
    each the mean over keypoints averaged over foreground anchors. JAX picks
    each anchor's ground truth with a one-hot einsum; the gather here gives
    the same numbers. pred_kpts_raw (b, A, nk * nd) is upcast to f32.
    Returns (total, items (box, pose, kobj, cls, dfl) without gradient)."""
    nk, nd = kpt_shape
    assign, loss_iou, loss_cls, loss_dfl = _detect_terms(feats, cls, bboxes, mask_gt, nc, reg_max, imgsz, strides,
                                                         10)
    b = feats[0][0].shape[0]
    anchor_points, stride_t = make_anchors([tuple(bx.shape[-2:]) for bx, _ in feats], strides, feats[0][0].device)
    y = pred_kpts_raw.float().reshape(b, -1, nk, nd)
    xy = y[..., :2] * 2.0 + (anchor_points[None, :, None, :] - 0.5)  # grid units
    g = gt_kpts.shape[1]
    idx = assign.target_gt_idx[..., None, None]
    sel_gt = gt_kpts.float().gather(1, idx.expand(-1, -1, nk, gt_kpts.shape[-1])) if g else \
        torch.zeros(b, y.shape[1], nk, gt_kpts.shape[-1], device=y.device)
    sel_xy = sel_gt[..., :2] * imgsz / stride_t[None, :, None, :]
    if nd == 3:
        kpt_mask = (sel_gt[..., 2] != 0).float()
    else:
        kpt_mask = torch.ones(xy.shape[:-1], device=xy.device)
    tb = assign.target_bboxes / stride_t[None]  # grid units xyxy
    area = ((tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1])).clamp(min=1e-9)[..., None]
    if nk == 17:
        sigmas = torch.as_tensor(OKS_SIGMA, dtype=torch.float32, device=xy.device)
    else:
        sigmas = torch.full((nk,), 1.0 / nk, dtype=torch.float32, device=xy.device)
    loc = keypoint_loss_terms(xy, sel_xy, kpt_mask, area, sigmas)
    fgw = assign.fg_mask.float()
    n_fg = fgw.sum().clamp(min=1.0)
    loss_kpt = (loc.mean(-1) * fgw).sum() / n_fg
    if nd == 3:
        loss_kobj = (bce_logits(y[..., 2], kpt_mask).mean(-1) * fgw).sum() / n_fg
    else:
        loss_kobj = torch.zeros((), device=xy.device)
    items = torch.stack([hyp_box * loss_iou, hyp_pose * loss_kpt, hyp_kobj * loss_kobj, hyp_cls * loss_cls,
                         hyp_dfl * loss_dfl])
    return items.sum() * b, items.detach()


def obb_loss(feats: List[Tuple[torch.Tensor, torch.Tensor]], pred_angle: torch.Tensor, cls: torch.Tensor,
             bboxes: torch.Tensor, mask_gt: torch.Tensor, nc: int, reg_max: int = 16, imgsz: int = 640,
             strides: Sequence[float] = (8.0, 16.0, 32.0), hyp_box: float = 7.5, hyp_cls: float = 0.5,
             hyp_dfl: float = 1.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """v8OBBLoss as JAX's obb_loss (losses.py:377) on the head's per-level
    (box, cls) logits, its raw angles (b, A, 1) and the padded GT: cls (b, g)
    int, bboxes (b, g, 5) normalised cx cy w h and the angle in radians,
    mask_gt (b, g) bool. The predicted rotated boxes (DFL distances turned by
    the angle (sigmoid(raw) - 0.25) * pi) go to the rotated assigner in
    pixels; the box loss is (1 - clip(probiou, 0)) weighted by the target
    scores, in grid units; the DFL is taken on the target's unrotated extent
    (its centre -+ w/2, h/2 as xyxy). Returns (total, items (box, cls, dfl)
    without gradient)."""
    anchor_points, stride_t, pred_dist_logits, pred_scores, pd = _head_logits(feats, reg_max, strides)
    angle = (torch.sigmoid(pred_angle.float()) - 0.25) * math.pi  # (b, A, 1)
    pred_rbox = dist2rbox(pd, angle, anchor_points[None])  # grid units, cx cy w h

    gt_rbox = torch.cat([bboxes[..., :4] * imgsz, bboxes[..., 4:5]], -1) * mask_gt[..., None]
    with torch.no_grad():
        assign = task_aligned_assign(torch.sigmoid(pred_scores), torch.cat([pred_rbox * stride_t[None], angle], -1),
                                     anchor_points * stride_t, cls[..., None], gt_rbox, mask_gt[..., None],
                                     num_classes=nc, rotated=True)
    target_scores_sum = assign.target_scores.sum().clamp(min=1.0)
    loss_cls = bce_logits(pred_scores, assign.target_scores).sum() / target_scores_sum

    tb = assign.target_bboxes  # (b, A, 5) pixels
    tb_grid = torch.cat([tb[..., :4] / stride_t[None], tb[..., 4:5]], -1)
    weight = assign.target_scores.sum(-1) * assign.fg_mask
    iou = probiou(torch.cat([pred_rbox, angle], -1), tb_grid).clamp(min=0)
    loss_iou = ((1.0 - iou) * weight).sum() / target_scores_sum
    half = tb_grid[..., 2:4] / 2
    txyxy = torch.cat([tb_grid[..., :2] - half, tb_grid[..., :2] + half], -1)
    ldfl = df_loss(pred_dist_logits, bbox2dist(anchor_points, txyxy, reg_max - 1), reg_max)[..., 0]
    loss_dfl = (ldfl * weight).sum() / target_scores_sum
    items = torch.stack([hyp_box * loss_iou, hyp_cls * loss_cls, hyp_dfl * loss_dfl])
    return items.sum() * feats[0][0].shape[0], items.detach()


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total, items (nll,)): the mean softmax cross-entropy of logits (B, nc)
    against integer labels (B,), in f32 (JAX :177)."""
    logp = torch.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, labels.long()[:, None]).mean()
    return nll, nll.detach()[None]
