"""Batched fixed-shape NMS (torch). Counterparts of
spectrogram_yolov11_tpu/ops/nms.py:64 non_max_suppression and :124
non_max_suppression_extras (extra per-anchor columns, the segment head's
mask coefficients, carried through the selection), and :169 nms_rotated,
the OBB task's Fast-NMS over probiou (plain torch: JAX computes it in XLA,
outside any Pallas kernel, and the greedy keep kernel does not run on it).

    decoded preds (B, A, 4+nc)
      -> top-k candidates (best class, or every (anchor, class) pair with multi_label)
      -> class offset cls * max_wh (unless agnostic)
      -> exact greedy keep mask: the CUDA kernel of ops/nms_kernel.py
      -> the first max_det survivors in score order, zero-padded

Both top-k selections are a stable descending sort cut at k, because
jax.lax.top_k breaks ties by the lower index and torch.topk makes no such
promise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .boxes import xywh2xyxy
from .iou import batch_probiou
from .nms_kernel import greedy_keep


def _top(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, ties to the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_candidates(
    preds: torch.Tensor,
    conf_thres: float = 0.25,
    nc: int = 80,
    multi_label: bool = False,
    agnostic: bool = False,
    pre_nms_topk: int = 1024,
    max_wh: float = 7680.0,
    classes: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The k top-scoring candidates of each image, k = min(pre_nms_topk, A or A*nc).

    Returns (boxes (B, k, 4) xyxy, scores (B, k), cls (B, k) float, valid (B, k),
    offset_boxes (B, k, 4) contiguous: the boxes shifted by cls * max_wh unless
    agnostic, which is what the greedy keep kernel takes)."""
    return _candidates(preds, conf_thres, nc, multi_label, agnostic, pre_nms_topk, max_wh, classes)[:5]


def _candidates(preds, conf_thres, nc, multi_label=False, agnostic=False, pre_nms_topk=1024, max_wh=7680.0,
                classes=None):
    """nms_candidates' five tensors and the candidates' anchor indices (B, k)."""
    b, a, _ = preds.shape
    boxes_xywh = preds[..., :4]
    scores = preds[..., 4 : 4 + nc]
    if classes is not None:
        allowed = torch.zeros(nc, dtype=torch.bool, device=preds.device)
        allowed[torch.as_tensor(classes, dtype=torch.long, device=preds.device)] = True
        scores = torch.where(allowed, scores, torch.zeros((), dtype=scores.dtype, device=scores.device))
    k = torch.sym_min(pre_nms_topk, a * nc if multi_label else a)  # symbolic in a trace at a dynamic size
    if multi_label:
        top_scores, top_idx = _top(scores.reshape(b, -1), k)
        anchor = top_idx // nc
        cls = (top_idx % nc).float()
    else:
        best_cls = scores.argmax(-1)  # first maximum, as jnp.argmax
        top_scores, anchor = _top(scores.gather(-1, best_cls[..., None])[..., 0], k)
        cls = best_cls.gather(1, anchor).float()
    valid = top_scores > conf_thres
    boxes = xywh2xyxy(boxes_xywh.gather(1, anchor[..., None].expand(b, k, 4)))
    offset = torch.zeros_like(cls) if agnostic else cls * max_wh
    return boxes, top_scores, cls, valid, (boxes + offset[..., None]).contiguous(), anchor


def non_max_suppression(
    preds: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    nc: int = 80,
    multi_label: bool = False,
    agnostic: bool = False,
    max_det: int = 300,
    pre_nms_topk: int = 1024,
    max_wh: float = 7680.0,
    classes: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """preds (B, A, 4+nc) xywh + scores -> (out (B, max_det, 6), n_valid (B,)).

    Rows of `out` are [x1, y1, x2, y2, conf, cls], zero past n_valid."""
    boxes, top_scores, cls, valid, offset_boxes = nms_candidates(
        preds, conf_thres, nc, multi_label, agnostic, pre_nms_topk, max_wh, classes)
    keep = greedy_keep(offset_boxes, valid, iou_thres)
    return _first_kept(torch.cat([boxes, top_scores[..., None], cls[..., None]], -1), top_scores, keep, conf_thres,
                       max_det)


def _first_kept(rows: torch.Tensor, top_scores: torch.Tensor, keep: torch.Tensor, conf_thres: float,
                max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first max_det kept rows (B, k, D) in score order, zero past the
    valid ones and padded to max_det, and their count (B,)."""
    n = torch.sym_min(max_det, rows.shape[1])
    rank = torch.where(keep, top_scores, torch.full_like(top_scores, -1.0))
    sel_scores, sel = _top(rank, n)
    sel_valid = sel_scores > conf_thres
    out = rows.gather(1, sel[..., None].expand(-1, -1, rows.shape[-1]))
    out = torch.where(sel_valid[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    # padded to max_det rows (no rows when k >= max_det: a trace at a dynamic size cannot branch on k)
    out = torch.nn.functional.pad(out, (0, 0, 0, max_det - n))
    sel_valid = torch.nn.functional.pad(sel_valid, (0, max_det - n))
    return out, sel_valid.sum(1, dtype=torch.int32)


def non_max_suppression_extras(
    preds: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    nc: int = 80,
    max_det: int = 300,
    pre_nms_topk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """preds (B, A, 4 + nc + E) -> (out (B, max_det, 6 + E), n_valid (B,)):
    rows [x1, y1, x2, y2, conf, cls, extras...], zero past n_valid (JAX
    nms.py:124). Each anchor's best class, class-offset boxes (7680 px), the
    keep step of the greedy keep kernel, as non_max_suppression; the E extra
    columns of each kept anchor ride along."""
    boxes, top_scores, cls, valid, offset_boxes, anchor = _candidates(preds[..., : 4 + nc], conf_thres, nc,
                                                                      pre_nms_topk=pre_nms_topk)
    extra = preds[..., 4 + nc :].gather(1, anchor[..., None].expand(-1, -1, preds.shape[-1] - 4 - nc))
    keep = greedy_keep(offset_boxes, valid, iou_thres)
    return _first_kept(torch.cat([boxes, top_scores[..., None], cls[..., None], extra], -1), top_scores, keep,
                       conf_thres, max_det)


def nms_rotated(preds: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45, nc: int = 80,
                max_det: int = 300, pre_nms_topk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """preds (B, A, 5 + nc) cx cy w h angle + scores -> (out (B, max_det, 7)
    [cx, cy, w, h, angle, conf, cls], n_valid (B,)), zero past n_valid (JAX
    nms.py:169): each anchor's best class, the k = min(pre_nms_topk, A) best
    by score (ties to the lower index), then Fast-NMS, one-shot and not
    greedy: a candidate goes when any valid candidate ranked above it
    overlaps it by probiou >= iou_thres, whether or not that one was kept;
    the first max_det kept in score order. Class-agnostic, as JAX's."""
    b, a, _ = preds.shape
    k = torch.sym_min(pre_nms_topk, a)
    scores = preds[..., 5 : 5 + nc]
    best_cls = scores.argmax(-1)
    top_scores, anchor = _top(scores.gather(-1, best_cls[..., None])[..., 0], k)
    cls = best_cls.gather(1, anchor).float()
    valid = top_scores > conf_thres
    boxes = preds[..., :5].gather(1, anchor[..., None].expand(b, k, 5))
    ious = batch_probiou(boxes, boxes)  # (B, k, k)
    upper = (ious >= iou_thres) & torch.ones(k, k, dtype=torch.bool, device=preds.device).triu(1) & valid[..., None]
    keep = valid & ~upper.any(1)
    return _first_kept(torch.cat([boxes, top_scores[..., None], cls[..., None]], -1), top_scores, keep, conf_thres,
                       max_det)
