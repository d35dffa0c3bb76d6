"""Batched fixed-shape NMS (torch). Counterpart of
spectrogram_yolov11_tpu/ops/nms.py:64 non_max_suppression.

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
    b, a, _ = preds.shape
    boxes_xywh = preds[..., :4]
    scores = preds[..., 4 : 4 + nc]
    if classes is not None:
        allowed = torch.zeros(nc, dtype=torch.bool, device=preds.device)
        allowed[torch.as_tensor(classes, dtype=torch.long, device=preds.device)] = True
        scores = torch.where(allowed, scores, torch.zeros((), dtype=scores.dtype, device=scores.device))
    k = min(pre_nms_topk, a * nc if multi_label else a)
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
    return boxes, top_scores, cls, valid, (boxes + offset[..., None]).contiguous()


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
    k = boxes.shape[1]
    keep = greedy_keep(offset_boxes, valid, iou_thres)

    rank = torch.where(keep, top_scores, torch.full_like(top_scores, -1.0))
    sel_scores, sel = _top(rank, min(max_det, k))
    sel_valid = sel_scores > conf_thres
    out = torch.cat(
        [boxes.gather(1, sel[..., None].expand(-1, -1, 4)), top_scores.gather(1, sel)[..., None], cls.gather(1, sel)[..., None]],
        -1,
    )
    out = torch.where(sel_valid[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    if max_det > k:
        out = torch.nn.functional.pad(out, (0, 0, 0, max_det - k))
        sel_valid = torch.nn.functional.pad(sel_valid, (0, max_det - k))
    return out, sel_valid.sum(1, dtype=torch.int32)
