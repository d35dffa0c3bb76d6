"""Head decode: anchors + DFL integral + dist2bbox + sigmoid class scores.

Counterpart of spectrogram_yolov11_tpu/ops/decode.py: make_anchors (:21),
dist2bbox (:37), bbox2dist (:49, the loss's DFL targets), decode_detections
(:99), decode_kpts (:150, the pose head's keypoints), and the OBB head's
dist2rbox (:57) and decode_obb (:132), and v10's NMS-free end: decode_e2e
(:168) and nms_free_postprocess (:177). DFL and sigmoid run per level, then
the small results are concatenated, as in the JAX form.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from ..nn.modules.block import dfl_decode


def make_anchors(shapes: Sequence[Tuple[int, int]], strides: Sequence[float], device=None, grid_cell_offset: float = 0.5):
    """Anchor centers (A, 2) in feature coords, (x, y) order, row-major over
    (h, w), and per-anchor stride (A, 1)."""
    pts, strs = [], []
    for (h, w), s in zip(shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        pts.append(torch.stack((gx, gy), -1).reshape(-1, 2))
        strs.append(torch.full((h * w, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(pts), torch.cat(strs)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True) -> torch.Tensor:
    """LTRB distances -> boxes at the anchor points (last-dim layout)."""
    lt, rb = distance.chunk(2, -1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat(((x1y1 + x2y2) / 2, x2y2 - x1y1), -1)
    return torch.cat((x1y1, x2y2), -1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: float) -> torch.Tensor:
    """xyxy boxes -> LTRB distances from the anchor points, clamped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    return torch.cat((anchor_points - x1y1, x2y2 - anchor_points), -1).clamp(0, reg_max - 0.01)


def dist2rbox(pred_dist: torch.Tensor, pred_angle: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """LTRB distances and an angle (radians) -> rotated boxes (cx, cy, w, h)
    at the anchor points (JAX decode.py:57): the centre offset (rb - lt) / 2
    turned by the angle."""
    lt, rb = pred_dist.chunk(2, -1)
    cos, sin = torch.cos(pred_angle), torch.sin(pred_angle)
    xf, yf = ((rb - lt) / 2).chunk(2, -1)
    x, y = xf * cos - yf * sin, xf * sin + yf * cos
    return torch.cat([torch.cat([x, y], -1) + anchor_points, lt + rb], -1)


def decode_detections(
    feats: List[Tuple[torch.Tensor, torch.Tensor]], nc: int, strides: Sequence[float], reg_max: int = 16
) -> torch.Tensor:
    """Per-level (box (B, 4*reg_max, H, W), cls (B, nc, H, W)) logits, as the
    port's Detect returns them -> (B, A, 4+nc) f32: xywh boxes in input pixels
    and sigmoid class scores, anchors in the JAX (level, h, w) order. On bf16
    logits the exp and the sigmoid run in bf16, so the scores are bf16 values."""
    anchors, stride_t = make_anchors([tuple(b.shape[-2:]) for b, _ in feats], strides, feats[0][0].device)
    dist, scores = _decode_streams(feats, reg_max)
    boxes = dist2bbox(dist, anchors[None], xywh=True) * stride_t[None]
    return torch.cat([boxes, scores], -1)


def _decode_streams(feats: List[Tuple[torch.Tensor, torch.Tensor]], reg_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """DFL and sigmoid per level, then the small results concatenated (JAX
    decode.py:_decode_streams): (B, A, 4) f32 LTRB distances and (B, A, nc)
    f32 scores, the sigmoid taken in the logits' dtype, as JAX's."""
    dists, scores = [], []
    for b, c in feats:
        dists.append(dfl_decode(b.flatten(2).transpose(1, 2), reg_max))
        scores.append(torch.sigmoid(c.flatten(2).transpose(1, 2)).float())
    return torch.cat(dists, 1), torch.cat(scores, 1)


def decode_kpts(kpt_raw: torch.Tensor, kpt_shape: Tuple[int, int], shapes: Sequence[Tuple[int, int]],
                strides: Sequence[float]) -> torch.Tensor:
    """Raw keypoints (B, A, nk * nd) -> (B, A, nk, nd) f32 in input pixels
    (JAX decode.py:150): xy = (raw * 2 + (anchor - 0.5)) * stride, and a
    sigmoid on the visibility channel when nd = 3."""
    anchors, stride_t = make_anchors(shapes, strides, kpt_raw.device)
    b, a, _ = kpt_raw.shape
    nk, nd = kpt_shape
    y = kpt_raw.float().reshape(b, a, nk, nd)
    xy = (y[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * stride_t[None, :, None, :]
    if nd == 3:
        return torch.cat([xy, torch.sigmoid(y[..., 2:3])], -1)
    return xy


def decode_obb(feats: List[Tuple[torch.Tensor, torch.Tensor]], angle_raw: torch.Tensor, nc: int,
               strides: Sequence[float], reg_max: int = 16) -> torch.Tensor:
    """The OBB head's outputs -> (B, A, 5 + nc) f32: cx, cy, w, h in input
    pixels, the angle (sigmoid(raw) - 0.25) * pi in radians, and the sigmoid
    class scores (JAX decode.py:132)."""
    anchors, stride_t = make_anchors([tuple(b.shape[-2:]) for b, _ in feats], strides, feats[0][0].device)
    angle = (torch.sigmoid(angle_raw.float()) - 0.25) * math.pi
    dist, scores = _decode_streams(feats, reg_max)
    rbox = dist2rbox(dist, angle, anchors[None]) * stride_t[None]
    return torch.cat([rbox, angle, scores], -1)


def decode_e2e(feats: List[Tuple[torch.Tensor, torch.Tensor]], nc: int, strides: Sequence[float],
               reg_max: int = 16) -> torch.Tensor:
    """An end2end (v10) head's one2one pairs -> (B, A, 4 + nc) f32 as
    decode_detections, but with the boxes kept xyxy (JAX decode.py:168)."""
    anchors, stride_t = make_anchors([tuple(b.shape[-2:]) for b, _ in feats], strides, feats[0][0].device)
    dist, scores = _decode_streams(feats, reg_max)
    boxes = dist2bbox(dist, anchors[None], xywh=False) * stride_t[None]
    return torch.cat([boxes, scores], -1)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of x's last dimension and their indices, equal
    values in index order: jax.lax.top_k's order, which torch.topk does not
    promise (a stable descending sort cut at k)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def nms_free_postprocess(preds: torch.Tensor, max_det: int, nc: int) -> torch.Tensor:
    """v10's NMS-free selection (JAX decode.py:177): preds (B, A, 4 + nc)
    with xyxy boxes -> (B, k, 6) [x1, y1, x2, y2, conf, cls], k = min(max_det,
    A), sorted by confidence: the k anchors of the highest best-class score,
    then the k highest scores over those anchors x classes, ties in index
    order as jax.lax.top_k's."""
    b, a = preds.shape[:2]
    k = torch.sym_min(max_det, a)
    boxes, scores = preds[..., :4], preds[..., 4:]
    _, idx = _top_k(scores.amax(-1), k)
    boxes = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    scores = scores.gather(1, idx[..., None].expand(-1, -1, nc))
    conf, fidx = _top_k(scores.reshape(b, -1), k)
    sel = boxes.gather(1, (fidx // nc)[..., None].expand(-1, -1, 4))
    return torch.cat([sel, conf[..., None], (fidx % nc).float()[..., None]], -1)
