"""Head decode: anchors + DFL integral + dist2bbox + sigmoid class scores.

Counterpart of spectrogram_yolov11_tpu/ops/decode.py: make_anchors (:21),
dist2bbox (:37), bbox2dist (:49, the loss's DFL targets), decode_detections
(:99). DFL and sigmoid run per level, then
the small results are concatenated, as in the JAX form.
"""

from __future__ import annotations

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


def decode_detections(
    feats: List[Tuple[torch.Tensor, torch.Tensor]], nc: int, strides: Sequence[float], reg_max: int = 16
) -> torch.Tensor:
    """Per-level (box (B, 4*reg_max, H, W), cls (B, nc, H, W)) logits, as the
    port's Detect returns them -> (B, A, 4+nc) f32: xywh boxes in input pixels
    and sigmoid class scores, anchors in the JAX (level, h, w) order. On bf16
    logits the exp and the sigmoid run in bf16, so the scores are bf16 values."""
    device = feats[0][0].device
    anchors, stride_t = make_anchors([tuple(b.shape[-2:]) for b, _ in feats], strides, device)
    dists, scores = [], []
    for b, c in feats:
        dists.append(dfl_decode(b.flatten(2).transpose(1, 2), reg_max))
        scores.append(torch.sigmoid(c.flatten(2).transpose(1, 2)).float())  # in the logits' dtype, as JAX
    boxes = dist2bbox(torch.cat(dists, 1), anchors[None], xywh=True) * stride_t[None]
    return torch.cat([boxes, torch.cat(scores, 1)], -1)
