"""Box coordinate ops. Counterpart of spectrogram_yolov11_tpu/ops/boxes.py:
xywh2xyxy (:23) on tensors for the NMS; xyxy2xywh (:30), clip_boxes (:54) and
scale_boxes (:73) on host numpy for the Results, as in the JAX package; and
the rotated boxes of the OBB task: regularize_rboxes (:100), xywhr2xyxyxyxy
(:112) and xyxyxyxy2xywhr (:125), on numpy arrays or tensors.

JAX calls cv2 for two rotated-box helpers, which the card's machine lacks,
so the port has its own:

- `box_points` is cv2.boxPoints (RotatedRect::points) bit for bit: the
  corners computed in float32 from the float32 centre, size and angle, as
  OpenCV computes them (equal to cv2 5.0.0 on 20,000 seeded boxes;
  tests/test_torch_obb_data.py). The synthetic OBB frames truncate these
  corners to int32, where one ulp can move a pixel.
- `min_area_rect` is cv2.minAreaRect's rectangle in its convention: the
  rectangle of least area that holds the points' convex hull (one side on a
  hull edge), its first side (`w`) along the direction whose angle lies in
  [-90, 0) degrees, `h` the other; a single point gives size (0, 0) and angle
  -90, collinear points a rectangle of zero width or height. The port
  computes it exactly in float64 from the float32 points and rounds the
  centre, size and angle to float32 once; cv2 5.0.0 computes it in float32
  and lands up to a few dozen float32 ulps away, and on hulls whose two
  smallest rectangles' areas lie within its rounding of each other it can
  return the other one (ROADMAP.md §3.39).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4+) center-size boxes -> corner boxes; trailing columns ride along."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh / 2
    return torch.cat([xy - half, xy + half, x[..., 4:]], dim=-1)


def xyxy2xywh(x: np.ndarray) -> np.ndarray:
    """(..., 4+) corner boxes -> center-size boxes; trailing columns ride along."""
    x1y1, x2y2 = x[..., :2], x[..., 2:4]
    return np.concatenate([(x1y1 + x2y2) / 2, x2y2 - x1y1, x[..., 4:]], axis=-1)


def clip_boxes(boxes: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Clip xyxy boxes to an image of shape (h, w), trailing columns kept."""
    h, w = shape[:2]
    clipped = np.stack([np.clip(boxes[..., 0], 0, w), np.clip(boxes[..., 1], 0, h),
                        np.clip(boxes[..., 2], 0, w), np.clip(boxes[..., 3], 0, h)], axis=-1)
    if boxes.shape[-1] > 4:
        clipped = np.concatenate([clipped, boxes[..., 4:]], axis=-1)
    return clipped


def scale_boxes(img1_shape, boxes, img0_shape, ratio_pad=None, padding: bool = True, xywh: bool = False) -> np.ndarray:
    """Rescale boxes from the letterboxed img1_shape back to img0_shape. The pad
    is recomputed from the gain with Python's round(pad - 0.1), not taken from
    the letterbox's own geometry, as the JAX package does."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1),
               round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1))
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    boxes = np.array(boxes, dtype=np.float32, copy=True)
    if padding:
        boxes[..., 0] -= pad[0]
        boxes[..., 1] -= pad[1]
        if not xywh:
            boxes[..., 2] -= pad[0]
            boxes[..., 3] -= pad[1]
    boxes[..., :4] /= gain
    return clip_boxes(boxes, img0_shape)


def regularize_rboxes(rboxes):
    """(..., 5) xywhr boxes (numpy or torch) in canonical form: the long side
    as w, the angle in [0, pi) (JAX :100)."""
    x, y, w, h, t = (rboxes[..., i] for i in range(5))
    where, stack = (torch.where, torch.stack) if isinstance(rboxes, torch.Tensor) else (np.where, np.stack)
    swap = w > h
    return stack([x, y, where(swap, w, h), where(swap, h, w), where(swap, t, t + math.pi / 2) % math.pi], -1)


def xywhr2xyxyxyxy(x):
    """(..., 5) cx cy w h angle (radians), numpy or torch -> (..., 4, 2) corners
    (JAX :112): ctr + v1 + v2, ctr + v1 - v2, ctr - v1 - v2, ctr - v1 + v2 with
    v1 = w/2 (cos, sin) and v2 = h/2 (-sin, cos)."""
    ctr, w, h, angle = x[..., :2], x[..., 2:3], x[..., 3:4], x[..., 4:5]
    if isinstance(x, torch.Tensor):
        cat, stack, c, s = torch.cat, torch.stack, torch.cos(angle), torch.sin(angle)
    else:  # cos and sin correctly rounded to the input's dtype, where XLA's f32 ones mostly land
        cat, stack = np.concatenate, np.stack
        c, s = (f(angle.astype(np.float64)).astype(angle.dtype) for f in (np.cos, np.sin))
    v1 = cat([w / 2 * c, w / 2 * s], -1)
    v2 = cat([-h / 2 * s, h / 2 * c], -1)
    return stack([ctr + v1 + v2, ctr + v1 - v2, ctr - v1 - v2, ctr - v1 + v2], -2)


def xyxyxyxy2xywhr(x) -> np.ndarray:
    """(n, 8) or (n, 4, 2) corners -> (n, 5) float32 cx cy w h angle (radians)
    by min_area_rect, the angle its degrees / 180 * pi (JAX :125)."""
    pts = np.asarray(x, np.float32).reshape(len(x), -1, 2)
    out = np.empty((len(pts), 5), np.float32)
    for i, p in enumerate(pts):
        (cx, cy), (w, h), ang = min_area_rect(p)
        out[i] = (cx, cy, w, h, ang / 180 * np.pi)
    return out


def _hull(p: np.ndarray) -> np.ndarray:
    """The convex hull (float64, counter-clockwise in x-right y-up terms) of
    points (n, 2): Andrew's monotone chain, collinear points dropped."""
    pts = sorted(set(map(tuple, p.tolist())))
    if len(pts) <= 2:
        return np.asarray(pts, np.float64)

    def half(seq):
        out = []
        for q in seq:
            while len(out) >= 2 and ((out[-1][0] - out[-2][0]) * (q[1] - out[-2][1])
                                     - (out[-1][1] - out[-2][1]) * (q[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(q)
        return out

    lower, upper = half(pts), half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1], np.float64)


def min_area_rect(points) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """cv2.minAreaRect(points): ((cx, cy), (w, h), angle in degrees) of
    float32 points (n, 2), each value a float32 (see the module docstring)."""
    p = np.asarray(points, np.float32).reshape(-1, 2)
    h = _hull(p)
    if len(h) == 0:
        return (0.0, 0.0), (0.0, 0.0), -90.0
    if len(h) == 1:
        return (float(h[0, 0]), float(h[0, 1])), (0.0, 0.0), -90.0
    best = None
    edges = [(h[i], h[(i + 1) % len(h)]) for i in range(len(h) if len(h) > 2 else 1)]
    for a, b in edges:
        ux, uy = b - a
        norm = math.hypot(ux, uy)
        ux, uy = ux / norm, uy / norm
        for turns in range(4):  # quarter turns until the direction's angle lies in [-90, 0)
            ang = math.degrees(math.atan2(uy, ux))
            if -90.0 <= ang < 0.0:
                break
            ux, uy = uy, -ux
        u, v = np.array([ux, uy]), np.array([-uy, ux])
        pa, pb = h @ u, h @ v
        w, hh = pa.max() - pa.min(), pb.max() - pb.min()
        if len(h) == 2:  # a segment: no extent across it
            w, hh = (w, 0.0) if turns % 2 == 0 else (0.0, hh)
        if best is None or w * hh < best[0]:
            c = u * (pa.max() + pa.min()) / 2 + v * (pb.max() + pb.min()) / 2
            best = (w * hh, c, w, hh, ang)
    _, c, w, hh, ang = best
    f = lambda z: float(np.float32(z))  # noqa: E731
    return (f(c[0]), f(c[1])), (f(w), f(hh)), f(ang)


def box_points(rect) -> np.ndarray:
    """cv2.boxPoints(((cx, cy), (w, h), angle in degrees)) -> (4, 2) float32
    corners, OpenCV's RotatedRect::points in float32 arithmetic."""
    (cx, cy), (w, h), angle = rect
    f32 = np.float32
    cx, cy, w, h = f32(cx), f32(cy), f32(w), f32(h)
    t = float(f32(angle)) * math.pi / 180.0
    b, a = f32(math.cos(t)) * f32(0.5), f32(math.sin(t)) * f32(0.5)
    ah, bw, bh, aw = a * h, b * w, b * h, a * w
    return np.array([[(cx - ah) - bw, (cy + bh) - aw], [(cx + ah) - bw, (cy - bh) - aw],
                     [(cx + ah) + bw, (cy - bh) + aw], [(cx - ah) + bw, (cy + bh) + aw]], np.float32)
