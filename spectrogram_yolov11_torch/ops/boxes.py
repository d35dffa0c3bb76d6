"""Box coordinate ops. Counterpart of spectrogram_yolov11_tpu/ops/boxes.py:
xywh2xyxy (:23) on tensors for the NMS; xyxy2xywh (:30), clip_boxes (:54) and
scale_boxes (:73) on host numpy for the Results, as in the JAX package."""

from __future__ import annotations

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
