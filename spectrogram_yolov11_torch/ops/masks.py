"""Masks on the device: the crop to each box and the float resize.

Counterparts of spectrogram_yolov11_tpu/ops/masks.py:20 crop_masks_device
(the crop every compiled mask path of the JAX package applies, float logits
or bool masks), ops/losses.py:184 crop_mask (the loss's crop, boxes in mask
pixels) and the cv2.resize(INTER_LINEAR) of float masks that JAX's
segment predictor and validator run on the host (engine/predictor.py:
365-393, engine/validator.py:442). Plain tensor ops, on whatever device the
masks are.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def crop_masks_device(masks: torch.Tensor, boxes: torch.Tensor, in_hw: Sequence[int]) -> torch.Tensor:
    """masks (b, d, mh, mw) float or bool, boxes (b, d, 4) xyxy in the
    network input's pixels, in_hw its (h, w) -> the masks zeroed (False)
    outside each box scaled to mask pixels: a pixel (x, y) is inside when
    x1 <= x < x2 and y1 <= y < y2 (JAX masks.py:20)."""
    mh, mw = masks.shape[-2:]
    sy, sx = mh / torch.sym_float(in_hw[0]), mw / torch.sym_float(in_hw[1])  # symbolic in a trace at a dynamic size
    x = torch.arange(mw, dtype=torch.float32, device=masks.device)[None, None, None, :]
    y = torch.arange(mh, dtype=torch.float32, device=masks.device)[None, None, :, None]
    x1, y1, x2, y2 = ((boxes[..., i] * s)[..., None, None] for i, s in enumerate((sx, sy, sx, sy)))
    inside = (x >= x1) & (x < x2) & (y >= y1) & (y < y2)
    return masks & inside if masks.dtype == torch.bool else masks * inside


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """masks (..., h, w) zeroed outside boxes (..., 4) xyxy in mask pixels (JAX losses.py:184)."""
    h, w = masks.shape[-2:]
    x1, y1, x2, y2 = boxes[..., None, :].split(1, -1)  # (..., 1, 1) each
    rows = torch.arange(h, dtype=torch.float32, device=masks.device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=masks.device)[None, :]
    return masks * ((cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2))


def _linear_taps(n_src: int, n_dst: int, device: torch.device):
    """Source indices i0, i1 and float32 weights w0, w1 of cv2's INTER_LINEAR
    along one axis: x = (d + 0.5) * n_src / n_dst - 0.5 in float64, i0 =
    floor(x), w1 = x - i0; a tap left of 0 or right of n_src - 1 takes its
    edge pixel with weight 1."""
    f = (np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    edge = (i0 < 0) | (i0 >= n_src - 1)
    f[edge] = 0.0
    i0 = np.clip(i0, 0, n_src - 1)
    taps = (i0, np.minimum(i0 + 1, n_src - 1), (1.0 - f).astype(np.float32), f.astype(np.float32))
    return [torch.from_numpy(t).to(device) for t in taps]


def resize_linear_f32(masks: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(N, h, w) float32 -> (N, nh, nw) float32: cv2.resize(INTER_LINEAR) of
    each float plane with cv2's taps and weights (_linear_taps), a horizontal
    pass then a vertical one, each p0 * w0 + p1 * w1 as separate products
    and a sum, so the card and the CPU give the same bits. cv2 rounds its
    sums otherwise: within 5e-7 of cv2 on unit-scale data (tests)."""
    h, w = masks.shape[-2:]
    if (h, w) == (nh, nw):
        return masks
    x0, x1, a0, a1 = _linear_taps(w, nw, masks.device)
    y0, y1, b0, b1 = _linear_taps(h, nh, masks.device)

    def horizontal(rows: torch.Tensor) -> torch.Tensor:
        return rows[..., x0] * a0 + rows[..., x1] * a1

    return horizontal(masks[..., y0, :]) * b0[:, None] + horizontal(masks[..., y1, :]) * b1[:, None]
