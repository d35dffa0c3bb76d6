"""Letterbox on the card. Counterpart of spectrogram_yolov11_tpu/data/augment.py:25
letterbox and of the JAX predictor's NativeBatchLetterbox
(spectrogram_yolov11_tpu/utils/native.py:66), whose arithmetic is in
native/preprocess.cpp:24-81. The integer tensor ops below repeat that C++ code
step for step, so a frame letterboxed here equals the native one bit for bit:

  r = min(S / h, S / w) in double; nw, nh, left, top by lround
      (left = lround((S - nw) / 2 - 0.1), top likewise);
  per output column x: sx = int(w / nw * 65536) in double,
      fx = max(((2x + 1) * sx) // 2 - 32768, 0), xi = fx >> 16,
      x0 = min(xi, w - 1), x1 = min(xi + 1, w - 1), weight fx & 0xFFFF;
      rows likewise;
  value = (top * (65536 - wy) + bottom * wy) >> 32, a truncation, where
      top = p00 * (65536 - wx) + p01 * wx in 8.16 fixed point.

Frames of one size are resized together, so a batch costs a few launches per
distinct size. A gray frame goes up as one channel; the batch is one channel
when every frame is gray and is broadcast to three on the card by the device
function, as the JAX predictor's `_maybe_gray` upload is.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

PAD_VALUE = 114


def _lround(x: float) -> int:
    """C's lround: nearest integer, halves away from zero."""
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


def letterbox_geometry(imgsz: int, src_hw: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """(nh, nw, top, left) of an h x w frame in an imgsz square, as native/preprocess.cpp:69-74."""
    h, w = src_hw
    r = min(imgsz / h, imgsz / w)
    nw, nh = _lround(w * r), _lround(h * r)
    return nh, nw, _lround((imgsz - nh) / 2.0 - 0.1), _lround((imgsz - nw) / 2.0 - 0.1)


def _taps(n_src: int, n_dst: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Source indices i0, i1 and 16-bit weights of the 16.16 bilinear taps along one axis."""
    s = int(n_src / n_dst * 65536)
    f = (((2 * torch.arange(n_dst, dtype=torch.int64, device=device) + 1) * s) // 2 - 32768).clamp_min(0)
    i = f >> 16
    return i.clamp_max(n_src - 1), (i + 1).clamp_max(n_src - 1), f & 0xFFFF


def resize_u8(frames: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(G, h, w, C) uint8 -> (G, nh, nw, C) uint8 by native/preprocess.cpp's
    fixed-point bilinear resize; the same size is returned as it is (the
    native code copies it exactly)."""
    g, h, w, c = frames.shape
    if (h, w) == (nh, nw):
        return frames
    y0, y1, wy = _taps(h, nh, frames.device)
    x0, x1, wx = _taps(w, nw, frames.device)
    wx = wx.view(1, 1, nw, 1).int()
    wy = wy.view(1, nh, 1, 1)

    def row_blend(rows: torch.Tensor) -> torch.Tensor:  # (G, nh, w, C) -> (G, nh, nw, C), 8.16 fixed point
        rows = rows.int()
        return rows[:, :, x0] * (65536 - wx) + rows[:, :, x1] * wx

    top, bot = row_blend(frames[:, y0]), row_blend(frames[:, y1])
    return ((top.long() * (65536 - wy) + bot.long() * wy) >> 32).to(torch.uint8)


def is_gray(frame, state: Optional[list] = None) -> bool:
    """True when a frame's channels are equal: one channel, a tensor broadcast
    over its last axis, or a numpy BGR frame whose planes match. A cheap
    strided probe rejects colour frames first, and `state` (a one-item list
    per stream) remembers a stream once it has shown colour, as the JAX
    predictor's `_maybe_gray` does."""
    if frame.ndim == 2 or frame.shape[-1] == 1:
        return True
    if torch.is_tensor(frame):
        return frame.stride(-1) == 0
    if state is not None and state[0] is False:
        return False
    probe = frame[::97, ::89]
    gray = (np.array_equal(probe[..., 0], probe[..., 1]) and np.array_equal(probe[..., 0], probe[..., 2])
            and np.array_equal(frame[..., 0], frame[..., 1]) and np.array_equal(frame[..., 0], frame[..., 2]))
    if not gray and state is not None:
        state[0] = False
    return gray


def _upload(frame, channels: int, device: torch.device) -> torch.Tensor:
    """One frame as a (h, w, channels) uint8 tensor on the device."""
    if torch.is_tensor(frame):
        t = frame if frame.ndim == 3 else frame[..., None]
    else:
        a = np.ascontiguousarray(frame, dtype=np.uint8)
        a = a[..., None] if a.ndim == 2 else a
        t = torch.from_numpy(np.ascontiguousarray(a[..., :1]) if channels == 1 else a)
    if t.shape[-1] not in (1, 3):
        raise ValueError(f"letterbox: expected a frame with 1 or 3 channels, got shape {tuple(t.shape)}")
    t = t[..., :channels].to(device)
    return t.expand(*t.shape[:2], channels) if t.shape[-1] != channels else t


def letterbox_batch(frames: Sequence, imgsz: int, device: torch.device, gray_state: Optional[list] = None,
                    pad_value: int = PAD_VALUE) -> torch.Tensor:
    """uint8 HWC frames (numpy on the host or tensors on the device, any sizes)
    -> (B, imgsz, imgsz, C) uint8 on `device`, filled with `pad_value`; C is 1
    when every frame is gray, else 3."""
    channels = 1 if all(is_gray(f, gray_state) for f in frames) else 3
    out = torch.full((len(frames), imgsz, imgsz, channels), pad_value, dtype=torch.uint8, device=device)
    groups: dict = {}
    for i, f in enumerate(frames):
        groups.setdefault(tuple(f.shape[:2]), []).append(i)
    for (h, w), idx in groups.items():
        nh, nw, top, left = letterbox_geometry(imgsz, (h, w))
        stack = torch.stack([_upload(frames[i], channels, device) for i in idx])
        resized = resize_u8(stack, nh, nw)
        if len(idx) == 1:
            out[idx[0], top : top + nh, left : left + nw] = resized[0]
        else:
            out[torch.tensor(idx, device=device), top : top + nh, left : left + nw] = resized
    return out

