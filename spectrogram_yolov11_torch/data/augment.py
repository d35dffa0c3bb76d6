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

The validator letterboxes with scaleup=False and the geometry of
spectrogram_yolov11_tpu/data/augment.py:25 letterbox (`letterbox_params`:
Python's round, r capped at 1), which ValTransform (JAX :682) records as
ratio_pad for un-letterboxing at metric time and by which it moves the labels
(format_sample :394 and _pad_labels :488, detect fields). Its pixels go
through `resize_linear_u8`, which is cv2.resize(INTER_LINEAR) on uint8 bit
for bit, as JAX's letterbox resizes (:59):

  at an exact 2x downscale in both axes cv2 averages each 2x2 block,
      (sum + 2) >> 2;
  otherwise, per output column x: fx = float32((x + 0.5) * (1 / (nw / w)) - 0.5),
      sx = floor(fx), fx -= sx; sx < 0 -> (0, fx = 0), sx >= w - 1 ->
      (w - 1, fx = 0); 11-bit coefficients rint((1 - fx) * 2048) and
      rint(fx * 2048); the horizontal pass p[sx] * c0 + p[sx + 1] * c1 in int32;
      rows likewise, but clamped by index only (their coefficients stay);
      the vertical pass as cv2's 8-bit one, ((b0 * (h0 >> 4)) >> 16) +
      ((b1 * (h1 >> 4)) >> 16) + 2) >> 2.

The coefficients are computed on the host in float32 as cv2 computes them;
the passes are integer tensor ops, so the card and the CPU give the same
bytes (tests/test_torch_dataset.py holds them to cv2 on the CPU).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

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


def letterbox_params(imgsz: int, src_hw: Tuple[int, int]) -> Tuple[float, int, int, float, float, int, int]:
    """(r, nh, nw, dw, dh, top, left) of an h x w frame in the val letterbox:
    r = min(S / h, S / w, 1), nw = round(w * r), dw = (S - nw) / 2 (half the
    pad), left = round(dw - 0.1); likewise nh, dh, top."""
    h, w = src_hw
    r = min(imgsz / h, imgsz / w, 1.0)
    nw, nh = int(round(w * r)), int(round(h * r))
    dw, dh = (imgsz - nw) / 2, (imgsz - nh) / 2
    return r, nh, nw, dw, dh, int(round(dh - 0.1)), int(round(dw - 0.1))


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


def _cv2_taps(n_src: int, n_dst: int, clamp_coefficients: bool):
    """Source indices i0, i1 and 11-bit coefficients c0, c1 (int32 numpy) of
    cv2's INTER_LINEAR along one axis. Columns move a clamped tap's weight to
    its edge pixel (clamp_coefficients); rows clamp the indices only."""
    f = ((np.arange(n_dst, dtype=np.float64) + 0.5) * (1.0 / (n_dst / n_src)) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_coefficients:
        edge = (s < 0) | (s >= n_src - 1)
        f[edge] = 0
        s = np.where(s < 0, 0, np.minimum(s, n_src - 1))
    one = np.float32(1)
    c0 = np.rint((one - f) * np.float32(2048)).astype(np.int32)
    c1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1), c0, c1


def resize_linear_u8(frames: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(G, h, w, C) uint8 -> (G, nh, nw, C) uint8, equal to
    cv2.resize(INTER_LINEAR) of each frame (the module docstring gives the
    arithmetic); the same size is returned as it is."""
    g, h, w, c = frames.shape
    if (h, w) == (nh, nw):
        return frames
    if (h, w) == (2 * nh, 2 * nw):
        f = frames.int()
        return ((f[:, 0::2, 0::2] + f[:, 0::2, 1::2] + f[:, 1::2, 0::2] + f[:, 1::2, 1::2] + 2) >> 2).to(torch.uint8)
    dev = frames.device
    x0, x1, a0, a1 = (torch.from_numpy(t).to(dev) for t in _cv2_taps(w, nw, True))
    y0, y1, b0, b1 = (torch.from_numpy(t).to(dev) for t in _cv2_taps(h, nh, False))
    a0, a1 = a0.view(1, 1, nw, 1), a1.view(1, 1, nw, 1)

    def horizontal(rows: torch.Tensor) -> torch.Tensor:  # (G, nh, w, C) uint8 -> (G, nh, nw, C) int32
        rows = rows.int()
        return rows[:, :, x0] * a0 + rows[:, :, x1] * a1

    h0, h1 = horizontal(frames[:, y0]), horizontal(frames[:, y1])
    b0, b1 = b0.view(1, nh, 1, 1), b1.view(1, nh, 1, 1)
    return ((((b0 * (h0 >> 4)) >> 16) + ((b1 * (h1 >> 4)) >> 16) + 2) >> 2).to(torch.uint8)


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
                    pad_value: int = PAD_VALUE, scaleup: bool = True) -> torch.Tensor:
    """uint8 HWC frames (numpy on the host or tensors on the device, any sizes)
    -> (B, imgsz, imgsz, C) uint8 on `device`, filled with `pad_value`; C is 1
    when every frame is gray, else 3. scaleup=False is the val letterbox
    (letterbox_params, resize_linear_u8): no frame is enlarged."""
    channels = 1 if all(is_gray(f, gray_state) for f in frames) else 3
    out = torch.full((len(frames), imgsz, imgsz, channels), pad_value, dtype=torch.uint8, device=device)
    groups: dict = {}
    for i, f in enumerate(frames):
        groups.setdefault(tuple(f.shape[:2]), []).append(i)
    for (h, w), idx in groups.items():
        if scaleup:
            nh, nw, top, left = letterbox_geometry(imgsz, (h, w))
        else:
            _, nh, nw, _, _, top, left = letterbox_params(imgsz, (h, w))
        stack = torch.stack([_upload(frames[i], channels, device) for i in idx])
        resized = resize_u8(stack, nh, nw) if scaleup else resize_linear_u8(stack, nh, nw)
        if len(idx) == 1:
            out[idx[0], top : top + nh, left : left + nw] = resized[0]
        else:
            out[torch.tensor(idx, device=device), top : top + nh, left : left + nw] = resized
    return out


def format_sample(sample: Dict, imgsz: int, max_gt: int) -> Dict[str, np.ndarray]:
    """Labels of a letterboxed imgsz x imgsz sample (xyxy pixels) -> cls
    (max_gt,) int32, bboxes (max_gt, 4) normalised xywh float32 and mask_gt
    (max_gt,) bool, the first max_gt boxes of positive size in front."""
    boxes, cls = sample["bboxes"], sample["cls"]
    n = min(len(boxes), max_gt)
    cls_pad, mask = np.zeros((max_gt,), np.int32), np.zeros((max_gt,), bool)
    box_pad = np.zeros((max_gt, 4), np.float32)
    if n:
        b = boxes[:n].astype(np.float32)
        xywh = np.stack([(b[:, 0] + b[:, 2]) / 2 / imgsz, (b[:, 1] + b[:, 3]) / 2 / imgsz,
                         (b[:, 2] - b[:, 0]) / imgsz, (b[:, 3] - b[:, 1]) / imgsz], axis=1)
        good = (xywh[:, 2] > 0) & (xywh[:, 3] > 0)
        k = int(good.sum())
        box_pad[:k], cls_pad[:k], mask[:k] = xywh[good], cls[:n][good], True
    return {"cls": cls_pad, "bboxes": box_pad, "mask_gt": mask}


class ValTransform:
    """The val transform: the letterbox geometry (scaleup=False) of a sample,
    its labels scaled and shifted into the letterboxed frame and formatted,
    `ori_shape` (h, w) int32 and `ratio_pad` [r, dw, dh] float32 for
    un-letterboxing at metric time. `img` stays the frame at its own size:
    the validator letterboxes a batch on the card (letterbox_batch with
    scaleup=False)."""

    def __init__(self, imgsz: int, max_gt: int = 256):
        self.imgsz = imgsz
        self.max_gt = max_gt

    def __call__(self, sample: Dict) -> Dict[str, np.ndarray]:
        img = sample["img"]
        r, _, _, dw, dh, top, left = letterbox_params(self.imgsz, img.shape[:2])
        boxes = sample["bboxes"].copy()
        if len(boxes):
            boxes[:, :4] *= r
            boxes[:, [0, 2]] += left
            boxes[:, [1, 3]] += top
        out = format_sample(dict(sample, bboxes=boxes), self.imgsz, self.max_gt)
        out["img"] = img
        out["ori_shape"] = np.asarray(img.shape[:2], np.int32)
        out["ratio_pad"] = np.asarray([r, dw, dh], np.float32)
        return out
