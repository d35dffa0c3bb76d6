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

The training side (below `HOST_AUGMENT_ITEM`) is JAX's device-augment mode:
labels and image parameters on the host, the image on the card
(ops/device_augment.py); host augmentation of the images raises.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import not_ported

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


def letterbox_params(imgsz: int, src_hw: Tuple[int, int],
                     scaleup: bool = False) -> Tuple[float, int, int, float, float, int, int]:
    """(r, nh, nw, dw, dh, top, left) of an h x w frame in the letterbox of
    spectrogram_yolov11_tpu/data/augment.py:25: r = min(S / h, S / w), capped
    at 1 unless scaleup (the val letterbox does not scale up, the train one
    does), nw = round(w * r), dw = (S - nw) / 2 (half the pad), left =
    round(dw - 0.1); likewise nh, dh, top."""
    h, w = src_hw
    r = min(imgsz / h, imgsz / w) if scaleup else min(imgsz / h, imgsz / w, 1.0)
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
    """Labels of a letterboxed sample (xyxy pixels) -> cls (max_gt,) int32,
    bboxes (max_gt, 4) xywh float32 normalised by the sample's `img_shape`
    (h, w) (the train path's, whose image is assembled on the card) or
    imgsz x imgsz, and mask_gt (max_gt,) bool, the first max_gt boxes of
    positive size in front (JAX :394-420, detect fields)."""
    boxes, cls = sample["bboxes"], sample["cls"]
    h, w = sample.get("img_shape", (imgsz, imgsz))
    n = min(len(boxes), max_gt)
    cls_pad, mask = np.zeros((max_gt,), np.int32), np.zeros((max_gt,), bool)
    box_pad = np.zeros((max_gt, 4), np.float32)
    if n:
        b = boxes[:n].astype(np.float32)
        xywh = np.stack([(b[:, 0] + b[:, 2]) / 2 / w, (b[:, 1] + b[:, 3]) / 2 / h,
                         (b[:, 2] - b[:, 0]) / w, (b[:, 3] - b[:, 1]) / h], axis=1)
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


# -- the training side, device-augment mode ---------------------------------
# Counterpart of spectrogram_yolov11_tpu/data/augment.py's label half of the
# train pipeline in device mode (TrainTransform._call_device :627-679): the
# host builds each sample's labels and the parameters of its image, and
# ops/device_augment.py assembles the image on the card inside the train
# step. Every random number is drawn from the sample's numpy Generator in
# JAX's order, so a sample's labels and parameters equal JAX's bit for bit.

HOST_AUGMENT_ITEM = "item 7b (host augmentation)"


def letterbox_train(img: np.ndarray, imgsz: int) -> Tuple[np.ndarray, float, float]:
    """JAX's letterbox(img, (S, S), scaleup=True) of a BGR uint8 frame: the
    frame resized as cv2's INTER_LINEAR (resize_linear_u8) when its long side
    is not S, and padded with 114 to S x S. Returns (frame, dw, dh)."""
    _, nh, nw, dw, dh, top, left = letterbox_params(imgsz, img.shape[:2], scaleup=True)
    if (nh, nw) != img.shape[:2]:
        img = resize_linear_u8(torch.from_numpy(np.ascontiguousarray(img))[None], nh, nw)[0].numpy()
    out = np.full((imgsz, imgsz, img.shape[2]), PAD_VALUE, np.uint8)
    out[top : top + nh, left : left + nw] = img
    return out, dw, dh


def pad_labels(sample: Dict, dw: float, dh: float) -> Dict:
    """The sample with its boxes shifted by the letterbox's pads (JAX _pad_labels :488)."""
    px, py = int(round(dw - 0.1)), int(round(dh - 0.1))
    boxes = sample["bboxes"].copy()
    if len(boxes):
        boxes[:, [0, 2]] += px
        boxes[:, [1, 3]] += py
    return dict(sample, bboxes=boxes)


def mosaic4(samples: List[Dict], imgsz: int, rng: np.random.Generator) -> Dict:
    """The labels of a 4-image mosaic on a 2S x 2S canvas, and its tiles for
    the card (JAX mosaic4(compose_image=False) :83): centre (xc, yc) drawn in
    [S/2, 3S/2) (yc first), each image clipped to its quadrant, its boxes
    moved by the tile's offset and clipped to the canvas. `tiles` holds the
    images in (4, S, S, 3) uint8, each tile's canvas rect [x1a, y1a, x2a,
    y2a) and its (padw, padh) canvas-to-source offset; the canvas itself is
    never built."""
    s = imgsz
    border = (-s // 2, -s // 2)
    yc, xc = (int(rng.uniform(-b, 2 * s + b)) for b in border)
    tiles_src = np.zeros((4, s, s, 3), np.uint8)
    tiles_reg = np.zeros((4, 4), np.int32)
    tiles_pad = np.zeros((4, 2), np.int32)
    cls_out, box_out = [], []
    for i, sample in enumerate(samples):
        img = sample["img"]
        h, w = img.shape[:2]
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:  # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b = 0, 0
        tiles_src[i, :h, :w] = img
        tiles_reg[i] = (x1a, y1a, x2a, y2a)
        padw, padh = x1a - x1b, y1a - y1b
        tiles_pad[i] = (padw, padh)
        if len(sample["cls"]):
            b = sample["bboxes"].copy()
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            box_out.append(b)
            cls_out.append(sample["cls"])
    cls_cat = np.concatenate(cls_out) if cls_out else np.zeros((0,), np.int32)
    box_cat = np.clip(np.concatenate(box_out) if box_out else np.zeros((0, 4), np.float32), 0, 2 * s)
    return {"cls": cls_cat, "bboxes": box_cat, "mosaic_border": border, "img_shape": (s * 2, s * 2),
            "tiles": {"src": tiles_src, "regions": tiles_reg, "pads": tiles_pad}}


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16) -> np.ndarray:
    """Boxes that survive a warp: wider and taller than wh_thr px, more than
    area_thr of their scaled area left, aspect under ar_thr (JAX :159)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def rotation_matrix_2d(angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(angle, center=(0, 0), scale), its float64
    arithmetic written out: a = angle * (pi / 180), alpha = cos(a) * scale,
    beta = sin(a) * scale, and the centre terms at (0, 0)."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx = cy = 0.0
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def random_perspective(sample: Dict, degrees: float, translate: float, scale: float, shear: float,
                       perspective: float, border: Tuple[int, int], rng: np.random.Generator) -> Dict:
    """The warp M = T @ S @ R @ P @ C of a sample whose image is assembled on
    the card (JAX random_perspective(warp_image=False) :167): the draws of P,
    the angle, the scale, S and T in JAX's order (ranges of 0 included), the
    boxes' corners warped and re-boxed, clipped to the output and filtered by
    box_candidates; M recorded as `warp_M` and the output size as `img_shape`."""
    in_h, in_w = sample["img_shape"]
    h, w = in_h + border[0] * 2, in_w + border[1] * 2
    C = np.eye(3)
    C[0, 2], C[1, 2] = -in_w / 2, -in_h / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    sc = rng.uniform(1 - scale, 1 + scale)
    R[:2] = rotation_matrix_2d(a, sc)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * h
    M = T @ S @ R @ P @ C
    boxes, cls = sample["bboxes"], sample["cls"]
    if len(boxes):
        n = len(boxes)
        xy = np.ones((n * 4, 3))
        xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).astype(np.float32).reshape(n, 8)
        x, y = xy[:, [0, 2, 4, 6]], xy[:, [1, 3, 5, 7]]
        new = np.stack((x.min(1), y.min(1), x.max(1), y.max(1)), axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        keep = box_candidates(boxes.T * sc, new.T, area_thr=0.10)
        boxes, cls = new[keep].astype(np.float32), cls[keep]
    return {"cls": cls, "bboxes": boxes, "warp_M": M, "img_shape": (h, w), "tiles": sample["tiles"]}


def draw_hsv_gains(hgain: float, sgain: float, vgain: float, rng: np.random.Generator) -> np.ndarray:
    """The HSV gains (3,) float32, drawn as JAX's draw_hsv_gains (:270): one
    uniform(-1, 1, 3) draw, none when every gain is 0."""
    if hgain or sgain or vgain:
        return (rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1).astype(np.float32)
    return np.ones(3, np.float32)


def random_flip(sample: Dict, fliplr: float, flipud: float, rng: np.random.Generator) -> Dict:
    """The flips applied to the boxes only (JAX random_flip(flip_image=False)
    :278): up-down first, then left-right, each drawn only when its
    probability is non-zero; the image's flips are recorded as `flips`
    (up-down, left-right) for the warp's inverse."""
    boxes = sample["bboxes"]
    h, w = sample["img_shape"]
    did_ud = did_lr = False
    if flipud and rng.random() < flipud:
        did_ud = True
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
    if fliplr and rng.random() < fliplr:
        did_lr = True
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return dict(sample, bboxes=boxes, flips=(did_ud, did_lr))


def resolve_device_augment(hyp) -> None:
    """Raise for the settings under which the JAX trainer augments images on
    the host (its _resolve_device_augment, trainer.py:218-230, and
    TrainTransform's blockers, augment.py:566-578): device_augment=False,
    'auto' with degrees, shear or perspective set (pass device_augment=True
    for the card's general warp), multi_scale, or mixup. copy_paste acts on
    segments only, so it is inert for detect, in both packages."""
    da = hyp.device_augment
    if isinstance(da, str):
        if da.lower() != "auto":
            raise ValueError(f"device_augment={da!r}: use 'auto', True or False")
        if hyp.degrees or hyp.shear or hyp.perspective:
            raise not_ported("device_augment='auto' with degrees, shear or perspective set (the JAX trainer then "
                             "augments on the host; device_augment=True warps them on the card)", HOST_AUGMENT_ITEM)
    elif not da:
        raise not_ported("device_augment=False (images augmented on the host with cv2)", HOST_AUGMENT_ITEM)
    if hyp.multi_scale:
        raise not_ported("multi_scale=True (a resized batch per step)", HOST_AUGMENT_ITEM)
    if hyp.mixup:
        raise not_ported("mixup > 0 (image mixup on the host)", HOST_AUGMENT_ITEM)


class TrainTransform:
    """The train transform in device-augment mode (JAX TrainTransform :547-680
    with device_mode=True): `__call__(idx, rng)` gives a sample's formatted
    labels and the parameters the card assembles its image from: `aug_src`
    (4, S, S, 3) uint8 BGR tiles, `aug_regions` (4, 4) int32 canvas rects,
    `aug_pads` (4, 2) int32 offsets, `aug_inv` (3, 3) float32 output-index to
    canvas matrix (inv(M) with the flips folded in as index reflections) and
    `aug_hsv` (3,) float32 gains. Draws, in order: mosaic or not (only while
    mosaic is on), the 3 partner indices and the centre, the warp, the HSV
    gains, the flips. close_mosaic() turns mosaic off for later samples."""

    def __init__(self, dataset, imgsz: int, hyp, max_gt: int = 128):
        resolve_device_augment(hyp)
        self.dataset = dataset
        self.imgsz = imgsz
        self.hyp = hyp
        self.max_gt = max_gt
        self.mosaic_enabled = True

    def close_mosaic(self) -> None:
        self.mosaic_enabled = False

    def __call__(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        h, s = self.hyp, self.imgsz
        if self.mosaic_enabled and rng.random() < h.mosaic:
            idxs = [idx] + list(rng.integers(0, len(self.dataset), 3))
            sample = mosaic4([self.dataset.load_sample(int(i), square_to=s) for i in idxs], s, rng)
            border = sample.pop("mosaic_border")
        else:
            raw = self.dataset.load_sample(idx, square_to=s)
            img, dw, dh = letterbox_train(raw["img"], s)
            src = np.zeros((4, s, s, 3), np.uint8)
            src[0] = img
            regions = np.zeros((4, 4), np.int32)
            regions[0] = (0, 0, s, s)
            sample = dict(pad_labels(raw, dw, dh), img_shape=(s, s),
                          tiles={"src": src, "regions": regions, "pads": np.zeros((4, 2), np.int32)})
            border = (0, 0)
        sample = random_perspective(sample, h.degrees, h.translate, h.scale, h.shear, h.perspective, border, rng)
        hsv = draw_hsv_gains(h.hsv_h, h.hsv_s, h.hsv_v, rng)
        sample = random_flip(sample, h.fliplr, h.flipud, rng)
        out = format_sample(sample, s, self.max_gt)
        A = np.linalg.inv(sample["warp_M"])  # flips act on the warped image, so they come first on the inverse path
        did_ud, did_lr = sample["flips"]
        if did_lr:
            F = np.eye(3)
            F[0, 0], F[0, 2] = -1.0, s - 1
            A = A @ F
        if did_ud:
            F = np.eye(3)
            F[1, 1], F[1, 2] = -1.0, s - 1
            A = A @ F
        tiles = sample["tiles"]
        out.update(aug_src=tiles["src"], aug_regions=tiles["regions"], aug_pads=tiles["pads"],
                   aug_inv=A.astype(np.float32), aug_hsv=hsv)
        return out
