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

The training side (below `resolve_device_augment`) is JAX's train transform
in both of its modes: device-augment mode (labels and image parameters on the
host, the image assembled on the card by ops/device_augment.py) and host mode
(the image augmented on the host: the mosaic canvas, the warp and the HSV
jitter through data/warp.py's C++, equal to JAX's cv2 calls byte for byte,
mixup, the flips), with JAX's rule for which one runs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.boxes import min_area_rect
from ..utils import LOGGER
from ..utils.plotting import fill_poly
from .warp import augment_hsv_u8, warp_affine_u8, warp_perspective_u8

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


def format_sample(sample: Dict, imgsz: int, max_gt: int, task: str = "detect",
                  mask_ratio: int = 4, kpt_shape: Tuple[int, int] = (17, 3)) -> Dict[str, np.ndarray]:
    """Labels of a letterboxed sample (xyxy pixels) -> cls (max_gt,) int32,
    bboxes (max_gt, 4) xywh float32 normalised by the image's size (its
    `img`, the sample's `img_shape` (h, w) when the card assembles it, or
    imgsz x imgsz), and mask_gt (max_gt,) bool, the first max_gt boxes of
    positive size in front; a sample with an image gets `img`, its BGR
    channels flipped to RGB (JAX :394-420). The segment task adds `masks`,
    the index-encoded instance mask (imgsz / mask_ratio square, int32): the
    kept boxes' polygons, scaled to it and truncated to int32, filled in
    order with their index + 1 by utils/plotting.py:fill_poly, equal to
    cv2.fillPoly (JAX :465-473). The pose task adds `keypoints` (max_gt,
    nk, 3) float32: the kept boxes' keypoints, xy normalised by the image's
    size, zeros where a sample has none (a mixed-up one, as JAX's, :474-484).
    The obb task's bboxes are (max_gt, 5) float32 cx, cy, w, h normalised
    and the angle in radians, from ops/boxes.py:min_area_rect of each of the
    first max_gt polygons (JAX :423-445, cv2.minAreaRect there): a rectangle
    with a side under 2 px is dropped, the long side put first (the angle
    then turned by pi / 2) and the angle wrapped into [-pi/2, pi/2); a
    mixed-up sample has no polygons and raises IndexError, as JAX's."""
    boxes, cls, img = sample["bboxes"], sample["cls"], sample.get("img")
    h, w = img.shape[:2] if img is not None else sample.get("img_shape", (imgsz, imgsz))
    n = min(len(boxes), max_gt)
    cls_pad, mask = np.zeros((max_gt,), np.int32), np.zeros((max_gt,), bool)
    if task == "obb":
        box_pad, polys, k = np.zeros((max_gt, 5), np.float32), sample.get("segments", []), 0
        for i in range(n):
            (cx, cy), (bw, bh), ang = min_area_rect(np.asarray(polys[i], np.float32))
            if bw < 2 or bh < 2:
                continue
            ang = ang / 180 * np.pi
            if bw < bh:  # the long side first
                bw, bh, ang = bh, bw, ang + np.pi / 2
            box_pad[k] = [cx / w, cy / h, bw / w, bh / h, (ang + np.pi / 2) % np.pi - np.pi / 2]
            cls_pad[k] = cls[i]
            k += 1
        mask[:k] = True
        out = {"cls": cls_pad, "bboxes": box_pad, "mask_gt": mask}
        if img is not None:
            out["img"] = np.ascontiguousarray(img[..., ::-1])
        return out
    box_pad = np.zeros((max_gt, 4), np.float32)
    keep_idx: List[int] = []
    if n:
        b = boxes[:n].astype(np.float32)
        xywh = np.stack([(b[:, 0] + b[:, 2]) / 2 / w, (b[:, 1] + b[:, 3]) / 2 / h,
                         (b[:, 2] - b[:, 0]) / w, (b[:, 3] - b[:, 1]) / h], axis=1)
        good = (xywh[:, 2] > 0) & (xywh[:, 3] > 0)
        keep_idx = list(np.where(good)[0])
        k = len(keep_idx)
        box_pad[:k], cls_pad[:k], mask[:k] = xywh[good], cls[:n][good], True
    out = {"cls": cls_pad, "bboxes": box_pad, "mask_gt": mask}
    if img is not None:
        out["img"] = np.ascontiguousarray(img[..., ::-1])
    if task == "segment":
        mh, mw = imgsz // mask_ratio, imgsz // mask_ratio
        inst = np.zeros((mh, mw), np.int32)
        polys = sample.get("segments", [])  # a mixed-up sample has none, and raises IndexError here, as JAX's
        sx, sy = mw / w, mh / h
        for new_i, i in enumerate(keep_idx):
            fill_poly(inst, (np.asarray(polys[i], np.float32) * [sx, sy]).astype(np.int32), int(new_i) + 1)
        out["masks"] = inst
    elif task == "pose":
        kpt_pad = np.zeros((max_gt, kpt_shape[0], 3), np.float32)
        kpts = sample.get("keypoints")
        if kpts is not None and len(kpts):
            for new_i, i in enumerate(keep_idx):
                kp = kpts[i].copy()
                kp[:, 0] /= w
                kp[:, 1] /= h
                kpt_pad[new_i] = kp
        out["keypoints"] = kpt_pad
    return out


class ValTransform:
    """The val transform (JAX :704): the letterbox geometry (scaleup=False) of
    a sample, its labels (and polygons, or keypoints) scaled and shifted into the
    letterboxed frame and formatted (the segment task's instance mask
    among them), `ori_shape` (h, w) int32 and `ratio_pad` [r, dw, dh]
    float32 for un-letterboxing at metric time. `img` stays the frame at its
    own size: the validator letterboxes a batch on the card
    (letterbox_batch with scaleup=False)."""

    def __init__(self, imgsz: int, max_gt: int = 256, task: str = "detect", mask_ratio: int = 4,
                 kpt_shape: Tuple[int, int] = (17, 3)):
        self.imgsz = imgsz
        self.max_gt = max_gt
        self.task = task
        self.mask_ratio = mask_ratio
        self.kpt_shape = tuple(kpt_shape)

    def __call__(self, sample: Dict) -> Dict[str, np.ndarray]:
        img = sample["img"]
        r, _, _, dw, dh, top, left = letterbox_params(self.imgsz, img.shape[:2])
        boxes = sample["bboxes"].copy()
        if len(boxes):
            boxes[:, :4] *= r
        s = {"cls": sample["cls"], "bboxes": boxes}
        if "segments" in sample:
            s["segments"] = [p * r for p in sample["segments"]]
        if "keypoints" in sample:
            k = sample["keypoints"].copy()
            if len(k):
                k[..., :2] *= r
            s["keypoints"] = k
        out = format_sample(pad_labels(s, dw, dh), self.imgsz, self.max_gt, self.task, self.mask_ratio,
                            self.kpt_shape)
        out["img"] = img
        out["ori_shape"] = np.asarray(img.shape[:2], np.int32)
        out["ratio_pad"] = np.asarray([r, dw, dh], np.float32)
        return out


# -- the training side ------------------------------------------------------
# Counterpart of spectrogram_yolov11_tpu/data/augment.py's train pipeline
# (TrainTransform :547-680) in both modes. Every random number is drawn from
# the sample's numpy Generator in JAX's order, so a sample's labels, image
# parameters and (in host mode) image equal JAX's bit for bit.


def resolve_device_augment(hyp, task: str = "detect") -> bool:
    """True when the card assembles the train images (device-augment mode),
    False when the host augments them, by JAX's rule: 'auto' is on for a
    separable warp (degrees = shear = perspective = 0) without multi_scale
    (engine/trainer.py:218-230); True, or 'auto' resolved on, falls back to
    the host with JAX's warning when mixup > 0, or copy_paste > 0 for the
    segment and obb tasks (data/augment.py:566-580); the pose task has no exception
    (JAX's engine/trainer.py:218). False is host mode.
    albumentations is not installed with either package, so it blocks
    nothing here. multi_scale under device mode is the trainer's to ignore."""
    da = hyp.device_augment
    if isinstance(da, str):
        if da.lower() != "auto":
            raise ValueError(f"device_augment={da!r}: use 'auto', True or False")
        separable = not (float(hyp.degrees or 0) or float(hyp.shear or 0) or float(hyp.perspective or 0))
        da = separable and not bool(hyp.multi_scale)
        if da:
            LOGGER.info("device_augment=auto -> on (separable warp); image augmentation runs on the card in the "
                        "train step")
    blockers = [b for b, on in (("mixup>0", hyp.mixup),
                                ("copy_paste>0", hyp.copy_paste and task in ("segment", "obb"))) if on]
    if da and blockers:
        LOGGER.warning(f"device_augment: falling back to host augmentation ({', '.join(blockers)})")
        da = False
    return bool(da)


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
    """The sample with its boxes (and polygons, or keypoints) shifted by the letterbox's pads (JAX _pad_labels :496)."""
    px, py = int(round(dw - 0.1)), int(round(dh - 0.1))
    boxes = sample["bboxes"].copy()
    if len(boxes):
        boxes[:, [0, 2]] += px
        boxes[:, [1, 3]] += py
    out = dict(sample, bboxes=boxes)
    if "segments" in sample:
        out["segments"] = [p + np.asarray([px, py], np.float32) for p in sample["segments"]]
    if "keypoints" in sample and len(sample["keypoints"]):
        k = sample["keypoints"].copy()
        k[..., 0] += px
        k[..., 1] += py
        out["keypoints"] = k
    return out


def mosaic4(samples: List[Dict], imgsz: int, rng: np.random.Generator, compose_image: bool = False) -> Dict:
    """A 4-image mosaic on a 2S x 2S canvas (JAX mosaic4 :83): centre (xc, yc)
    drawn in [S/2, 3S/2) (yc first), each image clipped to its quadrant, its
    boxes moved by the tile's offset and clipped to the canvas. With
    compose_image the canvas of 114 with the tiles pasted is `img`; without,
    `tiles` holds the images for the card in (4, S, S, 3) uint8, each tile's
    canvas rect [x1a, y1a, x2a, y2a) and its (padw, padh) canvas-to-source
    offset, and the canvas is never built. Polygons (`segments`) and
    keypoints move with their boxes (JAX :106-155)."""
    s = imgsz
    border = (-s // 2, -s // 2)
    yc, xc = (int(rng.uniform(-b, 2 * s + b)) for b in border)
    canvas = np.full((s * 2, s * 2, 3), PAD_VALUE, np.uint8) if compose_image else None
    tiles_src = None if compose_image else np.zeros((4, s, s, 3), np.uint8)
    tiles_reg = np.zeros((4, 4), np.int32)
    tiles_pad = np.zeros((4, 2), np.int32)
    has_seg, has_kpt = "segments" in samples[0], "keypoints" in samples[0]
    cls_out, box_out, seg_out, kpt_out = [], [], [], []
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
        if compose_image:
            canvas[y1a:y2a, x1a:x2a] = img[y1b : y1b + y2a - y1a, x1b : x1b + x2a - x1a]
        else:
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
            if has_seg:
                seg_out.extend([p + np.asarray([padw, padh], np.float32) for p in sample["segments"]])
            if has_kpt:
                k = sample["keypoints"].copy()
                k[..., 0] += padw
                k[..., 1] += padh
                kpt_out.append(k)
    cls_cat = np.concatenate(cls_out) if cls_out else np.zeros((0,), np.int32)
    box_cat = np.clip(np.concatenate(box_out) if box_out else np.zeros((0, 4), np.float32), 0, 2 * s)
    out = {"cls": cls_cat, "bboxes": box_cat, "mosaic_border": border, "img_shape": (s * 2, s * 2)}
    if has_seg:
        out["segments"] = seg_out
    if has_kpt:
        nk = samples[0]["keypoints"].shape[1]
        out["keypoints"] = np.concatenate(kpt_out) if kpt_out else np.zeros((0, nk, 3), np.float32)
    if compose_image:
        out["img"] = canvas
    else:
        out["tiles"] = {"src": tiles_src, "regions": tiles_reg, "pads": tiles_pad}
    return out


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
                       perspective: float, border: Tuple[int, int], rng: np.random.Generator,
                       warp_image: bool = False) -> Dict:
    """The warp M = T @ S @ R @ P @ C of a sample (JAX random_perspective
    :167): the draws of P, the angle, the scale, S and T in JAX's order
    (ranges of 0 included), the boxes' corners warped and re-boxed, clipped
    to the output and filtered by box_candidates; where the sample has
    polygons (`segments`), they are warped and the boxes re-derived from
    them, clipped to the output, and the filter's area threshold is 0.01
    (JAX :222-264); keypoints are warped with their boxes, and a point
    warped outside [0, w] x [0, h] gets visibility 0 (JAX :244-250). With warp_image the
    sample's `img` is warped into the output (border 114) as cv2.warpAffine,
    or cv2.warpPerspective when perspective is set, warps it
    (data/warp.py), unless M is the identity without a border; without, M
    is recorded as `warp_M` for the card and the output size as `img_shape`."""
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
    def warp_pts(pts: np.ndarray) -> np.ndarray:
        xy = np.ones((len(pts), 3))
        xy[:, :2] = pts
        xy = xy @ M.T
        return (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).astype(np.float32)

    boxes, cls, segments, keypoints = sample["bboxes"], sample["cls"], sample.get("segments"), sample.get("keypoints")
    if len(boxes):
        n = len(boxes)
        if segments is not None and len(segments):  # the boxes re-derived from the warped polygons
            segments = [warp_pts(p) for p in segments]
            new = np.stack([np.concatenate([p.min(0).clip([0, 0], [w, h]), p.max(0).clip([0, 0], [w, h])])
                            for p in segments]).astype(np.float32)
        else:
            xy = warp_pts(boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)).reshape(n, 8)
            x, y = xy[:, [0, 2, 4, 6]], xy[:, [1, 3, 5, 7]]
            new = np.stack((x.min(1), y.min(1), x.max(1), y.max(1)), axis=1)
            new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
            new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        if keypoints is not None and len(keypoints):
            nk = keypoints.shape[1]
            flat = warp_pts(keypoints[..., :2].reshape(-1, 2)).reshape(-1, nk, 2)
            vis = keypoints[..., 2:3].copy()
            vis[(flat[..., 0] < 0) | (flat[..., 0] > w) | (flat[..., 1] < 0) | (flat[..., 1] > h)] = 0
            keypoints = np.concatenate([flat, vis], axis=-1).astype(np.float32)
        keep = box_candidates(boxes.T * sc, new.T, area_thr=0.01 if segments is not None and len(segments) else 0.10)
        boxes, cls = new[keep].astype(np.float32), cls[keep]
        if segments is not None and len(segments):
            segments = [p for p, k in zip(segments, keep) if k]
        if keypoints is not None and len(keypoints):
            keypoints = keypoints[keep]
    out = {"cls": cls, "bboxes": boxes, "img_shape": (h, w)}
    if segments is not None:
        out["segments"] = segments if len(boxes) else []
    if keypoints is not None:
        out["keypoints"] = keypoints if len(boxes) else np.zeros((0, sample["keypoints"].shape[1], 3), np.float32)
    if not warp_image:
        return dict(out, warp_M=M, tiles=sample["tiles"])
    img = sample["img"]
    if border[0] or border[1] or (M != np.eye(3)).any():
        img = (warp_perspective_u8 if perspective else warp_affine_u8)(img, M, (w, h), PAD_VALUE)
    return dict(out, img=img)


def draw_hsv_gains(hgain: float, sgain: float, vgain: float, rng: np.random.Generator) -> np.ndarray:
    """The HSV gains (3,) float32, drawn as JAX's draw_hsv_gains (:270): one
    uniform(-1, 1, 3) draw, none when every gain is 0."""
    if hgain or sgain or vgain:
        return (rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1).astype(np.float32)
    return np.ones(3, np.float32)


def augment_hsv(img: np.ndarray, hgain: float, sgain: float, vgain: float, rng: np.random.Generator) -> np.ndarray:
    """JAX's augment_hsv (:68) of a BGR uint8 image: gains from one
    uniform(-1, 1, 3) draw (none when every gain is 0), uint8 tables built in
    float64 (hue x * g % 180, saturation and value x * g clipped to 0-255,
    truncated), applied between cv2's BGR -> HSV and HSV -> BGR by
    data/warp.py:augment_hsv_u8, in place on a C-contiguous image (the
    warp's or the blend's output); returns the image."""
    if not (hgain or sgain or vgain):
        return img
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    x = np.arange(0, 256, dtype=r.dtype)
    luts = np.stack([((x * r[0]) % 180).astype(np.uint8), np.clip(x * r[1], 0, 255).astype(np.uint8),
                     np.clip(x * r[2], 0, 255).astype(np.uint8)])
    augment_hsv_u8(img, luts)
    return img


def copy_paste(sample: Dict, p: float, rng: np.random.Generator) -> Dict:
    """JAX's copy_paste in 'flip' mode (:331-375) on a host sample with
    polygons: the image mirrored left-right; of the instances whose mirrored
    box covers under 0.30 of every existing box (IoA), round(p * count) drawn
    by rng.choice without replacement are pasted: their mirrored polygons
    (truncated to int32) filled into a mask by fill_poly (cv2.fillPoly's
    pixels), the mirrored image's pixels copied under it, and their class,
    mirrored box and polygon appended, and their keypoints mirrored where the
    sample has any (JAX :375-378: a pose sample has no polygons, so the
    step leaves it alone). Nothing is drawn when no instance qualifies or
    p <= 0."""
    segments = sample.get("segments")
    if not segments or p <= 0:
        return sample
    img = sample["img"]
    h, w = img.shape[:2]
    boxes = sample["bboxes"]
    flipped_boxes = boxes.copy()
    flipped_boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    x1 = np.maximum(flipped_boxes[:, None, 0], boxes[None, :, 0])
    y1 = np.maximum(flipped_boxes[:, None, 1], boxes[None, :, 1])
    x2 = np.minimum(flipped_boxes[:, None, 2], boxes[None, :, 2])
    y2 = np.minimum(flipped_boxes[:, None, 3], boxes[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = np.clip(boxes[:, 2] - boxes[:, 0], 1e-9, None) * np.clip(boxes[:, 3] - boxes[:, 1], 1e-9, None)
    candidates = np.nonzero((inter / area[None] < 0.30).all(1))[0]
    k = round(p * len(candidates))
    if k == 0:
        return sample
    chosen = rng.choice(candidates, k, replace=False)
    mask = np.zeros((h, w), np.uint8)
    new_segs = []
    for j in chosen:
        seg_f = segments[j].copy()
        seg_f[:, 0] = w - seg_f[:, 0]
        fill_poly(mask, seg_f.astype(np.int32), 1)
        new_segs.append(seg_f)
    img = img.copy()
    m = mask.astype(bool)
    img[m] = img[:, ::-1][m]
    out = dict(sample, img=img, cls=np.concatenate([sample["cls"], sample["cls"][chosen]]),
               bboxes=np.concatenate([boxes, flipped_boxes[chosen]]), segments=list(segments) + new_segs)
    if "keypoints" in sample and len(sample["keypoints"]):
        kf = sample["keypoints"][chosen].copy()
        kf[..., 0] = w - kf[..., 0]
        out["keypoints"] = np.concatenate([sample["keypoints"], kf])
    return out


def mixup(sample1: Dict, sample2: Dict, rng: np.random.Generator) -> Dict:
    """JAX's mixup (:382): r from beta(32, 32), the images blended in float32
    as img1 * r + img2 * (1 - r) and truncated to uint8, the labels joined
    (boxes and classes: polygons and keypoints are dropped, as JAX's drops them)."""
    r = rng.beta(32.0, 32.0)
    img = (sample1["img"].astype(np.float32) * r + sample2["img"].astype(np.float32) * (1 - r)).astype(np.uint8)
    return {"img": img, "cls": np.concatenate([sample1["cls"], sample2["cls"]]),
            "bboxes": np.concatenate([sample1["bboxes"], sample2["bboxes"]])}


def random_flip(sample: Dict, fliplr: float, flipud: float, rng: np.random.Generator,
                flip_image: bool = False, flip_idx: Optional[Sequence[int]] = None) -> Dict:
    """The flips (JAX random_flip :278): up-down first, then left-right, each
    drawn only when its probability is non-zero, applied to the boxes,
    polygons (`segments`) and keypoints, whose left-right flip also reorders
    them by flip_idx (JAX :288-327). With
    flip_image the sample's `img` is flipped too; without, the flips are
    recorded as `flips` (up-down, left-right) for the warp's inverse."""
    boxes, segments, keypoints = sample["bboxes"], sample.get("segments"), sample.get("keypoints")
    img = sample.get("img")
    h, w = sample["img_shape"]
    did_ud = did_lr = False
    if flipud and rng.random() < flipud:
        did_ud = True
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
            if segments is not None:
                segments = [np.stack([p[:, 0], h - p[:, 1]], 1) for p in segments]
            if keypoints is not None and len(keypoints):
                keypoints = keypoints.copy()
                keypoints[..., 1] = h - keypoints[..., 1]
    if fliplr and rng.random() < fliplr:
        did_lr = True
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
            if segments is not None:
                segments = [np.stack([w - p[:, 0], p[:, 1]], 1) for p in segments]
            if keypoints is not None and len(keypoints):
                keypoints = keypoints.copy()
                keypoints[..., 0] = w - keypoints[..., 0]
                if flip_idx is not None:
                    keypoints = keypoints[:, list(flip_idx)]
    extra = {} if segments is None else {"segments": segments}
    if keypoints is not None:
        extra["keypoints"] = keypoints
    if not flip_image:
        return dict(sample, bboxes=boxes, flips=(did_ud, did_lr), **extra)
    img = img[::-1] if did_ud else img
    img = img[:, ::-1] if did_lr else img
    return {"img": np.ascontiguousarray(img), "cls": sample["cls"], "bboxes": boxes, **extra}


class TrainTransform:
    """The train transform (JAX TrainTransform :547-680): `__call__(idx,
    rng)` gives sample idx's formatted labels (cls, bboxes, mask_gt) and its
    image, in the mode resolve_device_augment picks (`device_mode`).

    Device mode (JAX's _call_device): the parameters the card assembles the
    image from: `aug_src` (4, S, S, 3) uint8 BGR tiles, `aug_regions` (4, 4)
    int32 canvas rects, `aug_pads` (4, 2) int32 offsets, `aug_inv` (3, 3)
    float32 output-index to canvas matrix (inv(M) with the flips folded in as
    index reflections) and `aug_hsv` (3,) float32 gains. Draws, in order:
    mosaic or not (only while mosaic is on), the 3 partner indices and the
    centre, the warp, the HSV gains, the flips.

    Host mode (JAX's __call__): `img` (S, S, 3) uint8 RGB, augmented here.
    Draws, in order: mosaic or not, its partners and centre (else the
    letterbox); the warp of the canvas (data/warp.py); while mosaic is on,
    mixup or not, then the partner's index, its mosaic and warp, and the
    blend's beta; the HSV gains; the flips. JAX's Albumentations hook draws
    nothing when the albumentations package is absent, and neither machine
    has it, so the port has none. The segment task (JAX's `task`): the
    polygons go through mosaic, the warp and the flips, and `masks` is the
    index-encoded instance mask at imgsz / mask_ratio (format_sample); in
    host mode copy_paste (p = hyp.copy_paste) runs after the mosaic or
    letterbox and draws its choice there (JAX :604). The pose task: the
    keypoints go through mosaic, the warp and the flips (left-right by
    `flip_idx`), in both modes, and `keypoints` is (max_gt, nk, 3)
    (format_sample at `kpt_shape`). The obb task: each box's 4-point polygon
    goes through mosaic, the warp (which re-derives the boxes from it) and
    the flips in both modes, copy_paste in host mode as the segment task's,
    and format_sample turns it into the rotated box (max_gt, 5).

    close_mosaic() turns mosaic off for later samples."""

    def __init__(self, dataset, imgsz: int, hyp, max_gt: int = 128, task: str = "detect", mask_ratio: int = 4,
                 kpt_shape: Tuple[int, int] = (17, 3), flip_idx: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.imgsz = imgsz
        self.hyp = hyp
        self.max_gt = max_gt
        self.task = task
        self.mask_ratio = mask_ratio
        self.kpt_shape = tuple(kpt_shape)
        self.flip_idx = flip_idx
        self.mosaic_enabled = True
        self.device_mode = resolve_device_augment(hyp, task)

    def close_mosaic(self) -> None:
        self.mosaic_enabled = False

    def _mosaic(self, idx: int, rng: np.random.Generator, compose_image: bool) -> Dict:
        idxs = [idx] + list(rng.integers(0, len(self.dataset), 3))
        return mosaic4([self.dataset.load_sample(int(i), square_to=self.imgsz) for i in idxs], self.imgsz, rng,
                       compose_image)

    def _warp(self, sample: Dict, border, rng: np.random.Generator, warp_image: bool) -> Dict:
        h = self.hyp
        return random_perspective(sample, h.degrees, h.translate, h.scale, h.shear, h.perspective, border, rng,
                                  warp_image)

    def __call__(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        h, s, host = self.hyp, self.imgsz, not self.device_mode
        use_mosaic = self.mosaic_enabled and rng.random() < h.mosaic
        if use_mosaic:
            sample = self._mosaic(idx, rng, compose_image=host)
            border = sample.pop("mosaic_border")
        else:
            raw = self.dataset.load_sample(idx, square_to=s)
            img, dw, dh = letterbox_train(raw["img"], s)
            sample = dict(pad_labels(raw, dw, dh), img_shape=(s, s))
            if host:
                sample["img"] = img
            else:
                src = np.zeros((4, s, s, 3), np.uint8)
                src[0] = img
                regions = np.zeros((4, 4), np.int32)
                regions[0] = (0, 0, s, s)
                del sample["img"]
                sample["tiles"] = {"src": src, "regions": regions, "pads": np.zeros((4, 2), np.int32)}
            border = (0, 0)
        if host and h.copy_paste and "segments" in sample:
            sample = copy_paste(sample, h.copy_paste, rng)
        sample = self._warp(sample, border, rng, warp_image=host)
        if host:
            if use_mosaic and h.mixup and rng.random() < h.mixup:
                other = self._mosaic(int(rng.integers(0, len(self.dataset))), rng, compose_image=True)
                other = self._warp(other, other.pop("mosaic_border"), rng, warp_image=True)
                sample = dict(mixup(sample, other, rng), img_shape=sample["img_shape"])
            sample["img"] = augment_hsv(sample["img"], h.hsv_h, h.hsv_s, h.hsv_v, rng)
            return format_sample(random_flip(sample, h.fliplr, h.flipud, rng, flip_image=True, flip_idx=self.flip_idx),
                                 s, self.max_gt, self.task, self.mask_ratio, self.kpt_shape)
        hsv = draw_hsv_gains(h.hsv_h, h.hsv_s, h.hsv_v, rng)
        sample = random_flip(sample, h.fliplr, h.flipud, rng, flip_idx=self.flip_idx)
        out = format_sample(sample, s, self.max_gt, self.task, self.mask_ratio, self.kpt_shape)
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
