"""Warps and HSV conversions of uint8 BGR images on the host, equal to OpenCV's.

The JAX package's host augmentation (spectrogram_yolov11_tpu/data/augment.py)
warps with cv2.warpAffine / cv2.warpPerspective (:211-214, border 114) and
jitters HSV with cv2.cvtColor BGR<->HSV and cv2.LUT (augment_hsv :68). The
port has no cv2: `warp_affine_u8`, `warp_perspective_u8`, `bgr_to_hsv_u8`,
`hsv_to_bgr_u8` and `augment_hsv_u8` run csrc/warp.cpp (the host library
`image_warp`, built at first use by utils/kernels.py), whose header gives
the arithmetic; each output equals OpenCV 5.0.0's byte for byte
(tests/test_torch_host_augment.py).

Each has a numpy twin (`*_np`) that computes the same bytes the same way:
the plain version the tests hold the C++ to. The augmentation runs the C++
only; nothing falls back to a twin. numpy has no fused multiply-add, so
`fma32` computes one exactly: the product of two float32 values is exact in
float64, the sum is rounded to odd in float64 (TwoSum gives its error) and
then to nearest float32, which is the single rounding of a*b + c.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..utils import kernels

WARP_BLOCK = 16  # output columns per vector block of OpenCV's warp kernels (csrc/warp.cpp)
HSV_BLOCK = 32  # pixels per vector block of OpenCV's 8-bit HSV -> BGR


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data_as(ctypes.c_void_p).value


def _bgr(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a (H, W, 3) uint8 image, got {img.dtype} {img.shape}")
    return img


def warp_affine_u8(img: np.ndarray, M: np.ndarray, dsize, border: int = 114) -> np.ndarray:
    """cv2.warpAffine(img, M[:2], dsize=(w, h), borderValue=(border,) * 3) of
    a (H, W, 3) uint8 image: M is the forward 2x3 (or 3x3) float64 matrix."""
    img = _bgr(img)
    w, h = int(dsize[0]), int(dsize[1])
    out = np.empty((h, w, 3), np.uint8)
    m = np.ascontiguousarray(np.asarray(M, np.float64)[:2].reshape(6))
    kernels.load("image_warp").warp_affine_u8(_ptr(img), img.shape[0], img.shape[1], _ptr(out), h, w, _ptr(m),
                                              int(border))
    return out


def warp_perspective_u8(img: np.ndarray, M: np.ndarray, dsize, border: int = 114) -> np.ndarray:
    """cv2.warpPerspective(img, M, dsize=(w, h), borderValue=(border,) * 3) of
    a (H, W, 3) uint8 image: M is the forward 3x3 float64 matrix."""
    img = _bgr(img)
    w, h = int(dsize[0]), int(dsize[1])
    out = np.empty((h, w, 3), np.uint8)
    m = np.ascontiguousarray(np.asarray(M, np.float64).reshape(9))
    if kernels.load("image_warp").warp_perspective_u8(_ptr(img), img.shape[0], img.shape[1], _ptr(out), h, w,
                                                      _ptr(m), int(border)):
        raise ValueError("warp_perspective_u8: singular matrix")
    return out


def bgr_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2HSV) of a (H, W, 3) uint8 image (hue 0-180)."""
    img = _bgr(img)
    out = np.empty_like(img)
    kernels.load("image_warp").bgr_to_hsv_u8(_ptr(img), _ptr(out), img.shape[0] * img.shape[1])
    return out


def hsv_to_bgr_u8(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HSV2BGR) of a (H, W, 3) uint8 image (hue 0-180)."""
    img = _bgr(img)
    out = np.empty_like(img)
    kernels.load("image_warp").hsv_to_bgr_u8(_ptr(img), _ptr(out), img.shape[0], img.shape[1])
    return out


def augment_hsv_u8(img: np.ndarray, luts: np.ndarray) -> None:
    """In place on a C-contiguous (H, W, 3) uint8 BGR image: HSV, each channel
    through its row of `luts` (3, 256) uint8 (hue, saturation, value), and
    back to BGR, as JAX's cvtColor, LUT, merge and cvtColor do."""
    if not (img.flags.c_contiguous and img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3):
        raise ValueError("augment_hsv_u8: expected a C-contiguous (H, W, 3) uint8 image")
    luts = np.ascontiguousarray(luts, np.uint8)
    kernels.load("image_warp").augment_hsv_u8(_ptr(img), img.shape[0], img.shape[1], _ptr(luts))


# -- the numpy twins ----------------------------------------------------------

def fma32(a, b, c) -> np.ndarray:
    """float32(a * b + c) rounded once, for float32 a, b, c (arrays or scalars)."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b  # exact: 24 + 24 bits
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)  # TwoSum: s + e == p + c exactly
    even = (np.atleast_1d(s).view(np.int64) & 1) == 0
    s = np.where((e != 0) & even.reshape(np.shape(s)), np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def invert_affine_np(M: np.ndarray) -> np.ndarray:
    """(6,) float32: cv2's inverse of the 2x3 M, computed in float64 as csrc/warp.cpp."""
    m = [float(v) for v in np.asarray(M, np.float64)[:2].reshape(6)]
    D = m[0] * m[4] - m[1] * m[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22, a12, a21 = m[4] * D, m[0] * D, m[1] * -D, m[3] * -D
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.asarray([a11, a12, b1, a21, a22, b2], np.float64).astype(np.float32)


def invert_perspective_np(M: np.ndarray) -> np.ndarray:
    """(9,) float32: cv::invert of the 3x3 M by its closed form, as csrc/warp.cpp."""
    S = [float(v) for v in np.asarray(M, np.float64).reshape(9)]
    d = (S[0] * (S[4] * S[8] - S[7] * S[5]) - S[1] * (S[3] * S[8] - S[6] * S[5]) +
         S[2] * (S[3] * S[7] - S[6] * S[4]))
    if d == 0:
        raise ValueError("singular matrix")
    r = 1.0 / d
    t = [(S[4] * S[8] - S[5] * S[7]) * r, (S[2] * S[7] - S[1] * S[8]) * r, (S[1] * S[5] - S[2] * S[4]) * r,
         (S[5] * S[6] - S[3] * S[8]) * r, (S[0] * S[8] - S[2] * S[6]) * r, (S[2] * S[3] - S[0] * S[5]) * r,
         (S[3] * S[7] - S[4] * S[6]) * r, (S[1] * S[6] - S[0] * S[7]) * r, (S[0] * S[4] - S[1] * S[3]) * r]
    return np.asarray(t, np.float64).astype(np.float32)


def _sample_np(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border: int) -> np.ndarray:
    h, w = img.shape[:2]
    out_of = ~((sx >= -1) & (sx < w) & (sy >= -1) & (sy < h))  # NaN compares False: out
    sx, sy = np.where(out_of, np.float32(-2), sx), np.where(out_of, np.float32(-2), sy)
    fx, fy = np.floor(sx), np.floor(sy)
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)
    a, b = (sx - fx)[..., None], (sy - fy)[..., None]
    pad = np.full((h + 4, w + 4, 3), border, np.float32)
    pad[2 : h + 2, 2 : w + 2] = img
    cx, cy = np.clip(ix, -2, w + 1) + 2, np.clip(iy, -2, h + 1) + 2
    p00, p01, p10, p11 = pad[cy, cx], pad[cy, cx + 1], pad[cy + 1, cx], pad[cy + 1, cx + 1]
    t = fma32(a, p01 - p00, p00)
    u = fma32(a, p11 - p10, p10)
    v = np.clip(np.rint(fma32(b, u - t, t)), 0, 255).astype(np.uint8)
    v[out_of] = border
    return v


def _grid(h: int, w: int):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return x, y, x < (w // WARP_BLOCK) * WARP_BLOCK


def warp_affine_np(img: np.ndarray, M: np.ndarray, dsize, border: int = 114) -> np.ndarray:
    """The numpy twin of warp_affine_u8."""
    m = invert_affine_np(M)
    x, y, vec = _grid(int(dsize[1]), int(dsize[0]))
    bx, by = _f32(y * m[1]) + m[2], _f32(y * m[4]) + m[5]
    sx = np.where(vec, fma32(m[0], x, bx), fma32(x, m[0], y * m[1]) + m[2])
    sy = np.where(vec, fma32(m[3], x, by), fma32(x, m[3], y * m[4]) + m[5])
    return _sample_np(img, _f32(sx), _f32(sy), border)


def warp_perspective_np(img: np.ndarray, M: np.ndarray, dsize, border: int = 114) -> np.ndarray:
    """The numpy twin of warp_perspective_u8."""
    m = invert_perspective_np(M)
    x, y, vec = _grid(int(dsize[1]), int(dsize[0]))
    rows = [(_f32(y * m[k + 1]) + m[k + 2]) for k in (0, 3, 6)]
    nx, ny, w = (np.where(vec, fma32(m[k], x, base), fma32(x, m[k], y * m[k + 1]) + m[k + 2])
                 for k, base in zip((0, 3, 6), rows))
    with np.errstate(divide="ignore", invalid="ignore"):
        return _sample_np(img, _f32(_f32(nx) / _f32(w)), _f32(_f32(ny) / _f32(w)), border)


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << 12) / i)]).astype(np.int64)
    hdiv = np.concatenate([[0], np.rint((180 << 12) / (6.0 * i))]).astype(np.int64)
    return sdiv, hdiv


def bgr_to_hsv_np(img: np.ndarray) -> np.ndarray:
    """The numpy twin of bgr_to_hsv_u8."""
    sdiv, hdiv = _hsv_tables()
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * sdiv[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << 11)) >> 12
    h += np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_bgr_np(img: np.ndarray, luts: Optional[np.ndarray] = None) -> np.ndarray:
    """The numpy twin of hsv_to_bgr_u8 (each channel through `luts` first when given)."""
    if luts is not None:
        img = np.stack([luts[k][img[..., k]] for k in range(3)], -1)
    one, inv255 = np.float32(1), np.float32(1.0 / 255.0)
    s = _f32(img[..., 1].astype(np.float32) * inv255)
    v = _f32(img[..., 2].astype(np.float32) * inv255)
    h = np.fmod(_f32(img[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)), np.float32(6))
    sector = np.floor(h).astype(np.int64)
    h = _f32(h - sector)
    bad = (sector < 0) | (sector >= 6)
    sector, h = np.where(bad, 0, sector), np.where(bad, np.float32(0), h)
    tab = np.stack([v, _f32(v * (one - s)), _f32(v * fma32(-s, h, one)), _f32(v * fma32(-s, one - h, one))], -1)
    order = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    bgr = np.take_along_axis(tab, order[sector], -1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    x = _f32(bgr * np.float32(255))
    vec = (np.arange(img.shape[1]) < (img.shape[1] // HSV_BLOCK) * HSV_BLOCK)[None, :, None]
    return np.clip(np.where(vec, np.trunc(x), np.rint(x)), 0, 255).astype(np.uint8)


def augment_hsv_np(img: np.ndarray, luts: np.ndarray) -> np.ndarray:
    """The numpy twin of augment_hsv_u8 (returns the new image)."""
    return hsv_to_bgr_np(bgr_to_hsv_np(img), luts)
