"""Seeded synthetic datasets: LTE/RF spectrograms and coloured shapes.

A copy of spectrogram_yolov11_tpu/data/synth.py:207 _synth_iq (numpy only);
a frame maker that resizes the (F, T) spectrogram as the JAX package's
cv2.resize(INTER_LINEAR) (:252) does, through data/augment.py's
resize_linear_u8; and `maybe_generate` (JAX :25) with its two detect kinds
and the segment kind:

- `spectrogram` (`_gen_spectrogram`, JAX :243) writes the split as PNG
  through data/imageio.py where the JAX package writes JPEG through cv2. The
  rng stream is JAX's, so the labels are equal, and a frame equals the JAX
  package's pre-JPEG frame (tests/test_torch_dataset.py).
- `shapes` (`_gen_shapes`, JAX :80-105: coco8.yaml, coco128.yaml,
  shapes128.yaml and the other detect stand-ins) writes JAX's files byte for
  byte: low-frequency noise (S/8 squares resized by resize_linear_u8), 1-6
  glyphs whose class cycles through a filled rectangle, ellipse and triangle
  (utils/plotting.py: rectangle, ellipse_filled and fill_poly, each equal
  to cv2's), JPEG at quality 95 by the port's encoder (equal to
  cv2.imwrite), labels with 6 decimals; nc from the YAML's `names`.
- `shapes-seg` (`_gen_shapes_seg`, JAX :114-135: shapes128-seg.yaml,
  coco8-seg.yaml and the other segment stand-ins) likewise writes JAX's
  files byte for byte: the same noise, 1-4 star-shaped polygons of 8 or 16
  points (by class parity) filled by fill_poly, the label rows the class
  and the normalised points with 6 decimals.
- `shapes-pose` (`_gen_shapes_pose`, JAX :138-171: shapes128-pose.yaml,
  coco8-pose.yaml and the other pose stand-ins, nk and nd from the YAML's
  `kpt_shape`) likewise: the same noise, 1-3 filled rectangles, each
  keypoint a filled red disc of radius 4 (utils/plotting.py:circle, equal
  to cv2.circle), the label rows the class, the box and each keypoint's
  normalised xy (and visibility 2 when nd = 3), formatted as JAX's.
- `shapes-obb` (`_gen_shapes_obb`, JAX :178-203: shapes128-obb.yaml,
  dota8.yaml, DOTAv1.yaml and DOTAv1.5.yaml) likewise: the same noise, 1-4
  rotated rectangles (a box for an even class, a bar for an odd one) whose
  corners are ops/boxes.py:box_points (cv2.boxPoints' float32 corners),
  skipped when a corner leaves [0, imgsz - 1], filled by fill_poly at the
  corners truncated to int32; the label rows the class and the normalised
  corners with 6 decimals.

Any other kind raises KeyError, as JAX's table lookup does.

`gen_cls_shapes` (JAX :263) writes the classify task's folder-per-class
stand-in (data/dataset.py:check_cls_dataset, the `cls-shapes` kind of
ImageNet.yaml) byte for byte as JAX's: per image the same noise, then one
filled glyph of the class's shape (class index % 3: rectangle, circle,
triangle) in a colour from [120, 255), JPEG at quality 95.
"""

from __future__ import annotations

from pathlib import Path
import numpy as np
import torch

from ..ops.boxes import box_points
from ..ops.stft import spectrogram_numpy
from ..utils import LOGGER
from ..utils.plotting import circle, ellipse_filled, fill_poly, rectangle
from .augment import resize_linear_u8
from .imageio import imwrite


def synth_iq(rng: np.random.Generator, n_samples: int):
    """One IQ capture: noise floor + LTE-like wideband bursts + RF narrowband
    bursts. Returns (iq complex64, events) with events (cls, t0, t1, f0, f1)
    normalized, f in [0, 1) along the fftshifted axis."""
    iq = (rng.normal(0, 0.05, n_samples) + 1j * rng.normal(0, 0.05, n_samples)).astype(np.complex64)
    t = np.arange(n_samples, dtype=np.float32)
    events = []
    for _ in range(int(rng.integers(1, 5))):
        cls = int(rng.integers(0, 2))
        t0 = rng.uniform(0, 0.7)
        dur = rng.uniform(0.1, 0.3) if cls == 0 else rng.uniform(0.05, 0.25)
        t1 = min(t0 + dur, 1.0)
        i0, i1 = int(t0 * n_samples), int(t1 * n_samples)
        fc = rng.uniform(-0.42, 0.42)  # cycles/sample; fftshift maps it to fc + 0.5
        if cls == 0:  # LTE-like: brick-wall filtered noise, bandwidth 6-20% of fs
            bw = rng.uniform(0.06, 0.2)
            n_seg = i1 - i0
            base = rng.normal(0, 1, n_seg) + 1j * rng.normal(0, 1, n_seg)
            spec = np.fft.fft(base)
            spec[np.abs(np.fft.fftfreq(n_seg)) > bw / 2] = 0
            sig = np.fft.ifft(spec) * rng.uniform(2.0, 6.0)
            iq[i0:i1] += (sig * np.exp(2j * np.pi * fc * t[i0:i1])).astype(np.complex64)
        else:  # RF narrowband: tone or slow chirp
            bw = rng.uniform(0.004, 0.02)
            drift = rng.uniform(-bw, bw)
            amp = rng.uniform(1.5, 5.0)
            phase = 2 * np.pi * (fc * t[i0:i1] + 0.5 * drift / max(i1 - i0, 1) * (t[i0:i1] - i0) ** 2 / max(i1 - i0, 1))
            iq[i0:i1] += (amp * np.exp(1j * phase)).astype(np.complex64)
        f_center = fc + 0.5
        f0, f1 = max(f_center - bw / 2 - 0.005, 0.0), min(f_center + bw / 2 + 0.005, 1.0)
        events.append((cls, t0, t1, f0, f1))
    return iq, events


def synth_frame(rng: np.random.Generator, height: int, width: int, n_fft: int = 256, hop: int = 128):
    """One IQ capture with `width` STFT time frames drawn from rng, as a
    (height, width) uint8 gray frame resized as cv2's INTER_LINEAR, and its events."""
    iq, events = synth_iq(rng, n_fft + hop * (width - 1))
    img = torch.from_numpy((spectrogram_numpy(iq, n_fft=n_fft, hop=hop) * 255).astype(np.uint8))
    return resize_linear_u8(img[None, ..., None], height, width)[0, ..., 0].numpy(), events


def synth_frames(n: int, height: int, width: int, seed: int = 0, n_fft: int = 256, hop: int = 128) -> np.ndarray:
    """(n, height, width, 1) uint8 gray spectrogram frames, one IQ capture each
    with `width` STFT time frames, resized to (height, width) as synth_frame."""
    rng = np.random.default_rng(seed)
    return np.stack([synth_frame(rng, height, width, n_fft, hop)[0] for _ in range(n)])[..., None]


def maybe_generate(data: dict) -> bool:
    """Materialise the synthetic dataset a dataset YAML describes (key
    `synthetic`) when its val split is missing: n_train images into each
    `train` dir with seed + j and n_val into each `val` dir with seed + 10000,
    as the JAX package does. Returns False for a YAML with no `synthetic` key.
    The kinds are JAX's: `spectrogram`, `shapes`, `shapes-seg`,
    `shapes-pose` and `shapes-obb`; another raises KeyError, as JAX's."""
    kind = data.get("synthetic")
    if not kind:
        return False
    if kind not in ("spectrogram", "shapes", "shapes-seg", "shapes-pose", "shapes-obb"):
        raise KeyError(kind)
    n_train, n_val = int(data.get("n_train", 64)), int(data.get("n_val", 16))
    imgsz, seed = int(data.get("gen_imgsz", 640)), int(data.get("seed", 0))
    vals = data["val"] if isinstance(data["val"], list) else [data["val"]]
    if Path(vals[0]).exists():
        return True
    LOGGER.info(f"Generating synthetic '{kind}' dataset at {data['path']} ({n_train} train / {n_val} val)...")
    trains = data["train"] if isinstance(data["train"], list) else [data["train"]]
    jobs = [(d, n_train, seed + j) for j, d in enumerate(trains)] + [(d, n_val, seed + 10_000) for d in vals]
    for d, n, s in jobs:  # <root>/images/<split> -> <root>/labels/<split>
        if kind == "shapes":
            _gen_shapes(Path(d).parent.parent, Path(d).name, n, imgsz, s, nc=len(data.get("names") or range(3)))
        elif kind == "shapes-seg":
            _gen_shapes_seg(Path(d).parent.parent, Path(d).name, n, imgsz, s, nc=len(data.get("names") or range(2)))
        elif kind == "shapes-pose":
            _gen_shapes_pose(Path(d).parent.parent, Path(d).name, n, imgsz, s, nc=len(data.get("names") or range(1)),
                             kpt_shape=tuple(data.get("kpt_shape") or (5, 3)))
        elif kind == "shapes-obb":
            _gen_shapes_obb(Path(d).parent.parent, Path(d).name, n, imgsz, s, nc=len(data.get("names") or range(2)))
        else:
            _gen_spectrogram(Path(d).parent.parent, Path(d).name, n, imgsz, s)
    return True


def _write_sample(root: Path, split: str, i: int, img: np.ndarray, labels: list, suffix: str) -> None:
    """Image i of a split and its YOLO label rows (cls cx cy w h, 6 decimals)."""
    (root / "images" / split).mkdir(parents=True, exist_ok=True)
    (root / "labels" / split).mkdir(parents=True, exist_ok=True)
    imwrite(root / "images" / split / f"{i:05d}{suffix}", img)
    lines = [f"{c} {x:.6f} {y:.6f} {w:.6f} {h:.6f}" for c, x, y, w, h in labels]
    (root / "labels" / split / f"{i:05d}.txt").write_text("\n".join(lines))


def _gen_shapes(root: Path, split: str, n: int, imgsz: int, seed: int, nc: int = 3) -> None:
    """n JPEGs of imgsz x imgsz: noise of imgsz / 8 squares resized 8x, and
    1-6 filled glyphs, glyph cls % 3 (rectangle, ellipse, triangle) for any
    of the nc classes, with their labels (JAX :80-105, the same draws)."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        base = rng.integers(40, 160, (imgsz // 8, imgsz // 8, 3), dtype=np.uint8)
        img = resize_linear_u8(torch.from_numpy(base)[None], imgsz, imgsz)[0].numpy().copy()
        labels = []
        for _ in range(int(rng.integers(1, 7))):
            cls = int(rng.integers(0, nc))
            w = int(rng.uniform(0.08, 0.3) * imgsz)
            h = int(rng.uniform(0.08, 0.3) * imgsz)
            x1 = int(rng.uniform(0, imgsz - w))
            y1 = int(rng.uniform(0, imgsz - h))
            color = tuple(int(c) for c in rng.integers(100, 255, 3))
            if cls % 3 == 0:
                rectangle(img, (x1, y1), (x1 + w, y1 + h), color, -1)
            elif cls % 3 == 1:
                ellipse_filled(img, (x1 + w // 2, y1 + h // 2), (w // 2, h // 2), color)
            else:
                fill_poly(img, [(x1 + w // 2, y1), (x1, y1 + h), (x1 + w, y1 + h)], color)
            labels.append((cls, (x1 + w / 2) / imgsz, (y1 + h / 2) / imgsz, w / imgsz, h / imgsz))
        _write_sample(root, split, i, img, labels, ".jpg")


def _rand_polygon(rng: np.random.Generator, cx: float, cy: float, rad: float, n_pts: int = 8) -> np.ndarray:
    """A star-shaped polygon of n_pts points around (cx, cy), float32 (JAX :107)."""
    angles = np.sort(rng.uniform(0, 2 * np.pi, n_pts))
    radii = rng.uniform(0.5, 1.0, n_pts) * rad
    return np.stack([cx + radii * np.cos(angles), cy + radii * np.sin(angles)], 1).astype(np.float32)


def _gen_shapes_seg(root: Path, split: str, n: int, imgsz: int, seed: int, nc: int = 2) -> None:
    """n JPEGs of imgsz x imgsz: the shapes kind's noise and 1-4 filled
    polygons (8 points for an even class, 16 for an odd one, clipped to the
    image) with their segment label rows, cls and the normalised points
    (JAX :114-135, the same draws)."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        base = rng.integers(40, 160, (imgsz // 8, imgsz // 8, 3), dtype=np.uint8)
        img = resize_linear_u8(torch.from_numpy(base)[None], imgsz, imgsz)[0].numpy().copy()
        lines = []
        for _ in range(int(rng.integers(1, 5))):
            cls = int(rng.integers(0, nc))
            cx, cy = rng.uniform(0.15, 0.85, 2) * imgsz
            rad = rng.uniform(0.05, 0.15) * imgsz
            poly = np.clip(_rand_polygon(rng, cx, cy, rad, n_pts=8 if cls % 2 == 0 else 16), 0, imgsz - 1)
            color = tuple(int(c) for c in rng.integers(100, 255, 3))
            fill_poly(img, poly.astype(np.int32), color)
            lines.append(f"{cls} " + " ".join(f"{v:.6f}" for v in (poly / imgsz).reshape(-1)))
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        imwrite(root / "images" / split / f"{i:05d}.jpg", img)
        (root / "labels" / split / f"{i:05d}.txt").write_text("\n".join(lines))


def _gen_shapes_pose(root: Path, split: str, n: int, imgsz: int, seed: int, nc: int = 1,
                     kpt_shape=(5, 3)) -> None:
    """n JPEGs of imgsz x imgsz: the shapes kind's noise and 1-3 filled
    rectangles, each with nk keypoints drawn as red discs of radius 4: at
    5 keypoints its corners and centre, otherwise nk points on its inscribed
    ellipse; the label rows `cls cx cy w h` and each keypoint's normalised
    xy, with visibility 2 when nd = 3 (JAX :138-171, the same draws and the
    same formatting: 6 decimals for a Python float, str() for the rest)."""
    rng = np.random.default_rng(seed)
    nk, ndim = int(kpt_shape[0]), int(kpt_shape[1])
    for i in range(n):
        base = rng.integers(40, 160, (imgsz // 8, imgsz // 8, 3), dtype=np.uint8)
        img = resize_linear_u8(torch.from_numpy(base)[None], imgsz, imgsz)[0].numpy().copy()
        labels = []
        for _ in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(0, nc))
            w = rng.uniform(0.1, 0.3) * imgsz
            h = rng.uniform(0.1, 0.3) * imgsz
            x1 = rng.uniform(0, imgsz - w)
            y1 = rng.uniform(0, imgsz - h)
            color = tuple(int(c) for c in rng.integers(100, 255, 3))
            rectangle(img, (int(x1), int(y1)), (int(x1 + w), int(y1 + h)), color, -1)
            if nk == 5:
                kps = np.array([[x1, y1], [x1 + w, y1], [x1 + w, y1 + h], [x1, y1 + h], [x1 + w / 2, y1 + h / 2]],
                               np.float32)
            else:
                th = 2 * np.pi * np.arange(nk, dtype=np.float32) / nk
                kps = np.stack([x1 + w / 2 + w / 2 * np.cos(th), y1 + h / 2 + h / 2 * np.sin(th)], 1)
            for kx, ky in kps:
                circle(img, (int(kx), int(ky)), 4, (0, 0, 255))
            row = [cls, (x1 + w / 2) / imgsz, (y1 + h / 2) / imgsz, w / imgsz, h / imgsz]
            for kx, ky in kps:
                row += [kx / imgsz, ky / imgsz] + ([2] if ndim == 3 else [])
            labels.append(" ".join(f"{v:.6f}" if isinstance(v, float) else str(v) for v in row))
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        imwrite(root / "images" / split / f"{i:05d}.jpg", img)
        (root / "labels" / split / f"{i:05d}.txt").write_text("\n".join(labels))


def _gen_shapes_obb(root: Path, split: str, n: int, imgsz: int, seed: int, nc: int = 2) -> None:
    """n JPEGs of imgsz x imgsz: the shapes kind's noise and 1-4 filled
    rotated rectangles (an even class a box of sides 0.08-0.2 of the image,
    an odd one a bar 0.2-0.35 long and 0.03-0.08 wide), each at an angle
    drawn in [0, 180) degrees, with their label rows, cls and the four
    normalised corners (JAX :178-203, the same draws)."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        base = rng.integers(40, 160, (imgsz // 8, imgsz // 8, 3), dtype=np.uint8)
        img = resize_linear_u8(torch.from_numpy(base)[None], imgsz, imgsz)[0].numpy().copy()
        lines = []
        for _ in range(int(rng.integers(1, 5))):
            cls = int(rng.integers(0, nc))
            cx, cy = rng.uniform(0.2, 0.8, 2) * imgsz
            if cls % 2 == 0:
                w, h = rng.uniform(0.08, 0.2, 2) * imgsz
            else:
                w, h = rng.uniform(0.2, 0.35) * imgsz, rng.uniform(0.03, 0.08) * imgsz
            ang = rng.uniform(0, 180)
            pts = box_points(((cx, cy), (w, h), ang))
            if pts.min() < 0 or pts.max() > imgsz - 1:
                continue
            color = tuple(int(c) for c in rng.integers(100, 255, 3))
            fill_poly(img, pts.astype(np.int32), color)
            lines.append(f"{cls} " + " ".join(f"{v:.6f}" for v in (pts / imgsz).reshape(-1)))
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        imwrite(root / "images" / split / f"{i:05d}.jpg", img)
        (root / "labels" / split / f"{i:05d}.txt").write_text("\n".join(lines))


def _gen_spectrogram(root: Path, split: str, n: int, imgsz: int, seed: int) -> None:
    """n images of imgsz x imgsz (imgsz STFT time frames, 256 frequency bins
    resized to imgsz rows) as gray PNG under root/images/split and their YOLO
    labels (cls cx cy w h, time along x, frequency along y) under
    root/labels/split."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, events = synth_frame(rng, imgsz, imgsz)
        _write_sample(root, split, i, img, [(c, (t0 + t1) / 2, (f0 + f1) / 2, t1 - t0, f1 - f0)
                                            for c, t0, t1, f0, f1 in events], ".png")


def gen_cls_shapes(root: Path, split: str, n_per_class: int, imgsz: int = 160, seed: int = 0, names=None) -> None:
    """n_per_class JPEGs of imgsz x imgsz per class under root/split/<name>/
    (JAX :263, the same draws): `names` the class folders ("/" written as
    "-"), by default the 3-shape schema rectangle, circle, triangle."""
    rng = np.random.default_rng(seed)
    for ci, name in enumerate(names if names is not None else ("rectangle", "circle", "triangle")):
        d = Path(root) / split / str(name).replace("/", "-")
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n_per_class):
            base = rng.integers(40, 160, (imgsz // 8, imgsz // 8, 3), dtype=np.uint8)
            img = resize_linear_u8(torch.from_numpy(base)[None], imgsz, imgsz)[0].numpy().copy()
            color = tuple(int(c) for c in rng.integers(120, 255, 3))
            cx, cy = (int(v) for v in (rng.uniform(0.3, 0.7, 2) * imgsz).astype(int))
            r = int(rng.uniform(0.15, 0.3) * imgsz)
            if ci % 3 == 0:
                rectangle(img, (cx - r, cy - r), (cx + r, cy + r), color, -1)
            elif ci % 3 == 1:
                circle(img, (cx, cy), r, color)
            else:
                fill_poly(img, [(cx, cy - r), (cx - r, cy + r), (cx + r, cy + r)], color)
            imwrite(d / f"{i:05d}.jpg", img)
