"""Seeded synthetic LTE/RF spectrograms: frames, and the `spectrogram_synth` dataset.

A copy of spectrogram_yolov11_tpu/data/synth.py:207 _synth_iq (numpy only);
a frame maker that resizes the (F, T) spectrogram as the JAX package's
cv2.resize(INTER_LINEAR) (:252) does, through data/augment.py's
resize_linear_u8; and `maybe_generate` (JAX :25) with `_gen_spectrogram` (JAX
:243), which write the synthetic split as PNG through data/imageio.py where
the JAX package writes JPEG through cv2. The rng stream is JAX's, so the
labels are equal, and a frame equals the JAX package's pre-JPEG frame
(tests/test_torch_dataset.py).
"""

from __future__ import annotations

from pathlib import Path
import numpy as np
import torch

from ..ops.stft import spectrogram_numpy
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
    Only the `spectrogram` kind is ported; the shapes kinds raise."""
    kind = data.get("synthetic")
    if not kind:
        return False
    if kind != "spectrogram":
        raise NotImplementedError(f"synthetic dataset kind {kind!r} is not ported yet: queued in ROADMAP.md §1 "
                                  f"item 7 (training data)")
    n_train, n_val = int(data.get("n_train", 64)), int(data.get("n_val", 16))
    imgsz, seed = int(data.get("gen_imgsz", 640)), int(data.get("seed", 0))
    vals = data["val"] if isinstance(data["val"], list) else [data["val"]]
    if Path(vals[0]).exists():
        return True
    trains = data["train"] if isinstance(data["train"], list) else [data["train"]]
    jobs = [(d, n_train, seed + j) for j, d in enumerate(trains)] + [(d, n_val, seed + 10_000) for d in vals]
    for d, n, s in jobs:  # <root>/images/<split> -> <root>/labels/<split>
        _gen_spectrogram(Path(d).parent.parent, Path(d).name, n, imgsz, s)
    return True


def _gen_spectrogram(root: Path, split: str, n: int, imgsz: int, seed: int) -> None:
    """n images of imgsz x imgsz (imgsz STFT time frames, 256 frequency bins
    resized to imgsz rows) as gray PNG under root/images/split and their YOLO
    labels (cls cx cy w h, time along x, frequency along y) under
    root/labels/split."""
    rng = np.random.default_rng(seed)
    (root / "images" / split).mkdir(parents=True, exist_ok=True)
    (root / "labels" / split).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img, events = synth_frame(rng, imgsz, imgsz)
        imwrite(root / "images" / split / f"{i:05d}.png", img)
        lines = [f"{c} {(t0 + t1) / 2:.6f} {(f0 + f1) / 2:.6f} {t1 - t0:.6f} {f1 - f0:.6f}"
                 for c, t0, t1, f0, f1 in events]
        (root / "labels" / split / f"{i:05d}.txt").write_text("\n".join(lines))
