"""Seeded synthetic LTE/RF spectrogram frames.

A copy of spectrogram_yolov11_tpu/data/synth.py:207 _synth_iq (numpy only),
and a frame maker in the place of the JAX package's cv2 resize: the (F, T)
spectrogram is resized with F.interpolate(bilinear, align_corners=False).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.stft import spectrogram_numpy


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


def synth_frames(n: int, height: int, width: int, seed: int = 0, n_fft: int = 256, hop: int = 128) -> np.ndarray:
    """(n, height, width, 1) uint8 gray spectrogram frames, one IQ capture each
    with `width` STFT time frames, resized to (height, width) bilinearly."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, height, width, 1), np.uint8)
    for i in range(n):
        iq, _ = synth_iq(rng, n_fft + hop * (width - 1))
        img = torch.from_numpy((spectrogram_numpy(iq, n_fft=n_fft, hop=hop) * 255).astype(np.uint8))
        small = F.interpolate(img[None, None].float(), size=(height, width), mode="bilinear", align_corners=False)
        out[i, ..., 0] = small[0, 0].round().clamp(0, 255).to(torch.uint8).numpy()
    return out
