"""IQ -> spectrogram front end (torch). Counterpart of
spectrogram_yolov11_tpu/ops/stft.py: frame_signal (:26), _dft_matrices (:37),
iq_to_spectrogram (:44) with its device half _iq_to_spectrogram_jit (:61),
_viridis (:116) and spectrogram_numpy (:127).

    frame -> symmetric Hann window -> DFT as two real matmuls -> log10 power
    -> roll by n_fft // 2 on the frequency axis -> (B, F, T) -> per-capture
    min/max normalise -> resize -> gray x3 or viridis

Details that decide agreement with the JAX version:
  * the window is numpy's symmetric Hann (`torch.hann_window` defaults to the
    periodic one);
  * the DFT products, the log power, the normalisation and the resize run in
    float64 on the f32 frames, window, DFT matrices and resize weights JAX
    uses; the image is f32 from there on. In f32 the sums of a noise-floor
    null are mostly rounding, and the per-capture minimum that normalises
    every pixel is such a null: an f32 evaluation (XLA's, or torch's on the
    CPU) lands 5.7e-5 to 5.9e-4 of the image away from the exact function,
    and its uint8 frames differ from the exact ones by a grey level at up to
    7.1 % of pixels (tests/test_torch_stft.py, run as a script, prints the
    readings). In float64 the card and the CPU give the same frames, within
    3e-8 of the exact function; no product is open to TF32;
  * `jax.image.resize(..., "linear")` antialiases when it downsamples. The
    resize here is the same computation: per axis a weight matrix built as
    `jax.image.scale_and_translate` builds it (triangle kernel, support scaled
    by the downsampling factor, rows normalised, samples outside the input
    zeroed), applied as a matmul; axes whose size does not change are skipped.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import resolve_device


def frame_signal(iq: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, N) -> (B, frames, n_fft) overlapping frames: a reshape when hop ==
    n_fft, a gather otherwise."""
    b, n = iq.shape
    frames = 1 + (n - n_fft) // hop
    if hop == n_fft:
        return iq[:, : frames * n_fft].reshape(b, frames, n_fft)
    idx = torch.arange(frames, device=iq.device)[:, None] * hop + torch.arange(n_fft, device=iq.device)[None, :]
    return iq[:, idx]


def _dft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT matrices W[j, k] = exp(-2*pi*i*j*k/N), float32."""
    jk = np.outer(np.arange(n_fft), np.arange(n_fft)).astype(np.float64)
    ang = -2.0 * np.pi * jk / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _stft_constants(n_fft: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(symmetric Hann window f32, DFT real and imaginary matrices as float64) on the device."""
    win = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(device)  # as jnp.hanning, not torch's periodic one
    w_re, w_im = (torch.from_numpy(m).to(device, torch.float64) for m in _dft_matrices(n_fft))
    return win, w_re, w_im


@functools.lru_cache(maxsize=16)
def resize_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """(in_size, out_size) weights of jax.image.resize's "linear" method along
    one axis (jax/_src/image/scale.py compute_weight_mat, antialias on,
    translation 0), computed in its operation order and dtype (f32), held as
    float64."""
    f32 = np.float32
    inv_scale = f32(in_size / out_size)  # 1. / scale, rounded to f32
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(1.0) - x, f32(0.0))  # triangle kernel
    total = weights.sum(0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps, weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.from_numpy(np.where(inside[None, :], weights, f32(0.0)).astype(np.float64)).to(device)


def resize_linear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) float64 -> (B, out_h, out_w), as jax.image.resize(img, (B, *out_hw), "linear")."""
    _, h, w = img.shape
    if out_hw[0] != h:
        img = torch.einsum("bhw,ho->bow", img, resize_weights(h, out_hw[0], img.device))
    if out_hw[1] != w:
        img = img @ resize_weights(w, out_hw[1], img.device)
    return img


def spectrogram_gray(iq: torch.Tensor, n_fft: int = 512, hop: int = 256,
                     out_hw: Optional[Tuple[int, int]] = (640, 640), eps: float = 1e-10) -> torch.Tensor:
    """(B, N, 2) float IQ on its device -> (B, H, W) f32 in [0, 1]: rows are
    frequency (fftshifted, low to high), columns time frames."""
    re_sig, im_sig = iq[..., 0].float(), iq[..., 1].float()
    fr = frame_signal(re_sig, n_fft, hop)  # (B, T, N)
    fi = frame_signal(im_sig, n_fft, hop)
    win, w_re, w_im = _stft_constants(n_fft, iq.device)
    fr = (fr * win).double()
    fi = (fi * win).double()
    spec_re = fr @ w_re - fi @ w_im
    spec_im = fr @ w_im + fi @ w_re
    power = torch.log10(spec_re**2 + spec_im**2 + eps)  # (B, T, F)
    power = torch.roll(power, n_fft // 2, dims=-1)  # fftshift, on the frequency axis before the transpose
    img = power.transpose(1, 2)  # (B, F, T)
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    img = (img - lo) / (hi - lo + 1e-6)
    return (img if out_hw is None else resize_linear(img, out_hw)).float()


def iq_to_spectrogram(
    iq,  # (B, N) complex or (B, N, 2) float: numpy or a tensor
    n_fft: int = 512,
    hop: int = 256,
    out_hw: Optional[Tuple[int, int]] = (640, 640),
    colormap: bool = False,
    eps: float = 1e-10,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Raw IQ -> (B, H, W, 3) float32 image in [0, 1]. Complex input is split
    to (B, N, 2) float32 on the host; a tensor stays on its device, anything
    else goes to `device` (the card unless the caller passes "cpu")."""
    if getattr(iq, "ndim", 0) == 2 and (torch.is_complex(iq) if torch.is_tensor(iq) else np.iscomplexobj(iq)):
        iq = iq.cpu().numpy() if torch.is_tensor(iq) else iq
        iq = np.stack([np.real(iq), np.imag(iq)], axis=-1).astype(np.float32)
    if torch.is_tensor(iq):
        x = iq.real if torch.is_complex(iq) else iq
    else:
        arr = np.asarray(iq)
        x = torch.from_numpy(np.ascontiguousarray(np.real(arr) if np.iscomplexobj(arr) else arr)).to(resolve_device(device))
    img = spectrogram_gray(x, n_fft, hop, out_hw, eps)
    rgb = _viridis(img) if colormap else img[..., None].expand(*img.shape, 3)
    return rgb.float().contiguous()


# 16-stop viridis control points; linear interpolation between them
_VIRIDIS = np.array(
    [
        [0.267, 0.005, 0.329], [0.283, 0.100, 0.422], [0.277, 0.185, 0.490], [0.254, 0.265, 0.530],
        [0.222, 0.339, 0.549], [0.191, 0.407, 0.556], [0.164, 0.471, 0.558], [0.139, 0.534, 0.555],
        [0.121, 0.596, 0.544], [0.135, 0.659, 0.518], [0.208, 0.719, 0.473], [0.328, 0.774, 0.407],
        [0.478, 0.821, 0.318], [0.647, 0.858, 0.210], [0.825, 0.885, 0.106], [0.993, 0.906, 0.144],
    ],
    np.float32,
)


def _viridis(x: torch.Tensor) -> torch.Tensor:
    """Map a [0, 1] scalar field to RGB by piecewise-linear viridis."""
    stops = torch.from_numpy(_VIRIDIS).to(x.device)
    n = stops.shape[0] - 1
    xi = x.clamp(0.0, 1.0) * n
    lo = torch.floor(xi).long()
    hi = (lo + 1).clamp(0, n)
    t = (xi - lo)[..., None]
    return stops[lo] * (1 - t) + stops[hi] * t


def spectrogram_numpy(iq: np.ndarray, n_fft: int = 512, hop: int = 256) -> np.ndarray:
    """Host mirror of the pipeline in numpy: (N,) complex -> (F, T) log power,
    fftshifted, min-max to [0, 1]."""
    frames = 1 + (len(iq) - n_fft) // hop
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    win = np.hanning(n_fft).astype(np.float32)
    power = np.log10(np.abs(np.fft.fft(iq[idx] * win, axis=-1)) ** 2 + 1e-10)
    img = np.fft.fftshift(power, axes=-1).T
    img = (img - img.min()) / (img.max() - img.min() + 1e-6)
    return img.astype(np.float32)
