"""Inference sources. Counterpart of spectrogram_yolov11_tpu/data/loaders.py:
LoadImagesAndVideos (:23), LoadPilAndNumpy (:63), LoadIQCaptures (:79),
load_inference_source (:99) and LoadTensor (:251), with the same routing.
Each loader yields (path, frame, info); a frame is uint8 HWC BGR, host numpy,
or for an IQ capture a tensor on the card.

Image files, directories and globs are listed as the JAX package lists them
and read by data/imageio.py (JPEG and PNG, as cv2.imread reads them). Videos,
streams and screenshots need a video decoder or a capture device (cv2 in the
JAX package), which the port does not have: those sources raise
NotImplementedError (ROADMAP.md §1 item 5), a listing that holds a video
before any frame is read.
"""

from __future__ import annotations

import glob
from pathlib import Path

import numpy as np
import torch

from ..ops.stft import spectrogram_gray
from ..utils import resolve_device
from .dataset import IMG_FORMATS
from .imageio import imread

VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv", "webm"}
_NO_DECODER = ("needs a video decoder or a capture device (cv2 in the JAX package), which the port does not have; "
               "queued in ROADMAP.md §1 item 5. Pass image files, directories or globs (JPEG, PNG), .npy IQ "
               "captures or uint8 arrays")


class LoadImagesAndVideos:
    """(path, BGR image, "") for each image file of a file, a directory
    (sorted rglob of IMG_FORMATS and VID_FORMATS) or a glob (sorted, recursive);
    a missing source raises FileNotFoundError, a video in the listing
    NotImplementedError, an image no decoder takes FileNotFoundError as in
    the JAX package (cv2.imread's None)."""

    def __init__(self, source: str | Path):
        p = str(source)
        if "*" in p:
            files = sorted(glob.glob(p, recursive=True))
        elif Path(p).is_dir():
            files = sorted(str(f) for f in Path(p).rglob("*") if f.suffix[1:].lower() in IMG_FORMATS | VID_FORMATS)
        elif Path(p).is_file():
            files = [p]
        else:
            raise FileNotFoundError(f"source not found: {source}")
        videos = [f for f in files if Path(f).suffix[1:].lower() in VID_FORMATS]
        if videos:
            raise NotImplementedError(f"video source {videos[0]!r} {_NO_DECODER}")
        self.files = files

    def __iter__(self):
        for f in self.files:
            try:
                img = imread(f)
            except ValueError as e:
                raise FileNotFoundError(f"unreadable image: {f} ({e})") from e
            yield f, img, ""


class LoadPilAndNumpy:
    """In-memory sources: numpy arrays (BGR HWC) or PIL images (RGB -> BGR)."""

    def __init__(self, source):
        self.items = source if isinstance(source, (list, tuple)) else [source]

    def __iter__(self):
        for i, item in enumerate(self.items):
            arr = np.asarray(item.convert("RGB"))[..., ::-1] if hasattr(item, "mode") else np.asarray(item)
            yield f"image{i}", np.ascontiguousarray(arr), ""


class LoadIQCaptures:
    """IQ .npy captures -> uint8 spectrogram frames on the device. Always
    n_fft 256, hop 128 and a 640 x 640 frame, whatever predict's imgsz.

    The frame is the JAX loader's (img[..., ::-1] * 255).astype(uint8), a
    truncation; its three channels are equal, so it stays on the device as one
    plane broadcast to (640, 640, 3)."""

    def __init__(self, source: str | Path, n_fft: int = 256, hop: int = 128, imgsz: int = 640,
                 device: str | torch.device = "cuda"):
        p = Path(source)
        self.files = sorted(str(f) for f in ([p] if p.is_file() else p.rglob("*.npy")))
        self.n_fft, self.hop, self.imgsz = n_fft, hop, imgsz
        self.device = resolve_device(device)

    def __iter__(self):
        for f in self.files:
            iq = np.load(f)[None].astype(np.complex64)
            x = np.stack([iq.real, iq.imag], axis=-1) if iq.ndim == 2 else iq.real  # (1, N, 2) float32
            yield f, iq_frame(torch.from_numpy(np.ascontiguousarray(x)).to(self.device), self.n_fft, self.hop,
                              self.imgsz)[0], "iq capture"


def iq_frame(iq: torch.Tensor, n_fft: int = 256, hop: int = 128, imgsz: int = 640) -> torch.Tensor:
    """(B, N, 2) float32 IQ on its device -> (B, imgsz, imgsz, 3) uint8 frames
    there, the gray plane broadcast over the channels."""
    u8 = (spectrogram_gray(iq, n_fft, hop, (imgsz, imgsz)) * 255).to(torch.uint8)  # truncates, as numpy's astype
    return u8[..., None].expand(*u8.shape, 3)


class LoadTensor:
    """(B, 3, H, W) or (3, H, W) RGB CHW arrays or tensors, in [0, 1] or uint8
    -> BGR HWC frames on the host."""

    def __init__(self, tensor):
        arr = tensor.detach().cpu().numpy() if torch.is_tensor(tensor) else np.asarray(tensor)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.ndim != 4 or arr.shape[1] != 3:
            raise ValueError(f"LoadTensor expects (B, 3, H, W), got {arr.shape}")
        if arr.dtype != np.uint8:
            if float(arr.max(initial=0.0)) > 1.0 + 1e-3:
                raise ValueError("float tensor values must be normalized to [0, 1]")
            arr = (arr * 255).astype(np.uint8)
        self.imgs = arr

    def __iter__(self):
        for i, im in enumerate(self.imgs):
            yield f"tensor{i}", np.ascontiguousarray(im.transpose(1, 2, 0)[..., ::-1]), ""


def load_inference_source(source, device: str | torch.device = "cuda"):
    """Route a source to its loader, as the JAX package routes it."""
    if isinstance(source, (str, Path)):
        s = str(source)
        if s.endswith(".npy"):
            return LoadIQCaptures(source, device=device)
        if s.startswith("screen"):
            raise NotImplementedError(f"screenshot source {s!r} {_NO_DECODER}")
        if s.isdigit() or s.endswith(".streams") or s.lower().startswith(("rtsp://", "rtmp://", "http://", "https://", "tcp://")):
            raise NotImplementedError(f"stream source {s!r} {_NO_DECODER}")
        return LoadImagesAndVideos(source)
    if isinstance(source, int):
        raise NotImplementedError(f"stream source {source!r} {_NO_DECODER}")
    if isinstance(source, np.ndarray) and source.ndim == 4:
        return LoadTensor(source) if source.shape[1] == 3 and source.shape[-1] != 3 else LoadPilAndNumpy(list(source))
    if isinstance(source, np.ndarray) or hasattr(source, "mode") or isinstance(source, (list, tuple)):
        return LoadPilAndNumpy(source)
    if hasattr(source, "shape") and hasattr(source, "__array__"):  # a CHW tensor
        return LoadTensor(source)
    raise TypeError(f"unsupported source type: {type(source)}")
