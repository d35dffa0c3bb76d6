"""AutoBackend: one forward() over the model sources the port serves.
Counterpart of spectrogram_yolov11_tpu/nn/autobackend.py for three kinds:

  .ckpt          the JAX package's checkpoints: loaded by
                 engine/pipeline.py:load_model (BN folded), moved to `device`
                 by eval_network (channels_last on the card; with half=True
                 its bf16 copy), run by engine/exporter.py:build_inference_fn
  .yaml          a model YAML (a path, a packaged name, or a bare name such
                 as yolo11n, the default kind): the architecture with fresh
                 weights from seed 0, as JAX's YOLO(yaml) (:7, :56), run as a
                 checkpoint is
  http(s)://     a KServe-v2 server (serve.py:RemoteModel), ours or any other

A checkpoint or YAML of any of the five tasks (detect, segment, pose, obb,
classify) is taken; `task` is its model's, `kpt_shape` a pose model's; a
server's come from its metadata.

forward(uint8 (B, H, W, 3) RGB frames, numpy or tensor) -> the task's
outputs of engine/exporter.py:build_inference_fn at nms=False (the detect
task's decoded predictions (B, A, 4 + nc) f32; a segment model's pair):
tensors on `device` for a checkpoint, numpy arrays for a server. Reference
.pt files and exported artifacts raise NotImplementedError naming the
ROADMAP.md item that ports them; grpc:// raises as the JAX client does.

SYT_WIRE_ENCODE=jpg[:q] or png sends each frame to a server as JPEG (at
quality q, 90 unless given, as JAX's client) or PNG bytes (the BYTES ingest,
serve.py:encode_images) instead of the raw tensor. Only a uint8
channels-last batch is encoded: any other input is sent raw, with a warning.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np
import torch

from ..utils import not_ported, resolve_device


def _model_type(path: str) -> str:
    """The source's kind from its path, as spectrogram_yolov11_tpu/nn/autobackend.py:48 sniffs it."""
    s = str(path)
    if s.startswith(("http://", "https://", "grpc://")):
        return "remote"
    for kind in ("ckpt", "pt", "stablehlo", "tflite", "onnx"):
        if s.endswith("." + kind):
            return kind
    if s.endswith((".yaml", ".yml")):
        return "yaml"
    if s.endswith("_saved_model") or (Path(s).is_dir() and (Path(s) / "saved_model.pb").exists()):
        return "saved_model"
    return "yaml"


def _wire_batch(x) -> np.ndarray:
    """A batch as the host array the wire carries."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class AutoBackend:
    """AutoBackend(weights, half=False, device="cuda"): a checkpoint on
    `device` (the card unless the caller passes "cpu"; raises without one), or
    the client of a served model (no device: the server holds the network)."""

    def __init__(self, weights: str | Path = "yolo11n.yaml", half: bool = False, device: str | torch.device = "cuda"):
        self.kind = _model_type(weights)
        self.weights = str(weights)
        self.model = None
        self.device = None
        self.names: dict = {}
        self.stride = np.array([8.0, 16.0, 32.0])
        self.task = "detect"
        if self.kind in ("ckpt", "yaml"):
            from ..engine.exporter import build_inference_fn
            from ..engine.pipeline import eval_network, load_model
            from .tasks import build_model

            self.device = resolve_device(device)
            if self.kind == "ckpt":
                model, meta = load_model(self.weights)
            else:
                model, meta = build_model(self.weights).init(0), {}
            names = meta.get("names") or {i: f"{i}" for i in range(model.nc)}
            self.names = {int(k): str(v) for k, v in names.items()}
            self.model = eval_network(model, half, self.device)
            self.stride = np.asarray(model.stride, np.float32)
            self.nc = model.nc
            self.task = model.task
            if model.task == "pose":
                self.kpt_shape = tuple(model.kpt_shape)
            self._fn = build_inference_fn(self.model, nms=False)
        elif self.kind == "remote":
            from ..serve import RemoteModel

            self._remote = RemoteModel(self.weights)
            md = self._remote.metadata or {}
            self.task = str(md.get("task") or "detect")
            self.names = {int(k): str(v) for k, v in (md.get("names") or {}).items()}
            if md.get("stride"):
                self.stride = np.asarray(md["stride"], np.float32)
            if md.get("kpt_shape"):
                self.kpt_shape = tuple(int(x) for x in md["kpt_shape"])
            self._wire = os.environ.get("SYT_WIRE_ENCODE", "")
        elif self.kind == "pt":
            raise not_ported(f"reference .pt import ({self.weights})", "item 11 (other model families)")
        else:
            raise not_ported(f"the {self.kind} artifact {self.weights!r}",
                             "item 9 (the Exporter and the artifact kinds)")

    def _remote_forward(self, x):
        from ..serve import encode_images

        a = _wire_batch(x)
        if self._wire:
            if a.dtype == np.uint8 and a.ndim == 4 and a.shape[-1] in (1, 3):
                fmt, _, q = self._wire.partition(":")
                outs = self._remote(encode_images(a, fmt=f".{fmt.lstrip('.')}", quality=int(q or 90)))
                return outs[0] if len(outs) == 1 else tuple(outs)
            warnings.warn(f"SYT_WIRE_ENCODE={self._wire}: the batch is {a.dtype} {a.shape}, not uint8 (B, H, W, 1|3); "
                          "sending it raw")
        outs = self._remote(a)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def forward(self, imgs_u8):
        """The serving graph's outputs for uint8 RGB frames (numpy or tensor)."""
        if self.kind == "remote":
            return self._remote_forward(imgs_u8)
        x = torch.as_tensor(np.ascontiguousarray(imgs_u8)) if not torch.is_tensor(imgs_u8) else imgs_u8
        with torch.inference_mode():
            return self._fn(x.to(self.device))

    __call__ = forward

    def warmup(self, imgsz=(1, 640, 640, 3)) -> "AutoBackend":
        """One forward of a zero batch (kernel builds, cuDNN's algorithm choice)."""
        self.forward(np.zeros(imgsz, np.uint8))
        return self
