"""AutoBackend: one forward() over the model sources the port serves.
Counterpart of spectrogram_yolov11_tpu/nn/autobackend.py for two kinds:

  .ckpt          the JAX package's checkpoints: loaded by
                 engine/pipeline.py:load_model (BN folded), moved to `device`
                 by eval_network (channels_last on the card; with half=True
                 its bf16 copy), run by engine/exporter.py:build_inference_fn
  http(s)://     a KServe-v2 server (serve.py:RemoteModel), ours or any other

forward(uint8 (B, H, W, 3) RGB frames, numpy or tensor) -> the decoded
predictions (B, A, 4 + nc) f32: a tensor on `device` for a checkpoint, a
numpy array for a server. YAML models, reference .pt files and exported
artifacts raise NotImplementedError naming the ROADMAP.md item that ports
them; grpc:// raises as the JAX client does.

SYT_WIRE_ENCODE=png sends each frame to a server as PNG bytes (the BYTES
ingest, serve.py:encode_images) instead of the raw tensor; `jpg` raises (the
port has no JPEG encoder). Only a uint8 channels-last batch is encoded: any
other input is sent raw, with a warning.
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
        if self.kind == "ckpt":
            from ..engine.exporter import build_inference_fn
            from ..engine.pipeline import eval_network, load_model

            self.device = resolve_device(device)
            model, meta = load_model(self.weights)
            names = meta.get("names") or {i: f"{i}" for i in range(model.nc)}
            self.names = {int(k): str(v) for k, v in names.items()}
            self.model = eval_network(model, half, self.device)
            self.stride = np.asarray(model.stride, np.float32)
            self.nc = model.nc
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
        elif self.kind == "yaml":
            raise not_ported(f"building a model from YAML ({self.weights})", "item 8 (trainer loop: from-scratch init)")
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
                outs = self._remote(encode_images(a, fmt=f".{self._wire.partition(':')[0].lstrip('.')}"))
                return outs[0] if len(outs) == 1 else tuple(outs)
            warnings.warn(f"SYT_WIRE_ENCODE={self._wire}: the batch is {a.dtype} {a.shape}, not uint8 (B, H, W, 1|3); "
                          "sending it raw")
        outs = self._remote(a)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def forward(self, imgs_u8):
        """Decoded predictions of uint8 RGB frames (numpy or tensor)."""
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
