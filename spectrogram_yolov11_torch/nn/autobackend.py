"""AutoBackend: one forward() over the model sources and artifacts the port
reads. Counterpart of spectrogram_yolov11_tpu/nn/autobackend.py:

  .ckpt          the JAX package's checkpoints: loaded by
                 engine/pipeline.py:load_model (BN folded), moved to `device`
                 by eval_network (channels_last on the card; with half=True
                 its bf16 copy), run by engine/exporter.py:build_inference_fn
  .yaml          a model YAML (a path, a packaged name, or a bare name such
                 as yolo11n, the default kind): the architecture with fresh
                 weights from seed 0, as JAX's YOLO(yaml) (:7, :56), run as a
                 checkpoint is
  .stablehlo     an artifact of JAX's Exporter: as JAX's (:75-84), its
                 sidecar <stem>.ckpt is loaded and run as a checkpoint (the
                 MLIR is for native runtimes); FileNotFoundError without it
  .pt2           the port's Exporter's graph artifact, a torch.export program
                 (engine/exporter.py): loaded by torch.export.load (the
                 kernels' operators registered first), moved to `device` if
                 it was exported on another, and run as it is; the task,
                 names, stride, nc and kpt_shape come from its sidecar
                 <stem>.ckpt (FileNotFoundError without it). The program
                 runs inside utils.full_f32, as the eager graph: the TF32
                 settings are process state that it does not hold. Its dtype is the
                 export's (half=True gives a bf16 program); a `half` that
                 disagrees raises ValueError (JAX re-jits its sidecar in
                 bf16 instead; ROADMAP.md §3.51)
  _saved_model, .tflite, .onnx
                 the TensorFlow and ONNX kinds, gated on their imports as
                 JAX's (:107-186), with its output ordering (_order_outs) and
                 metadata sidecar (_load_metadata)
  http(s)://     a KServe-v2 server (serve.py:RemoteModel), ours or any other

A source of any of the five tasks (detect, segment, pose, obb, classify) is
taken; `task` is its model's, `kpt_shape` a pose model's; a server's come
from its metadata.

forward(uint8 (B, H, W, 3) RGB frames, numpy or tensor) -> the outputs of
engine/exporter.py:build_inference_fn: at nms=False for a checkpoint (the
detect task's decoded predictions (B, A, 4 + nc) f32; a segment model's
pair), at the export's settings for a .pt2 (`nms` says which): tensors on
`device` for a checkpoint or a program, numpy arrays for a server or the
TensorFlow kinds. Reference .pt files raise NotImplementedError naming the
ROADMAP.md item that ports them; grpc:// raises as the JAX client does.

SYT_WIRE_ENCODE=jpg[:q] or png sends each frame to a server as JPEG (at
quality q, 90 unless given, as JAX's client) or PNG bytes (the BYTES ingest,
serve.py:encode_images) instead of the raw tensor. Only a uint8
channels-last batch is encoded: any other input is sent raw, with a warning.
"""

from __future__ import annotations

import json
import os
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..utils import full_f32, not_ported, resolve_device


def _order_outs(outs):
    """A TensorFlow or ONNX artifact's outputs (JAX :24): one output -> the
    array; several -> a tuple with the rank-3 decoded predictions first
    (the exporter's nms=False layout), since their converters do not keep
    the signature's output order."""
    if len(outs) == 1:
        return np.asarray(outs[0])
    return tuple(np.asarray(o) for o in sorted(outs, key=lambda r: np.asarray(r).ndim != 3))


def _load_metadata(path: str | Path) -> dict:
    """The Exporter's metadata sidecar of a TensorFlow or ONNX artifact (JAX
    :35): metadata.yaml inside a saved_model directory, <stem>.metadata.yaml
    beside a .tflite or .onnx file; {} when there is none."""
    from ..utils import yaml_load

    p = Path(path)
    cand = p / "metadata.yaml" if p.is_dir() else p.with_suffix(".metadata.yaml")
    return yaml_load(cand) if cand.exists() else {}


def _model_type(path: str) -> str:
    """The source's kind from its path, as spectrogram_yolov11_tpu/nn/autobackend.py:48 sniffs it."""
    s = str(path)
    if s.startswith(("http://", "https://", "grpc://")):
        return "remote"
    for kind in ("ckpt", "pt", "pt2", "stablehlo", "tflite", "onnx"):
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
    """AutoBackend(weights, half=False, device="cuda"): a checkpoint, YAML or
    graph artifact on `device` (the card unless the caller passes "cpu";
    raises without one), or the client of a served model or a TensorFlow or
    ONNX artifact (no device: the server or the runtime holds the network)."""

    def __init__(self, weights: str | Path = "yolo11n.yaml", half: Optional[bool] = False,
                 device: str | torch.device = "cuda"):
        self.kind = _model_type(weights)
        self.weights = str(weights)
        self.model = None
        self.device = None
        self.names: dict = {}
        self.stride = np.array([8.0, 16.0, 32.0])
        self.task = "detect"
        self.nms = False  # whether forward gives the graph's NMS rows (a .pt2 exported with nms=True)
        if self.kind in ("ckpt", "yaml", "stablehlo"):
            from ..engine.exporter import build_inference_fn
            from ..engine.pipeline import eval_network

            self.device = resolve_device(device)
            model, meta = self._host_model()
            self.model = eval_network(model, bool(half), self.device)
            self._describe(model, meta)
            self._fn = build_inference_fn(self.model, nms=False)
        elif self.kind == "pt2":
            self.device = resolve_device(device)
            self._load_program(half)
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
            self._fn = self._load_runtime()
            md = _load_metadata(self.weights)
            self.task = str(md.get("task", self.task))
            if md.get("names"):
                self.names = {int(k): str(v) for k, v in md["names"].items()}
            if md.get("stride"):
                self.stride = np.asarray(md["stride"], np.float32)
            if md.get("nc") is not None:
                self.nc = int(md["nc"])
            if md.get("kpt_shape"):
                self.kpt_shape = tuple(int(x) for x in md["kpt_shape"])

    def _host_model(self):
        """The model (on the host) and the metadata of a checkpoint, a YAML, or
        an artifact's sidecar .ckpt (JAX :75-84)."""
        from ..engine.pipeline import load_model
        from .tasks import build_model

        src = Path(self.weights)
        if self.kind in ("stablehlo", "pt2"):
            src = src.with_suffix(".ckpt")
            if not src.exists():
                raise FileNotFoundError(f"{self.kind} sidecar checkpoint missing: {src}")
        if self.kind == "yaml":
            return build_model(str(src)).init(0), {}
        return load_model(src)

    def _describe(self, model, meta: dict) -> None:
        """names, stride, nc, task and a pose model's kpt_shape from `model` and its checkpoint's metadata."""
        names = meta.get("names") or {i: f"{i}" for i in range(model.nc)}
        self.names = {int(k): str(v) for k, v in names.items()}
        self.stride = np.asarray(model.stride, np.float32)
        self.nc = model.nc
        self.task = model.task
        if model.task == "pose":
            self.kpt_shape = tuple(model.kpt_shape)

    def _load_program(self, half: Optional[bool]) -> None:
        """A .pt2 of the port's Exporter on self.device (engine/exporter.py);
        half=None takes the program's dtype."""
        # the operators the program calls must be registered before it loads
        from ..engine.exporter import PROGRAM_META
        from ..ops import fused_conv, nms_kernel  # noqa: F401

        model, meta = self._host_model()
        self._describe(model, meta)
        extra = {PROGRAM_META: ""}
        ep = torch.export.load(self.weights, extra_files=extra)
        export = json.loads(extra[PROGRAM_META] or "{}")
        leaves = [*ep.state_dict.values(), *ep.constants.values()]
        self.half = any(t.dtype == torch.bfloat16 for t in leaves)
        if half is not None and bool(half) != self.half:
            raise ValueError(f"{self.weights} was exported with half={self.half}; load it with half={self.half}, "
                             f"or export again with half={bool(half)}")
        if any(t.device != self.device for t in leaves):
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, self.device)
        self.nms = bool(export.get("nms", False))
        self.export_args = export
        self.program = ep
        module = ep.module()

        def run(x):
            with full_f32():  # as build_inference_fn runs the eager graph, bf16 or f32
                return module(x)

        self._fn = run

    def _load_runtime(self):
        """forward of a TensorFlow or ONNX artifact, through its runtime (JAX :107-186); a missing
        artifact raises FileNotFoundError before the runtime is imported."""
        if not Path(self.weights).exists():
            raise FileNotFoundError(f"{self.kind} artifact not found: {self.weights}")
        if self.kind == "saved_model":
            import tensorflow as tf

            sm = tf.saved_model.load(self.weights)

            def run_sm(x):
                out = sm.f(np.asarray(x))
                return _order_outs([np.asarray(o) for o in (out if isinstance(out, (tuple, list)) else [out])])

            return run_sm
        if self.kind == "tflite":
            import tensorflow as tf

            interp = tf.lite.Interpreter(model_path=self.weights)
            interp.allocate_tensors()

            def run_tflite(x):
                interp.set_tensor(interp.get_input_details()[0]["index"], np.asarray(x))
                interp.invoke()
                return _order_outs([interp.get_tensor(o["index"]) for o in interp.get_output_details()])

            return run_tflite
        if self.kind == "onnx":
            import onnxruntime as ort

            sess = ort.InferenceSession(self.weights)
            name = sess.get_inputs()[0].name
            return lambda x: _order_outs(sess.run(None, {name: np.asarray(x)}))
        raise ValueError(f"unsupported weights: {self.weights}")

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
        """The serving graph's outputs for uint8 RGB frames (numpy or tensor);
        a gray (B, H, W, 1) batch is broadcast to 3 channels, as the server
        broadcasts it."""
        if self.kind == "remote":
            return self._remote_forward(imgs_u8)
        if self.device is None:  # a TensorFlow or ONNX runtime
            return self._fn(_wire_batch(imgs_u8))
        x = torch.as_tensor(np.ascontiguousarray(imgs_u8)) if not torch.is_tensor(imgs_u8) else imgs_u8
        with torch.inference_mode():
            return self._fn(x.to(self.device).expand(-1, -1, -1, 3))

    __call__ = forward

    def warmup(self, imgsz=(1, 640, 640, 3)) -> "AutoBackend":
        """One forward of a zero batch (kernel builds, cuDNN's algorithm choice)."""
        self.forward(np.zeros(imgsz, np.uint8))
        return self
