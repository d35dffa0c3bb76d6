"""The `YOLO` facade for the port. Counterpart of
spectrogram_yolov11_tpu/engine/model.py:40 YOLO for the detect task on the JAX
package's `.ckpt` checkpoints:

    YOLO("runs_artifacts/spectrogram_yolo11n.ckpt").predict("capture.npy")
    YOLO("runs_artifacts/spectrogram_yolo11n.ckpt").val(data="spectrogram_synth.yaml", batch=32)
    YOLO("runs_artifacts/spectrogram_yolo11n.ckpt").train(data="spectrogram_synth.yaml", epochs=3)
    YOLO("http://127.0.0.1:8000/spec").predict(frames)   # a served model (serve.py)

The weights (EMA before the raw variables) are read on the host, carried
across by the weight bridge and folded for the bottleneck kernel; predict
moves the model to its device, the card unless the caller passes
device="cpu", and raises without a card. Predictors are cached on their
sorted overrides, as in the JAX facade, `half` among them: predict(half=True)
runs a bf16 copy of the model and leaves the f32 model to half=False calls.
val builds a DetectionValidator per call (engine/validator.py), kept as
`self.validator`, with the same defaults and callbacks; train runs a
DetectionTrainer (engine/trainer.py), kept as `self.trainer`, and leaves the
EMA's weights on the model, at the compute dtype the trainer set: after an
amp=True run (the default) val() and predict() run the model's bf16 copy
even at half=False, as the JAX facade keeps the model whose dtype its
trainer's setup_model changed in place; a later train(amp=False) sets it
back to f32.
A KServe-v2 URL (http:// or https://) makes an inference-only facade over the
served model, as JAX's _load_remote (:130): predict runs
serve.py:RemotePredictor and val validator.py:BackendValidator, each with its
NMS on the client's device (the card unless device="cpu"); train raises
ValueError; names and stride come from the server's metadata.
Other model sources and modes raise NotImplementedError naming the
ROADMAP.md item that ports them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..utils import not_ported as _not_ported
from ..utils.callbacks import default_callbacks
from .pipeline import load_model
from .predictor import BasePredictor
from .trainer import DetectionTrainer
from .validator import BackendValidator, DetectionValidator


class YOLO:
    """`YOLO('best.ckpt')` on the PyTorch port; `device` sets the default device of predict and val."""

    def __init__(self, model: str | Path = "yolo11n.yaml", task: Optional[str] = None, verbose: bool = False,
                 device: Optional[str] = None):
        self.callbacks = default_callbacks()
        self.model_path = str(model)
        self.ckpt_meta: Dict[str, Any] = {}
        self.overrides: Dict[str, Any] = {} if device is None else {"device": str(device)}
        self.predictor = None
        self._predictor_key = None
        self.validator = None
        self.trainer = None
        self.ckpt_data = None  # the dataset the checkpoint was trained on, val's default
        self.model = None
        self.backend = None  # the AutoBackend of a served model
        if task not in (None, "detect"):
            raise _not_ported(f"task {task!r}", "item 10 (other heads)")
        self.task = "detect"
        if self.model_path.startswith(("http://", "https://", "grpc://")):
            from ..nn.autobackend import AutoBackend

            self.backend = AutoBackend(self.model_path)
            if self.backend.task != "detect":
                raise _not_ported(f"task {self.backend.task!r} of {self.model_path}", "item 10 (other heads)")
            return
        suffix = Path(self.model_path).suffix
        if suffix == ".ckpt":
            self._load_ckpt(self.model_path)
        elif suffix == ".pt":
            raise _not_ported(f"reference .pt import ({self.model_path})", "item 11 (other model families)")
        elif suffix in {".stablehlo", ".tflite", ".onnx"} or (Path(self.model_path) / "saved_model.pb").exists():
            raise _not_ported(f"exported model {self.model_path!r}", "item 9 (the Exporter and the artifact kinds)")
        else:  # .yaml, or a bare name that the JAX facade reads as one
            raise _not_ported(f"building a model from YAML ({self.model_path})", "item 8 (trainer loop: from-scratch init)")

    def _load_ckpt(self, path: str) -> None:
        self.model, meta = load_model(path)
        self.model.names = meta.get("names") or {i: f"{i}" for i in range(self.model.nc)}
        self.ckpt_meta = meta
        self.overrides["model"] = path
        self.ckpt_data = (meta.get("train_args") or {}).get("data") or None

    # -- callbacks ---------------------------------------------------------
    def add_callback(self, event: str, func) -> None:
        """Attach `func` to `event`; it is forwarded to every predictor this model creates."""
        self.callbacks.setdefault(event, []).append(func)

    def clear_callback(self, event: str) -> None:
        self.callbacks[event] = []

    def reset_callbacks(self) -> None:
        self.callbacks = default_callbacks()

    def _merge_callbacks(self, runner) -> None:
        cbs = getattr(runner, "callbacks", None)
        if cbs is None:
            cbs = runner.callbacks = {}
        for e, fns in self.callbacks.items():
            for f in fns:
                if f not in cbs.setdefault(e, []):
                    cbs[e].append(f)

    # -- properties ----------------------------------------------------------
    @property
    def names(self) -> Dict[int, str]:
        return self.backend.names if self.backend is not None else self.model.names

    @property
    def stride(self):
        return tuple(float(s) for s in self.backend.stride) if self.backend is not None else self.model.stride

    @property
    def device(self) -> str:
        """The model's device; for a served model the client's, where its NMS runs."""
        if self.backend is not None:
            return str(torch.device(self.overrides.get("device") or "cuda"))
        return str(next(self.model.parameters()).device)

    # -- modes ---------------------------------------------------------------
    def predict(self, source=None, stream: bool = False, **kwargs) -> List:
        overrides = {k: v for k, v in {**self.overrides, **kwargs}.items() if k not in {"model", "task", "mode"}}
        key = tuple(sorted((k, repr(v)) for k, v in overrides.items()))
        if self.predictor is None or self._predictor_key != key:
            if self.backend is not None:
                from ..serve import RemotePredictor

                self.predictor = RemotePredictor(self.backend, overrides=overrides)
            else:
                self.predictor = BasePredictor(self.model, overrides=overrides, names=self.names)
            self._predictor_key = key
        self.predictor.callbacks = self.callbacks  # shared, as in the JAX facade
        return self.predictor(source, stream=stream, batch_size=kwargs.get("batch", 1))

    def __call__(self, source=None, **kwargs):
        return self.predict(source, **kwargs)

    def train(self, **kwargs) -> Dict[str, float]:
        """Train the checkpoint's model on `data` (JAX facade :241-268):
        train(data=..., epochs=N, ...) -> the last validation's results_dict,
        in bf16 with f32 parameters at the default amp=True, in f32 with
        amp=False. Afterwards the facade holds the EMA's weights at the
        trainer's compute dtype (bf16 after amp: val() and predict() then run
        bf16), and the next predict builds its predictor anew; see
        engine/trainer.py for the options that raise."""
        if self.backend is not None:
            raise ValueError("remote (served) models are inference-only; train locally and re-serve")
        overrides = {k: v for k, v in {**self.overrides, **kwargs}.items() if k not in {"model", "task", "mode"}}
        trainer = DetectionTrainer(self.model, overrides)
        self._merge_callbacks(trainer)
        metrics = trainer.train()
        self.model, self.trainer = trainer.model, trainer
        self.predictor, self._predictor_key = None, None  # the weights changed: the next predict rebuilds
        return metrics

    def val(self, **kwargs) -> Dict[str, float]:
        """mAP of the model over a dataset: val(data="spectrogram_synth.yaml",
        batch=32) -> results_dict; `data` is a dataset YAML (path or the name of
        one of the port's packaged copies) or a dict. Without it, the data the
        checkpoint was trained on (its train_args), as the JAX facade does; a
        TypeError when the checkpoint names none either."""
        overrides = {k: v for k, v in {**self.overrides, **kwargs}.items() if k not in {"model", "task", "mode"}}
        data = overrides.pop("data", None) or self.ckpt_data
        if data is None:
            raise TypeError("val() needs data=: a dataset YAML or dict (the checkpoint names none)")
        if self.backend is not None:  # scored through the served graph, the val NMS here
            validator = BackendValidator(self.backend, overrides=overrides)
        else:
            validator = DetectionValidator(self.model, overrides=overrides)
        validator.callbacks = self.callbacks  # shared, as in the JAX facade
        self.validator = validator
        return validator(data=data)

    def track(self, *args, **kwargs):
        raise _not_ported("tracking", "item 12 (host-side remainder: trackers)")

    def export(self, **kwargs):
        raise _not_ported("export", "item 9 (the Exporter and the artifact kinds)")
