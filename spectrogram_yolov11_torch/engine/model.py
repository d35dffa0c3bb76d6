"""The `YOLO` facade for the port. Counterpart of
spectrogram_yolov11_tpu/engine/model.py:40 YOLO for the detect task on the JAX
package's `.ckpt` checkpoints:

    YOLO("runs_artifacts/spectrogram_yolo11n.ckpt").predict("capture.npy")
    YOLO("runs_artifacts/spectrogram_yolo11n.ckpt").val(data="spectrogram_synth.yaml", batch=32)

The weights (EMA before the raw variables) are read on the host, carried
across by the weight bridge and folded for the bottleneck kernel; predict
moves the model to its device, the card unless the caller passes
device="cpu", and raises without a card. Predictors are cached on their
sorted overrides, as in the JAX facade, `half` among them: predict(half=True)
runs a bf16 copy of the model and leaves the f32 model to half=False calls.
val builds a DetectionValidator per call (engine/validator.py), kept as
`self.validator`, with the same defaults and callbacks.
Other model sources and modes raise NotImplementedError naming the
ROADMAP.md item that ports them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

from ..utils import not_ported as _not_ported
from ..utils.callbacks import default_callbacks
from .pipeline import load_model
from .predictor import BasePredictor
from .validator import DetectionValidator


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
        if task not in (None, "detect"):
            raise _not_ported(f"task {task!r}", "item 10 (other heads)")
        self.task = "detect"
        if self.model_path.startswith(("http://", "https://", "grpc://")):
            raise _not_ported(f"remote model {self.model_path!r}", "item 9 (export + serving)")
        suffix = Path(self.model_path).suffix
        if suffix == ".ckpt":
            self._load_ckpt(self.model_path)
        elif suffix == ".pt":
            raise _not_ported(f"reference .pt import ({self.model_path})", "item 11 (other model families)")
        elif suffix in {".stablehlo", ".tflite", ".onnx"} or (Path(self.model_path) / "saved_model.pb").exists():
            raise _not_ported(f"exported model {self.model_path!r}", "item 9 (export + serving)")
        else:  # .yaml, or a bare name that the JAX facade reads as one
            raise _not_ported(f"building a model from YAML ({self.model_path})", "items 6-8 (training)")

    def _load_ckpt(self, path: str) -> None:
        self.model, meta = load_model(path)
        self.model.names = meta.get("names") or {i: f"{i}" for i in range(self.model.nc)}
        self.ckpt_meta = meta
        self.overrides["model"] = path

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
        return self.model.names

    @property
    def stride(self):
        return self.model.stride

    @property
    def device(self) -> str:
        return str(next(self.model.parameters()).device)

    # -- modes ---------------------------------------------------------------
    def predict(self, source=None, stream: bool = False, **kwargs) -> List:
        overrides = {k: v for k, v in {**self.overrides, **kwargs}.items() if k not in {"model", "task", "mode"}}
        key = tuple(sorted((k, repr(v)) for k, v in overrides.items()))
        if self.predictor is None or self._predictor_key != key:
            self.predictor = BasePredictor(self.model, overrides=overrides, names=self.names)
            self._predictor_key = key
        self.predictor.callbacks = self.callbacks  # shared, as in the JAX facade
        return self.predictor(source, stream=stream, batch_size=kwargs.get("batch", 1))

    def __call__(self, source=None, **kwargs):
        return self.predict(source, **kwargs)

    def train(self, **kwargs):
        raise _not_ported("training", "items 6-8 (training step, data, trainer loop)")

    def val(self, **kwargs) -> Dict[str, float]:
        """mAP of the model over a dataset: val(data="spectrogram_synth.yaml",
        batch=32) -> results_dict; `data` is a dataset YAML (path or the name of
        one of the port's packaged copies) or a dict, and is required."""
        overrides = {k: v for k, v in {**self.overrides, **kwargs}.items() if k not in {"model", "task", "mode"}}
        data = overrides.pop("data", None)
        if data is None:
            raise TypeError("val() needs data=: a dataset YAML or dict (the checkpoint names none)")
        validator = DetectionValidator(self.model, overrides=overrides)
        validator.callbacks = self.callbacks  # shared, as in the JAX facade
        self.validator = validator
        return validator(data=data)

    def track(self, *args, **kwargs):
        raise _not_ported("tracking", "item 12 (host-side remainder: trackers)")

    def export(self, **kwargs):
        raise _not_ported("export", "item 9 (export + serving)")
