"""Callback bus for the trainer, the validator and the predictor. Counterpart
of spectrogram_yolov11_tpu/utils/callbacks.py (default_callbacks :28,
run_callbacks :34, _attach_integrations :48) for the events
DetectionTrainer.train, DetectionValidator.__call__ and
BasePredictor.stream_inference fire, in the order they fire them.

default_callbacks attaches the logging integrations, each a module of this
package exporting a `callbacks` dict of event -> function, as JAX's
_attach_integrations does: one whose import fails (ImportError or
AssertionError) is skipped. `jsonl` (utils/jsonl.py: args.json and one
metrics.jsonl row per epoch) is always there; `tb` (utils/tb.py: TensorBoard
scalars) only where the tensorboard package imports. JAX's other eight (wb,
mlflow, hub, comet, clearml, dvc, neptune, raytune) are ROADMAP.md §1 item
12."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List

EVENTS = [
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_end",
    "on_fit_epoch_end",
    "on_train_end",
    "on_val_start",
    "on_val_batch_start",
    "on_val_batch_end",
    "on_val_end",
    "on_predict_start",
    "on_predict_batch_start",
    "on_predict_postprocess_end",
    "on_predict_batch_end",
    "on_predict_end",
]

# integration modules of this package, each exporting a `callbacks` event -> fn dict
_INTEGRATIONS = (".jsonl", ".tb")


def default_callbacks() -> Dict[str, List[Callable]]:
    cbs: Dict[str, List[Callable]] = {e: [] for e in EVENTS}
    _attach_integrations(cbs)
    return cbs


def run_callbacks(callbacks: Dict[str, List[Callable]], event: str, obj) -> None:
    for fn in callbacks.get(event, []):
        fn(obj)


def _attach_integrations(cbs: Dict[str, List[Callable]]) -> None:
    for mod in _INTEGRATIONS:
        try:
            m = importlib.import_module(mod, package=__package__)
        except (ImportError, AssertionError):
            continue
        for k, v in m.callbacks.items():
            if v not in cbs[k]:
                cbs[k].append(v)
