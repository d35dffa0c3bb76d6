"""Callback bus for the validator and the predictor. Counterpart of
spectrogram_yolov11_tpu/utils/callbacks.py (default_callbacks :28,
run_callbacks :34) for the events DetectionValidator.__call__ and
BasePredictor.stream_inference fire, in the order they fire them."""

from __future__ import annotations

from typing import Callable, Dict, List

EVENTS = [
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


def default_callbacks() -> Dict[str, List[Callable]]:
    return {e: [] for e in EVENTS}


def run_callbacks(callbacks: Dict[str, List[Callable]], event: str, obj) -> None:
    for fn in callbacks.get(event, []):
        fn(obj)
