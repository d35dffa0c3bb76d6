"""JSON-lines metrics logger, always on. Counterpart of
spectrogram_yolov11_tpu/utils/jsonl.py: at train start `<save_dir>/args.json`
holds the run's resolved arguments; after each epoch's fit one JSON object
is appended to `<save_dir>/metrics.jsonl`: the epoch (from 1), the seconds
since train start, the epoch's mean label losses (`train/box_loss`, ...) and
the last val's metrics, each as JAX writes it."""

from __future__ import annotations

import json
import time
from pathlib import Path

_T0 = {}


def _path(trainer) -> Path:
    return Path(trainer.save_dir) / "metrics.jsonl"


def on_train_start(trainer) -> None:
    _T0[id(trainer)] = time.time()
    p = Path(trainer.save_dir)
    p.mkdir(parents=True, exist_ok=True)
    args = getattr(trainer, "args", None)
    if args is not None:
        (p / "args.json").write_text(json.dumps({k: _js(v) for k, v in vars(args).items()}, indent=2))


def on_fit_epoch_end(trainer) -> None:
    row = {"epoch": int(getattr(trainer, "epoch", 0)) + 1,
           "time": round(time.time() - _T0.get(id(trainer), time.time()), 3)}
    row.update({k: _js(v) for k, v in (getattr(trainer, "label_loss", {}) or {}).items()})
    row.update({k: _js(v) for k, v in (getattr(trainer, "metrics", {}) or {}).items()})
    with _path(trainer).open("a") as f:
        f.write(json.dumps(row) + "\n")


def on_train_end(trainer) -> None:
    _T0.pop(id(trainer), None)


def _js(v):
    """v when JSON takes it, else its float, else its str (JAX's rule)."""
    try:
        json.dumps(v)
        return v
    except TypeError:
        try:
            return float(v)
        except (TypeError, ValueError):
            return str(v)


callbacks = {
    "on_train_start": on_train_start,
    "on_fit_epoch_end": on_fit_epoch_end,
    "on_train_end": on_train_end,
}
