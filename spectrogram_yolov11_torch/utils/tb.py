"""TensorBoard scalars of a training run. Counterpart of
spectrogram_yolov11_tpu/utils/tb.py (:33-49): at train start an event file
in `<save_dir>`, after each epoch's fit the label losses and the val metrics
(a key without "/" under "metrics/") at step epoch + 1, flushed; closed at
train end.

JAX writes through torch.utils.tensorboard's SummaryWriter, whose import
loads TensorFlow when it is installed (seconds). This module writes the same
records itself, TensorBoard's Event protos framed by its RecordWriter, as
SummaryWriter(logdir).add_scalar writes them: the file
`events.out.tfevents.<time>.<host>.<pid>.<n>`, a `brain.Event:2` version
record first. Where the tensorboard package is absent the integration is
skipped (utils/callbacks.py), as JAX's is without a SummaryWriter."""

from __future__ import annotations

import importlib.util
import itertools
import os
import socket
import time
from pathlib import Path

from . import LOGGER

if importlib.util.find_spec("tensorboard") is None:
    raise ImportError("tensorboard is not installed")

_WRITER = None
_UID = itertools.count()


class EventWriter:
    """Scalar events into a new TensorBoard event file in `logdir`."""

    def __init__(self, logdir: str | Path):
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary
        from tensorboard.summary.writer.record_writer import RecordWriter

        self._event, self._summary = Event, Summary
        Path(logdir).mkdir(parents=True, exist_ok=True)
        self.path = Path(logdir) / (f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}."
                                    f"{os.getpid()}.{next(_UID)}")
        self._records = RecordWriter(open(self.path, "wb"))
        self._write(Event(wall_time=time.time(), file_version="brain.Event:2"))

    def _write(self, event) -> None:
        self._records.write(event.SerializeToString())

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        summary = self._summary(value=[self._summary.Value(tag=tag, simple_value=float(value))])
        self._write(self._event(wall_time=time.time(), step=int(step), summary=summary))

    def flush(self) -> None:
        self._records.flush()

    def close(self) -> None:
        self._records.close()


def _scalars(trainer) -> dict:
    out = {}
    out.update(getattr(trainer, "label_loss", {}) or {})
    for k, v in (getattr(trainer, "metrics", {}) or {}).items():
        key = k if "/" in k else f"metrics/{k}"
        try:
            out[key] = float(v)
        except (TypeError, ValueError):
            pass
    return out


def on_train_start(trainer) -> None:
    global _WRITER
    try:
        _WRITER = EventWriter(trainer.save_dir)
        LOGGER.info(f"TensorBoard: logging to {trainer.save_dir} (tensorboard --logdir {trainer.save_dir})")
    except Exception as e:  # logging must never fail a training run
        _WRITER = None
        LOGGER.warning(f"TensorBoard init failed: {e}")


def on_fit_epoch_end(trainer) -> None:
    if _WRITER is None:
        return
    step = int(getattr(trainer, "epoch", 0)) + 1
    for k, v in _scalars(trainer).items():
        _WRITER.add_scalar(k, float(v), step)
    _WRITER.flush()


def on_train_end(trainer) -> None:
    global _WRITER
    if _WRITER is not None:
        _WRITER.close()
        _WRITER = None


callbacks = {
    "on_train_start": on_train_start,
    "on_fit_epoch_end": on_fit_epoch_end,
    "on_train_end": on_train_end,
}
