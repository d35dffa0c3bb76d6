"""Detection results on the host (numpy). Counterpart of
spectrogram_yolov11_tpu/engine/results.py: Boxes (:46) and Results (:203) for
the detect task. The predictor builds them after the fixed-shape NMS output
has left the card, so device movement is the identity here too.

plot, save, save_crop and show draw, encode or show images with cv2 in the
JAX package; the port has no drawing, no JPEG encoder and no window, so they
raise NotImplementedError.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..ops.boxes import xyxy2xywh
from ..utils import SimpleClass

_NO_CV2 = ("needs box drawing and a JPEG encoder, or a window for show (cv2 in the JAX package), which the port "
           "does not have; queued in ROADMAP.md §1 item 5")


class _TensorCompat:
    """cpu/numpy/cuda/to of the reference containers: identities, since the
    data is host numpy already."""

    def cpu(self):
        return self

    def numpy(self):
        return self

    def cuda(self):
        return self

    def to(self, *args, **kwargs):
        return self


class Boxes(_TensorCompat, SimpleClass):
    """(n, 6) [x1, y1, x2, y2, conf, cls] in original-image pixels; `id`
    holds track ids when a caller sets them through Results.update."""

    def __init__(self, data: np.ndarray, orig_shape, ids: Optional[np.ndarray] = None):
        self.data = np.asarray(data, np.float32).reshape(-1, 6)
        self.orig_shape = orig_shape
        self.id = None if ids is None else np.asarray(ids)

    def __len__(self):
        return len(self.data)

    @property
    def shape(self):
        return self.data.shape

    def __getitem__(self, i):
        return Boxes(self.data[i], self.orig_shape, None if self.id is None else np.atleast_1d(self.id[i]))

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, 4]

    @property
    def cls(self):
        return self.data[:, 5]

    @property
    def xywh(self):
        return xyxy2xywh(self.data[:, :4])

    @property
    def xyxyn(self):
        h, w = self.orig_shape
        return self.data[:, :4] / np.asarray([w, h, w, h], np.float32)

    @property
    def xywhn(self):
        h, w = self.orig_shape
        return self.xywh / np.asarray([w, h, w, h], np.float32)


class Results(_TensorCompat, SimpleClass):
    """One image's detections: orig_img (host uint8 HWC BGR), path, names,
    boxes and the per-image speed dict in ms."""

    def __init__(self, orig_img: np.ndarray, path: str, names: Dict[int, str],
                 boxes: Optional[np.ndarray] = None, speed: Optional[dict] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.speed = speed or {"preprocess": None, "inference": None, "postprocess": None}

    def __len__(self):
        return 0 if self.boxes is None else len(self.boxes)

    def __getitem__(self, i):
        """Row-select detections: i is an int, a slice, or a bool/index array."""
        boxes = self.boxes.data[i].reshape(-1, 6) if self.boxes is not None else None
        return Results(self.orig_img, self.path, self.names, boxes=boxes, speed=self.speed)

    def plot(self, *args, **kwargs):
        raise NotImplementedError(f"Results.plot {_NO_CV2}")

    def save(self, *args, **kwargs):
        raise NotImplementedError(f"Results.save {_NO_CV2}")

    def save_crop(self, *args, **kwargs):
        raise NotImplementedError(f"Results.save_crop {_NO_CV2}")

    def show(self, *args, **kwargs):
        raise NotImplementedError(f"Results.show {_NO_CV2}")

    def save_txt(self, txt_file: str | Path, save_conf: bool = False) -> None:
        """YOLO-format label rows: class, normalised xywh[, conf]."""
        lines = []
        if self.boxes is not None:
            for b, xywhn in zip(self.boxes.data, self.boxes.xywhn):
                line = (int(b[5]), *xywhn.tolist()) + ((float(b[4]),) if save_conf else ())
                lines.append(" ".join(f"{v:.6g}" if isinstance(v, float) else str(v) for v in line))
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_file).write_text("\n".join(lines) + ("\n" if lines else ""))

    def to_json(self) -> str:
        out = []
        if self.boxes is not None:
            for b in self.boxes.data:
                out.append({
                    "name": self.names.get(int(b[5]), str(int(b[5]))),
                    "class": int(b[5]),
                    "confidence": round(float(b[4]), 5),
                    "box": {"x1": float(b[0]), "y1": float(b[1]), "x2": float(b[2]), "y2": float(b[3])},
                })
        return json.dumps(out, indent=2)

    def tojson(self, *args, **kwargs) -> str:
        """Alias of to_json under the reference's name."""
        return self.to_json()

    def summary(self) -> list:
        return json.loads(self.to_json())

    def new(self) -> "Results":
        """Empty Results with the same image, path and names."""
        return Results(self.orig_img, self.path, self.names, speed=self.speed)

    def update(self, boxes: Optional[np.ndarray] = None) -> None:
        """Replace the boxes in place; a 7th column, when present, becomes the track ids."""
        if boxes is not None:
            boxes = np.asarray(boxes)
            self.boxes = Boxes(boxes[:, :6], self.orig_shape, ids=boxes[:, 6] if boxes.shape[1] > 6 else None)

    def verbose(self) -> str:
        """Log-line summary such as '2 LTEs, 1 RF, '."""
        if self.boxes is None or len(self.boxes) == 0:
            return "(no detections), "
        cls = self.boxes.cls.astype(int)
        parts = []
        for c in np.unique(cls):
            n = int((cls == c).sum())
            parts.append(f"{n} {self.names.get(int(c), int(c))}{'s' * (n > 1)}")
        return ", ".join(parts) + ", "
