"""Detection, segmentation, pose, OBB and classification results on the host (numpy).
Counterpart of spectrogram_yolov11_tpu/engine/results.py: Boxes (:46),
Masks (:90), Keypoints (:110), Probs (:131), OBBoxes (:154) and Results
(:203) for the detect, segment, pose, obb and classify tasks.
The predictor builds them after the fixed-shape NMS output has left the
card, so device movement is the identity here too.

With masks, plot first fills each mask's pixels with its colour (by the
mask's index) on a copy of the image and blends it over the image as
cv2.addWeighted(img, 0.55, overlay, 0.45, 0) does on uint8, bit for bit
(JAX :254-258: a fused multiply-add of the first product onto the rounded
second, rounded to f32 and then to the nearest integer, ties to even, and
saturated), then draws the boxes. Masks.xy and save_txt of a mask result
need cv2.findContours (JAX data/converter.py:196 masks2segments) and raise
(ROADMAP.md item 10). With keypoints, plot then draws each keypoint whose
visibility is over 0.5 (every one when there is none) as a filled green
disc of radius max(lw, 2) at its truncated pixel (utils/plotting.py:circle,
equal to cv2.circle; JAX :270-273), and save_txt appends each row's
keypoints normalised by the image's size (JAX :319-322). The tables carry
no keypoints, as JAX's carry none. With rotated boxes (`obb`, (n, 7) cx, cy,
w, h, angle, conf, cls), plot draws each box's corners, truncated to int32,
as a closed polyline in its class colour at the line width
(utils/plotting.py:polylines, equal to cv2.polylines; JAX :275-278), and
save_txt writes the class and the 8 corners normalised by the image's size
(JAX :327-332); the tables and save_crop carry no rotated boxes, as JAX's. With class probabilities
(`probs`, (nc,), the classify task's), save_txt writes the one line
"<top-1 conf> <name>" (JAX :334-335), the tables one row of the top-1 class
and its confidence (:351-353), verbose the top-5 classes with their
probabilities (:433-434), and plot draws nothing for them: JAX's plot has no
probs branch, so a classify result plots as its image (ROADMAP.md §3.46).

plot, save and save_crop are JAX's (:248-304) for boxes: the same line width,
colours, corners, labels and crops, drawn by utils/plotting.py (rectangles
equal to cv2.rectangle; labels in the port's stroke font, not cv2's) and
written by data/imageio.py:imwrite (JPEG bytes equal to cv2.imwrite's). show
raises NotImplementedError: the card's machine has no window. The tables
are JAX's (:338-388): to_json / summary rows, to_df, to_csv and to_xml
through pandas (imported when called: its ImportError where it is absent),
to_sql into sqlite3.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..data.imageio import imwrite
from ..ops.boxes import xywhr2xyxyxyxy, xyxy2xywh
from ..utils import SimpleClass, not_ported
from ..utils.plotting import circle, polylines, put_text, rectangle

# the JAX package's box colours (engine/results.py:195-199), in the channel order cv2 draws them (BGR)
_COLORS = np.array(
    [[4, 42, 255], [11, 219, 235], [243, 243, 243], [0, 223, 183], [17, 31, 104], [255, 111, 221],
     [255, 68, 79], [204, 237, 0], [0, 243, 68], [189, 0, 255], [0, 180, 255], [221, 0, 186],
     [0, 192, 38], [255, 36, 125], [104, 0, 123], [108, 27, 255], [47, 109, 252], [104, 31, 17]],
    np.uint8,
)


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


class Masks(_TensorCompat, SimpleClass):
    """(n, H, W) bool masks at the original image's resolution (JAX :90)."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xy(self):
        raise not_ported("Masks.xy (mask contours by cv2.findContours)", "item 10 (other heads: Masks.xy)")


class Keypoints(_TensorCompat, SimpleClass):
    """(n, K, 2|3) keypoints in original-image pixels (JAX :110): xy, xyn
    (normalised by the image's size) and conf (the visibility, or None)."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data, np.float32)
        self.orig_shape = orig_shape

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def xyn(self):
        h, w = self.orig_shape
        return self.data[..., :2] / np.asarray([w, h], np.float32)

    @property
    def conf(self):
        return self.data[..., 2] if self.data.shape[-1] == 3 else None


class Probs(_TensorCompat, SimpleClass):
    """Classification probabilities (nc,) float32 (JAX :131): top1, top5 (by
    numpy's argsort, descending), top1conf, top5conf."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, np.float32)

    @property
    def top1(self) -> int:
        return int(self.data.argmax())

    @property
    def top5(self) -> list:
        return self.data.argsort()[::-1][:5].tolist()

    @property
    def top1conf(self) -> float:
        return float(self.data.max())

    @property
    def top5conf(self) -> np.ndarray:
        return self.data[self.top5]


class OBBoxes(_TensorCompat, SimpleClass):
    """(n, 7) [cx, cy, w, h, angle, conf, cls] rotated boxes in
    original-image pixels, the angle in radians (JAX :154): xywhr, conf, cls,
    the corners xyxyxyxy (n, 4, 2) and xyxyxyxyn (normalised by the image's
    size), and xyxy, each box's axis-aligned hull."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data, np.float32).reshape(-1, 7)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xywhr(self):
        return self.data[:, :5]

    @property
    def conf(self):
        return self.data[:, 5]

    @property
    def cls(self):
        return self.data[:, 6]

    @property
    def xyxyxyxy(self):
        return xywhr2xyxyxyxy(self.data[:, :5])

    @property
    def xyxyxyxyn(self):
        h, w = self.orig_shape
        return self.xyxyxyxy / np.asarray([w, h], np.float32)

    @property
    def xyxy(self):
        c = self.xyxyxyxy.reshape(-1, 4, 2)
        return np.concatenate([c.min(axis=1), c.max(axis=1)], axis=-1)


def add_weighted(img: np.ndarray, alpha: float, overlay: np.ndarray, beta: float) -> np.ndarray:
    """cv2.addWeighted(img, alpha, overlay, beta, 0) on uint8, bit for bit:
    fma(img, f32(alpha), f32(overlay * f32(beta))) rounded to f32, then to
    the nearest integer (ties to even), saturated."""
    a, b = np.float32(alpha), np.float32(beta)
    second = (overlay.astype(np.float32) * b).astype(np.float64)
    t = (img.astype(np.float64) * np.float64(a) + second).astype(np.float32)
    return np.clip(np.rint(t), 0, 255).astype(np.uint8)


class Results(_TensorCompat, SimpleClass):
    """One image's detections: orig_img (host uint8 HWC BGR), path, names,
    boxes, masks (the segment task's, (n, H, W) bool), keypoints (the pose
    task's, (n, K, 2|3)), obb (the obb task's rotated boxes, (n, 7)), probs
    (the classify task's probabilities, (nc,)) and the per-image speed dict in ms."""

    def __init__(self, orig_img: np.ndarray, path: str, names: Dict[int, str],
                 boxes: Optional[np.ndarray] = None, speed: Optional[dict] = None, masks: Optional[np.ndarray] = None,
                 keypoints: Optional[np.ndarray] = None, obb: Optional[np.ndarray] = None,
                 probs: Optional[np.ndarray] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.keypoints = Keypoints(keypoints, self.orig_shape) if keypoints is not None else None
        self.obb = OBBoxes(obb, self.orig_shape) if obb is not None else None
        self.probs = Probs(probs) if probs is not None else None
        self.speed = speed or {"preprocess": None, "inference": None, "postprocess": None}

    def __len__(self):
        for k in (self.boxes, self.masks, self.obb):
            if k is not None:
                return len(k)
        return 0

    def __getitem__(self, i):
        """Row-select detections: i is an int, a slice, or a bool/index array."""
        boxes = self.boxes.data[i].reshape(-1, 6) if self.boxes is not None else None
        masks = self.masks.data[i].reshape((-1,) + self.masks.data.shape[1:]) if self.masks is not None else None
        kpts = self.keypoints.data[i].reshape((-1,) + self.keypoints.data.shape[1:]) if self.keypoints is not None \
            else None
        obb = self.obb.data[i].reshape(-1, 7) if self.obb is not None else None
        return Results(self.orig_img, self.path, self.names, boxes=boxes, speed=self.speed, masks=masks,
                       keypoints=kpts, obb=obb, probs=self.probs.data if self.probs is not None else None)

    def plot(self, line_width: Optional[int] = None, font_scale: float = 0.5, show_conf: bool = True,
             show_labels: bool = True, img: Optional[np.ndarray] = None) -> np.ndarray:
        """The detections drawn on a copy of orig_img (or on `img`, in place):
        each box in its class colour at line width `line_width` or max(round((H
        + W) / 2 * 0.003), 2), its label (name, and the confidence to 2
        places) above it at thickness max(lw - 1, 1); then the keypoints, then
        the rotated boxes."""
        img = self.orig_img.copy() if img is None else img
        lw = line_width or max(round(sum(img.shape[:2]) / 2 * 0.003), 2)
        if self.masks is not None:
            overlay = img.copy()
            for i, m in enumerate(self.masks.data):
                overlay[m.astype(bool)] = _COLORS[i % len(_COLORS)]
            img = add_weighted(img, 0.55, overlay, 0.45)
        if self.boxes is not None:
            for b in self.boxes.data:
                c = int(b[5])
                color = _COLORS[c % len(_COLORS)].tolist()
                p1, p2 = (int(b[0]), int(b[1])), (int(b[2]), int(b[3]))
                rectangle(img, p1, p2, color, lw)
                if show_labels:
                    label = self.names.get(c, str(c)) + (f" {b[4]:.2f}" if show_conf else "")
                    put_text(img, label, (p1[0], max(p1[1] - 4, 12)), font_scale, color, max(lw - 1, 1))
        if self.keypoints is not None:
            for kp in self.keypoints.data:
                for x, y, *v in kp:
                    if not v or v[0] > 0.5:
                        circle(img, (int(x), int(y)), max(lw, 2), (0, 255, 0))
        if self.obb is not None:
            for corners, c in zip(self.obb.xyxyxyxy, self.obb.cls):
                polylines(img, corners.astype(np.int32), True, _COLORS[int(c) % len(_COLORS)].tolist(), lw)
        return img

    def save(self, filename: str | Path, **plot_kw) -> str:
        """plot(**plot_kw) written to `filename` (JPEG at quality 95 for .jpg, as cv2.imwrite)."""
        imwrite(filename, self.plot(**plot_kw))
        return str(filename)

    def save_crop(self, save_dir: str | Path, file_name: str | Path = "im.jpg") -> None:
        """Each detection's crop of orig_img, squared up by 1.02 and 10 px and
        clipped to the image, written to save_dir/<class name>/<stem>[_i]<suffix>."""
        if self.boxes is None or not len(self.boxes.data):
            return
        h, w = self.orig_img.shape[:2]
        for i, b in enumerate(self.boxes.data):
            cx, cy = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
            bw, bh = (b[2] - b[0]) * 1.02 + 10, (b[3] - b[1]) * 1.02 + 10
            x1, x2 = int(max(cx - bw / 2, 0)), int(min(cx + bw / 2, w))
            y1, y2 = int(max(cy - bh / 2, 0)), int(min(cy + bh / 2, h))
            if x2 <= x1 or y2 <= y1:
                continue
            d = Path(save_dir) / self.names.get(int(b[5]), str(int(b[5])))
            d.mkdir(parents=True, exist_ok=True)
            stem, suffix = Path(file_name).stem, Path(file_name).suffix or ".jpg"
            imwrite(d / f"{stem}{'' if i == 0 else f'_{i}'}{suffix}", self.orig_img[y1:y2, x1:x2])

    def show(self, *args, **kwargs):
        raise NotImplementedError("Results.show opens a window (cv2.imshow in the JAX package), which the card's "
                                  "machine does not have; queued in ROADMAP.md §1 item 5 (second part)")

    def save_txt(self, txt_file: str | Path, save_conf: bool = False) -> None:
        """YOLO-format label rows: class, normalised xywh[, each keypoint's
        normalised x, y (and visibility)][, conf]; after them a rotated box's
        class and its 8 normalised corners[, conf]; a probs result writes
        "<top-1 conf> <name>" alone. A mask result's rows are polygons from the masks' contours (JAX :305-316),
        which raise (item 10)."""
        if self.masks is not None and len(self.masks):
            raise not_ported("save_txt of a mask result (contours by cv2.findContours)",
                             "item 10 (other heads: save_txt of masks)")
        lines = []
        h, w = self.orig_img.shape[:2]
        if self.boxes is not None:
            for i, (b, xywhn) in enumerate(zip(self.boxes.data, self.boxes.xywhn)):
                line = (int(b[5]), *xywhn.tolist())
                if self.keypoints is not None and i < len(self.keypoints.data):
                    kp = np.asarray(self.keypoints.data[i], np.float32).copy()
                    kp[..., 0] /= w
                    kp[..., 1] /= h
                    line = line + tuple(float(v) for v in kp.reshape(-1))
                line = line + ((float(b[4]),) if save_conf else ())
                lines.append(" ".join(f"{v:.6g}" if isinstance(v, float) else str(v) for v in line))
        if self.obb is not None:
            for corners, c, conf in zip(self.obb.xyxyxyxy, self.obb.cls, self.obb.conf):
                xy = (np.asarray(corners, np.float32) / np.asarray([w, h], np.float32)).reshape(-1)
                line = (int(c), *(float(v) for v in xy)) + ((float(conf),) if save_conf else ())
                lines.append(" ".join(f"{v:.6g}" if isinstance(v, float) else str(v) for v in line))
        if self.probs is not None:
            lines = [f"{self.probs.top1conf:.2f} {self.names.get(self.probs.top1, self.probs.top1)}"]
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
        if self.probs is not None:
            out.append({"name": self.names.get(self.probs.top1, str(self.probs.top1)), "class": self.probs.top1,
                        "confidence": round(self.probs.top1conf, 5)})
        return json.dumps(out, indent=2)

    def to_df(self):
        """The detections as a pandas DataFrame of to_json's rows (JAX :356):
        pandas is imported here, so without it this raises its ImportError."""
        import pandas as pd

        return pd.DataFrame(json.loads(self.to_json()))

    def to_csv(self, *args, **kwargs) -> str:
        """to_df().to_csv(*args, **kwargs) (JAX :362)."""
        return self.to_df().to_csv(*args, **kwargs)

    def to_xml(self, *args, **kwargs) -> str:
        """to_df().to_xml(*args, **kwargs) (JAX :366; pandas with lxml), an
        empty <data> document without detections."""
        df = self.to_df()
        return df.to_xml(*args, **kwargs) if len(df) else "<?xml version='1.0' encoding='utf-8'?>\n<data></data>"

    def to_sql(self, table_name: str = "results", db_path: str = "results.db") -> None:
        """Append the detections to an sqlite table (JAX :371), created with
        JAX's schema (name TEXT, class INTEGER, confidence REAL, x1 REAL,
        y1 REAL, x2 REAL, y2 REAL) when missing; the stdlib's sqlite3."""
        import sqlite3

        con = sqlite3.connect(db_path)
        try:
            cur = con.cursor()
            cur.execute(f"CREATE TABLE IF NOT EXISTS {table_name} "
                        "(name TEXT, class INTEGER, confidence REAL, x1 REAL, y1 REAL, x2 REAL, y2 REAL)")
            rows = [(r["name"], r["class"], r["confidence"], r.get("box", {}).get("x1"), r.get("box", {}).get("y1"),
                     r.get("box", {}).get("x2"), r.get("box", {}).get("y2")) for r in self.summary()]
            cur.executemany(f"INSERT INTO {table_name} VALUES (?,?,?,?,?,?,?)", rows)
            con.commit()
        finally:
            con.close()

    def tojson(self, *args, **kwargs) -> str:
        """Alias of to_json under the reference's name."""
        return self.to_json()

    def summary(self) -> list:
        return json.loads(self.to_json())

    def new(self) -> "Results":
        """Empty Results with the same image, path and names."""
        return Results(self.orig_img, self.path, self.names, speed=self.speed)

    def update(self, boxes: Optional[np.ndarray] = None, masks: Optional[np.ndarray] = None,
               keypoints: Optional[np.ndarray] = None, obb: Optional[np.ndarray] = None,
               probs: Optional[np.ndarray] = None) -> None:
        """Replace the boxes (a 7th column, when present, becomes the track
        ids), the masks, the keypoints, the rotated boxes and the probs in place (JAX :414)."""
        if boxes is not None:
            boxes = np.asarray(boxes)
            self.boxes = Boxes(boxes[:, :6], self.orig_shape, ids=boxes[:, 6] if boxes.shape[1] > 6 else None)
        if masks is not None:
            self.masks = Masks(masks, self.orig_shape)
        if keypoints is not None:
            self.keypoints = Keypoints(keypoints, self.orig_shape)
        if obb is not None:
            self.obb = OBBoxes(obb, self.orig_shape)
        if probs is not None:
            self.probs = Probs(probs)

    def verbose(self) -> str:
        """Log-line summary such as '2 LTEs, 1 RF, ': the top-5 classes and
        their probabilities for a probs result, else of the rotated boxes
        when there are any, else of the boxes."""
        if self.probs is not None:
            return ", ".join(f"{self.names.get(i, i)} {self.probs.data[i]:.2f}" for i in self.probs.top5) + ", "
        det = self.obb if self.obb is not None else self.boxes
        if det is None or len(det) == 0:
            return "(no detections), "
        cls = det.cls.astype(int)
        parts = []
        for c in np.unique(cls):
            n = int((cls == c).sum())
            parts.append(f"{n} {self.names.get(int(c), int(c))}{'s' * (n > 1)}")
        return ", ".join(parts) + ", "
