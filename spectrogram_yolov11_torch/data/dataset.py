"""Detect, segment, pose and OBB datasets: YOLO-format images and label txts, for validation and training;
and the classify task's folder-per-class datasets.

Counterpart of spectrogram_yolov11_tpu/data/dataset.py for the detect,
segment, pose and obb tasks: IMG_FORMATS (:27), img2label_path (:30),
check_det_dataset (:42) and YOLODataset (:126: _find_images with `fraction`,
the detect label rows, the segment task's polygon rows (:212-222, the box
the polygon's bounds), the obb task's rows (:227-231: `cls x1 y1 ... x4 y4`,
kept as a 4-point polygon, the box its bounds; a row of another length is
read as a detect row and then fails, KeyError, as JAX's) and the pose task's
rows (:232-238: `cls cx cy w h` and kpt_shape's nk x nd values, visibility 1
added when nd = 2), `segments` (segment and obb) and `keypoints` (n, nk, 3)
in each image's labels (:282-287),
single_cls, the automatic max_gt :157-165, load_image with cache="ram",
load_sample :344 with its long-side resize and the polygons and keypoints
scaled to pixels (:372-378), get_item, close_mosaic :381-389).
Images are read by data/imageio.py (JPEG and PNG, as cv2.imread reads them;
other formats raise NotImplementedError when an image is read), kept in
memory with cache="ram" or in `.npy` sidecars with cache="disk" (JAX
:324-341: np.save of the decoded BGR image beside its file, read before
decoding; a sidecar that does not load is rewritten, and a directory that
cannot be written to warns and runs uncached; the two packages read each
other's sidecars). The label txts are parsed once and kept
in JAX's JSON label cache (_cache_path :197, _hash :201, _load_labels :246,
_label_to_json / _label_from_json :303-312): `<images dir>.labels.<task>.json` beside
the images directory, keyed by the sha256 of the image and label paths and
their st_mtime_ns, written with the same bytes as JAX's, so the two packages
share one cache on a split and each reads what the other wrote.

augment=False is the val dataset: get_item(i) is the letterbox geometry and
labels of image i, the image left at its own size for the letterbox on the
card (data/augment.py: ValTransform). augment=True is the train dataset:
get_item(i, rng) is a sample's labels and either the parameters its image is
assembled from on the card or its image augmented on the host
(TrainTransform, in the mode data/augment.py:resolve_device_augment picks
from the train args).

The classify task (JAX :80 check_cls_dataset, :569 ClassificationDataset):
check_cls_dataset resolves a folder-per-class dataset (an absolute path, a
name under the repo's datasets/, or a dataset YAML such as ImageNet.yaml,
whose `names` fix the class folders) and synthesises the missing ones as
JAX's does (data/synth.py:gen_cls_shapes: 32 + 8 images per class of the
3-shape schema for a folder, n_per_class and half that from a YAML).
ClassificationDataset(root, imgsz, augment) reads root/<class>/<image>:
its train samples (augment=True) are JAX's draws from the sample's
Generator (RandomResizedCrop over the area [0.08, 1] and aspect [3/4, 4/3]
in up to 10 tries, the INTER_LINEAR resize to imgsz x imgsz by
data/augment.py:resize_linear_u8, a left-right flip at 0.5, augment_hsv
at 0.015, 0.4, 0.4, random erasing at 0.4), its val samples the short side
resized to imgsz and the centre crop; each {img (S, S, 3) uint8 RGB, cls
int32}, byte-equal to JAX's.

Dataset YAMLs given by name resolve among the port's own copies under
cfg/datasets/. The synthetic ones point at datasets/torch/..., so the two
packages never read or overwrite each other's stand-ins; Spectrogram.yaml
points at the user's datasets/spectrogram, as the JAX package's copy does.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

import torch

from ..utils import LOGGER, REPO_ROOT, yaml_load
from .augment import TrainTransform, ValTransform, augment_hsv, resize_linear_u8
from .imageio import imread

IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tif", "tiff", "webp"}
DATASETS_CFG = Path(__file__).resolve().parents[1] / "cfg" / "datasets"


def img2label_path(img_path: str) -> str:
    """images/xxx.png -> labels/xxx.txt: the last `images` part of the path becomes `labels`."""
    parts = list(Path(img_path).parts)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "images":
            parts[i] = "labels"
            break
    return str(Path(*parts).with_suffix(".txt"))


def find_dataset_yaml(name: str | Path) -> Path:
    """A dataset YAML: the path as given if it exists, else the port's packaged copy of that name."""
    p = Path(name)
    if p.exists():
        return p
    hit = DATASETS_CFG / p.name
    if hit.exists():
        return hit
    raise FileNotFoundError(f"Dataset yaml '{name}' not found (looked at {hit})")


def check_det_dataset(data: str | Path | dict) -> dict:
    """A dataset YAML (path or packaged name) or dict, resolved: `names` as
    {i: name} and `nc`, `path` absolute (relative to the YAML's directory),
    train/val/test paths under it. A synthetic dataset whose val split is
    missing is materialised (data/synth.py); any other missing val raises."""
    if isinstance(data, (str, Path)):
        data = yaml_load(find_dataset_yaml(data), append_filename=True)
    data = dict(data)
    if "val" not in data and "validation" in data:
        data["val"] = data.pop("validation")
    if "names" not in data and "nc" not in data:
        raise KeyError("dataset yaml must define 'names' or 'nc'")
    if "names" not in data:
        data["names"] = {i: f"class_{i}" for i in range(data["nc"])}
    elif isinstance(data["names"], (list, tuple)):
        data["names"] = dict(enumerate(data["names"]))
    data["nc"] = len(data["names"])
    root = Path(data.get("path") or Path(data.get("yaml_file", ".")).parent)
    if not root.is_absolute():
        root = (Path(data.get("yaml_file", ".")).parent / root).resolve()
    data["path"] = root
    for k in ("train", "val", "test"):
        if data.get(k):
            if isinstance(data[k], (list, tuple)):
                data[k] = [str(p if (p := Path(e)).is_absolute() else root / p) for e in data[k]]
            else:
                p = Path(data[k])
                data[k] = str(p if p.is_absolute() else root / p)
    val0 = data["val"][0] if isinstance(data.get("val"), (list, tuple)) else data.get("val")
    if val0 and not Path(val0).exists():
        from .synth import maybe_generate

        if not maybe_generate(data):
            raise FileNotFoundError(f"Dataset 'val' path not found: {data['val']}")
    return data


class YOLODataset:
    """Detection dataset over an images dir (or a .txt list of images, or a
    list of dirs) and YOLO label txts (`cls cx cy w h`, normalised). For
    validation (augment=False) get_item(i) is the letterbox geometry and
    formatted labels of image i, the image left at its own size for the
    letterbox on the card; for training (augment=True, with the train args as
    `hyp`) get_item(i, rng) is TrainTransform's sample. max_gt=0 sizes the GT
    pad from the labels, as the JAX trainer asks: min(128, max(32,
    ceil8(1.1 * most labels of an image * (4 with mosaic)))). A pose
    dataset reads its rows by `kpt_shape` (the data's, JAX's default (17,
    3)) and flips its keypoints left to right by `flip_idx`."""

    def __init__(self, img_path, imgsz: int = 640, max_gt: int = 256, single_cls: bool = False,
                 augment: bool = False, hyp=None, fraction: float = 1.0, cache=False, task: str = "detect",
                 mask_ratio: int = 4, kpt_shape=(17, 3), flip_idx=None):
        self.img_path = [Path(p) for p in img_path] if isinstance(img_path, (list, tuple)) else Path(img_path)
        self.single_cls = single_cls
        self.task = task
        self.kpt_shape = tuple(kpt_shape or (17, 3))
        self.augment = augment
        self.im_files = self._find_images(fraction)
        self.label_files = [img2label_path(f) for f in self.im_files]
        self.labels = self._load_labels()
        if not max_gt:
            most = max((len(lab["cls"]) for lab in self.labels), default=0) * (4 if augment else 1)
            max_gt = int(min(128, max(32, -(-int(most * 1.1) // 8) * 8)))
        self.max_gt = max_gt
        self.cache_ram = cache in (True, "ram")
        self.cache_disk = cache == "disk"
        self._im_cache: Dict[int, np.ndarray] = {}
        self.transform = (TrainTransform(self, imgsz, hyp, max_gt=max_gt, task=task, mask_ratio=mask_ratio,
                                         kpt_shape=self.kpt_shape, flip_idx=flip_idx) if augment
                          else ValTransform(imgsz, max_gt, task=task, mask_ratio=mask_ratio, kpt_shape=self.kpt_shape))

    def _find_images(self, fraction: float = 1.0) -> List[str]:
        files: List[str] = []
        for p in self.img_path if isinstance(self.img_path, list) else [self.img_path]:
            if p.is_dir():
                files += sorted(str(f) for f in p.rglob("*") if f.suffix[1:].lower() in IMG_FORMATS)
            elif p.is_file() and p.suffix == ".txt":
                files += sorted(str((p.parent / line.strip()).resolve()) for line in p.read_text().splitlines()
                                if line.strip())
            else:
                raise FileNotFoundError(f"image path not found: {p}")
        if not files:
            raise FileNotFoundError(f"no images found in {self.img_path}")
        if fraction < 1.0:
            files = files[: max(1, round(len(files) * fraction))]
        return files

    def _parse_row(self, parts: List[str]) -> Optional[Dict]:
        """One label row -> {cls, xywhn} (and `seg`, the polygon's points (n, 2)
        normalised, for a segment row: an even count of 6 or more values, its
        box the points' bounds; `kpt`, (nk, 3) normalised xy and visibility,
        for a pose row of 4 + nk * nd values, None for one of another
        length); None for a detect row with a box of no or too large size."""
        vals = [float(x) for x in parts[1:]]
        if self.task == "segment" and len(vals) >= 6 and len(vals) % 2 == 0:
            pts = np.asarray(vals, np.float32).reshape(-1, 2)
            lo, hi = pts.min(0), pts.max(0)
            return {"cls": int(float(parts[0])), "xywhn": [(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, hi[0] - lo[0],
                                                           hi[1] - lo[1]], "seg": pts.tolist()}
        if self.task == "obb" and len(vals) == 8:
            pts = np.asarray(vals, np.float32).reshape(4, 2)
            lo, hi = pts.min(0), pts.max(0)
            return {"cls": int(float(parts[0])), "xywhn": [(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, hi[0] - lo[0],
                                                           hi[1] - lo[1]], "seg": pts.tolist()}
        if self.task == "pose":
            nk, nd = self.kpt_shape
            if len(vals) != 4 + nk * nd:
                return None
            kpts = np.asarray(vals[4:], np.float32).reshape(nk, nd)
            if nd == 2:
                kpts = np.concatenate([kpts, np.ones((nk, 1), np.float32)], 1)
            return {"cls": int(float(parts[0])), "xywhn": vals[:4], "kpt": kpts.tolist()}
        if len(vals) >= 4 and 0 < vals[2] <= 1.0001 and 0 < vals[3] <= 1.0001:
            return {"cls": int(float(parts[0])), "xywhn": vals[:4]}
        return None

    def _cache_path(self) -> Path:
        """<images dir>.labels.<task>.json (the first path of a list), as JAX's."""
        p = self.img_path[0] if isinstance(self.img_path, list) else self.img_path
        return Path(str(p).rstrip("/")).with_suffix(f".labels.{self.task}.json")

    def _hash(self) -> str:
        """sha256 of every image and label path and its st_mtime_ns (where the file exists)."""
        h = hashlib.sha256()
        for f in self.im_files + self.label_files:
            h.update(f.encode())
            try:
                h.update(str(Path(f).stat().st_mtime_ns).encode())
            except OSError:
                pass
        return h.hexdigest()

    def _load_label(self, label_file: str) -> Dict[str, np.ndarray]:
        """({cls (n,) int32, xywhn (n, 4) float32, and for the segment task
        segments, a list of (k, 2) float32, for the pose task keypoints (n, nk,
        3) float32}, bad rows) of a label txt: short
        rows are skipped, rows that do not parse skipped and counted. A
        segment dataset's row that is not a polygon raises KeyError, as JAX's
        (:282)."""
        rows, bad = [], 0
        for line in Path(label_file).read_text().splitlines():
            parts = line.split()
            if len(parts) < 5:
                continue
            try:
                row = self._parse_row(parts)
            except ValueError:
                row = None
            if row is None:
                bad += 1
            else:
                rows.append(row)
        lab = {"cls": np.asarray([r["cls"] for r in rows], np.int32),
               "xywhn": np.asarray([r["xywhn"] for r in rows], np.float32).reshape(-1, 4)}
        if self.task in ("segment", "obb"):
            lab["segments"] = [np.asarray(r["seg"], np.float32) for r in rows]
        if self.task == "pose":
            nk = self.kpt_shape[0]
            lab["keypoints"] = (np.asarray([r["kpt"] for r in rows], np.float32).reshape(-1, nk, 3) if rows
                                else np.zeros((0, nk, 3), np.float32))
        return lab, bad

    def _load_labels(self) -> List[Dict[str, np.ndarray]]:
        """Every image's labels: from the cache when its hash is this file
        list's, else parsed from the txts and the cache (re)written; a cache
        that cannot be read or written is passed over."""
        cache_file, key = self._cache_path(), self._hash()
        if cache_file.exists():
            try:
                blob = json.loads(cache_file.read_text())
                if blob.get("hash") == key:
                    return [self._label_from_json(lab) for lab in blob["labels"]]
            except (json.JSONDecodeError, KeyError):
                pass
        labels, n_miss, n_bad = [], 0, 0
        empty = {"cls": np.zeros(0, np.int32), "xywhn": np.zeros((0, 4), np.float32),
                 **({"segments": []} if self.task in ("segment", "obb") else {}),
                 **({"keypoints": np.zeros((0, self.kpt_shape[0], 3), np.float32)} if self.task == "pose" else {})}
        for lf in self.label_files:
            if Path(lf).exists():
                lab, bad = self._load_label(lf)
                n_bad += bad
            else:
                lab, n_miss = dict(empty), n_miss + 1
            labels.append(lab)
        if n_miss or n_bad:
            LOGGER.info(f"labels: {n_miss} missing files, {n_bad} bad rows skipped")
        try:
            cache_file.write_text(json.dumps({"hash": key, "labels": [self._label_to_json(lab) for lab in labels]}))
        except OSError:
            pass
        return labels

    @staticmethod
    def _label_to_json(lab: Dict) -> Dict:
        out = {"cls": lab["cls"].tolist(), "xywhn": lab["xywhn"].tolist()}
        if "segments" in lab:
            out["segments"] = [p.tolist() for p in lab["segments"]]
        if "keypoints" in lab:
            out["keypoints"] = lab["keypoints"].tolist()
        return out

    def _label_from_json(self, lab: Dict) -> Dict:
        out = {"cls": np.asarray(lab["cls"], np.int32), "xywhn": np.asarray(lab["xywhn"], np.float32).reshape(-1, 4)}
        if "segments" in lab:
            out["segments"] = [np.asarray(p, np.float32) for p in lab["segments"]]
        if "keypoints" in lab:
            out["keypoints"] = np.asarray(lab["keypoints"], np.float32).reshape(-1, self.kpt_shape[0], 3)
        return out

    def __len__(self) -> int:
        return len(self.im_files)

    def load_image(self, i: int) -> np.ndarray:
        """Image i as BGR uint8 (H, W, 3), kept after its first read with
        cache="ram", or in its .npy sidecar with cache="disk"."""
        if self.cache_ram and i in self._im_cache:
            return self._im_cache[i]
        npy = Path(self.im_files[i]).with_suffix(".npy")
        if self.cache_disk and npy.exists():
            try:
                return np.load(npy)
            except (OSError, ValueError, EOFError):  # a truncated sidecar: decode and rewrite it
                pass
        img = imread(self.im_files[i])
        if self.cache_ram:
            self._im_cache[i] = img
        elif self.cache_disk:
            try:
                np.save(npy, img)
            except OSError as e:  # a read-only dataset directory: run uncached
                LOGGER.warning(f"disk cache write failed ({e}); continuing uncached")
                self.cache_disk = False
        return img

    def load_sample(self, i: int, square_to: Optional[int] = None) -> Dict:
        """Image i and its labels as xyxy pixels (and its polygons in pixels,
        `segments`, for the segment task, its keypoints' xy in pixels,
        `keypoints`, for the pose task); with square_to, the image
        resized first so its long side is square_to (each side min(int(side *
        r), square_to)), as cv2.resize(INTER_LINEAR) does it (resize_linear_u8):
        the JAX package's train-time resize (:344-357)."""
        img = self.load_image(i)
        if square_to:
            h0, w0 = img.shape[:2]
            r = square_to / max(h0, w0)
            if r != 1:
                nh, nw = min(int(h0 * r), square_to), min(int(w0 * r), square_to)
                img = resize_linear_u8(torch.from_numpy(img)[None], nh, nw)[0].numpy()
        h, w = img.shape[:2]
        lab = self.labels[i]
        cls = np.zeros_like(lab["cls"]) if self.single_cls else lab["cls"].copy()
        xywhn = lab["xywhn"]
        b = np.empty((len(xywhn), 4), np.float32)
        if len(xywhn):
            b[:, 0] = (xywhn[:, 0] - xywhn[:, 2] / 2) * w
            b[:, 1] = (xywhn[:, 1] - xywhn[:, 3] / 2) * h
            b[:, 2] = (xywhn[:, 0] + xywhn[:, 2] / 2) * w
            b[:, 3] = (xywhn[:, 1] + xywhn[:, 3] / 2) * h
        out = {"img": img, "cls": cls, "bboxes": b}
        if "segments" in lab:
            out["segments"] = [p * np.asarray([w, h], np.float32) for p in lab["segments"]]
        if "keypoints" in lab:
            k = lab["keypoints"].copy()
            k[..., 0] *= w
            k[..., 1] *= h
            out["keypoints"] = k
        return out

    def get_item(self, i: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        """Sample i: TrainTransform's with the sample's Generator `rng` when
        augmenting, else the val transform's (which draws nothing)."""
        return self.transform(i, rng) if self.augment else self.transform(self.load_sample(i))

    def close_mosaic(self) -> None:
        if self.augment:
            self.transform.close_mosaic()


def check_cls_dataset(data: str | Path) -> dict:
    """{train, val, nc, names} of a folder-per-class dataset (JAX :80): a
    dataset YAML (path or packaged name) whose train folder is missing is
    synthesised with its `names` (n_per_class per class at gen_imgsz into
    train, max(1, n_per_class // 2) with seed 10000 into val) and read from
    its `path`; a relative name that does not exist is read under the repo's
    datasets/; a folder without train/ gets the 3-shape stand-in (32 train
    and 8 val images per class). val is val/, else test/, else None; the
    classes are train/'s sub-folders, sorted."""
    from .synth import gen_cls_shapes

    if str(data).endswith((".yaml", ".yml")):
        spec = yaml_load(find_dataset_yaml(data), append_filename=True)
        root = Path(spec.get("path") or ".")
        if not root.is_absolute():
            root = (Path(spec["yaml_file"]).parent / root).resolve()
        if not (root / str(spec.get("train", "train"))).exists():
            names = spec.get("names")
            names = [names[k] for k in sorted(names)] if isinstance(names, dict) else list(names)
            npc, imgsz = int(spec.get("n_per_class", 2)), int(spec.get("gen_imgsz", 160))
            LOGGER.info(f"Generating synthetic classification stand-in at {root} ({len(names)} classes)...")
            gen_cls_shapes(root, str(spec.get("train", "train")), npc, imgsz, names=names)
            gen_cls_shapes(root, str(spec.get("val", "val")), max(1, npc // 2), imgsz, seed=10_000, names=names)
        data = root
    root = Path(data)
    if not root.is_absolute() and not root.exists():
        root = REPO_ROOT / "datasets" / root
    if not (root / "train").exists():
        LOGGER.info(f"Generating synthetic classification dataset at {root}...")
        gen_cls_shapes(root, "train", 32)
        gen_cls_shapes(root, "val", 8, seed=10_000)
    val = root / "val" if (root / "val").exists() else (root / "test" if (root / "test").exists() else None)
    names = sorted(d.name for d in (root / "train").iterdir() if d.is_dir())
    if not names:
        raise FileNotFoundError(f"no class folders under {root / 'train'}")
    return {"train": str(root / "train"), "val": str(val) if val else None,
            "nc": len(names), "names": dict(enumerate(names))}


class ClassificationDataset:
    """root/<class name>/<image> (JAX :569): `samples` (path, class index) in
    JAX's order (the class folders as the directory lists them, each one's
    images sorted), `names` {index: class}; get_item(i, rng) the sample as
    the module docstring says (rng only with augment)."""

    def __init__(self, root: str | Path, imgsz: int = 224, augment: bool = False):
        self.root = Path(root)
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = [(str(f), self.class_to_idx[d.name]) for d in self.root.iterdir() if d.is_dir()
                        for f in sorted(d.rglob("*")) if f.suffix[1:].lower() in IMG_FORMATS]
        self.imgsz = imgsz
        self.augment = augment
        self.names = {i: c for c, i in self.class_to_idx.items()}

    def __len__(self) -> int:
        return len(self.samples)

    def get_item(self, i: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        path, label = self.samples[i]
        img = imread(path)
        h, w = img.shape[:2]
        s = self.imgsz
        if self.augment:
            for _ in range(10):  # RandomResizedCrop
                area = h * w * rng.uniform(0.08, 1.0)
                ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
                cw, ch = int(round(np.sqrt(area * ar))), int(round(np.sqrt(area / ar)))
                if 0 < cw <= w and 0 < ch <= h:
                    x0, y0 = int(rng.integers(0, w - cw + 1)), int(rng.integers(0, h - ch + 1))
                    img = img[y0 : y0 + ch, x0 : x0 + cw]
                    break
            img = _resize(img, s, s)
            if rng.random() < 0.5:
                img = np.ascontiguousarray(np.fliplr(img))
            augment_hsv(img, 0.015, 0.4, 0.4, rng)
            if rng.random() < 0.4:  # random erasing
                ew, eh = (rng.uniform(0.05, 0.25, 2) * s).astype(int)
                ex, ey = int(rng.integers(0, s - ew)), int(rng.integers(0, s - eh))
                img[ey : ey + eh, ex : ex + ew] = rng.integers(0, 255, (eh, ew, 3), dtype=np.uint8)
        else:
            r = s / min(h, w)
            img = _resize(img, max(s, int(round(h * r))), max(s, int(round(w * r))))
            hh, ww = img.shape[:2]
            y0, x0 = (hh - s) // 2, (ww - s) // 2
            img = img[y0 : y0 + s, x0 : x0 + s]
        return {"img": np.ascontiguousarray(img[..., ::-1]), "cls": np.int32(label)}


def _resize(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """cv2.resize(img, (nw, nh), INTER_LINEAR) of a uint8 HWC image, as a new C-contiguous array."""
    out = resize_linear_u8(torch.from_numpy(np.ascontiguousarray(img))[None], nh, nw)[0].numpy()
    return np.array(out)  # a copy: the same size comes back as the input itself
