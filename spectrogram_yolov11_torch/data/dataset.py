"""Detection datasets: YOLO-format images and label txts, for validation and training.

Counterpart of spectrogram_yolov11_tpu/data/dataset.py for the detect task:
IMG_FORMATS (:27), img2label_path (:30), check_det_dataset (:42) and
YOLODataset (:126: _find_images with `fraction`, the detect label rows,
single_cls, the automatic max_gt :157-165, load_image with cache="ram",
load_sample :344 with its long-side resize, get_item, close_mosaic :381-389).
Images are read by data/imageio.py (JPEG and PNG, as cv2.imread reads them;
other formats raise NotImplementedError when an image is read) and the label txts are parsed
directly: the JAX package's JSON label cache (:246) is a saving the port does
not have yet (ROADMAP.md item 8), and cache="disk" (.npy sidecars) raises.

augment=False is the val dataset: get_item(i) is the letterbox geometry and
labels of image i, the image left at its own size for the letterbox on the
card (data/augment.py: ValTransform). augment=True is the train dataset in
device-augment mode: get_item(i, rng) is a sample's labels and the
parameters its image is assembled from on the card (TrainTransform).

Dataset YAMLs given by name resolve among the port's own copies under
cfg/datasets/. The synthetic ones point at datasets/torch/..., so the two
packages never read or overwrite each other's stand-ins; Spectrogram.yaml
points at the user's datasets/spectrogram, as the JAX package's copy does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

import torch

from ..utils import not_ported, yaml_load
from .augment import TrainTransform, ValTransform, resize_linear_u8
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
    ceil8(1.1 * most labels of an image * (4 with mosaic))))."""

    def __init__(self, img_path, imgsz: int = 640, max_gt: int = 256, single_cls: bool = False,
                 augment: bool = False, hyp=None, fraction: float = 1.0, cache=False):
        self.img_path = [Path(p) for p in img_path] if isinstance(img_path, (list, tuple)) else Path(img_path)
        self.single_cls = single_cls
        self.augment = augment
        self.im_files = self._find_images(fraction)
        self.label_files = [img2label_path(f) for f in self.im_files]
        self.labels = [self._load_label(f) for f in self.label_files]
        if not max_gt:
            most = max((len(lab["cls"]) for lab in self.labels), default=0) * (4 if augment else 1)
            max_gt = int(min(128, max(32, -(-int(most * 1.1) // 8) * 8)))
        self.max_gt = max_gt
        if cache == "disk":
            raise not_ported("cache='disk' (decoded .npy sidecars)", "item 7 (training data)")
        self.cache_ram = cache in (True, "ram")
        self._im_cache: Dict[int, np.ndarray] = {}
        self.transform = TrainTransform(self, imgsz, hyp, max_gt=max_gt) if augment else ValTransform(imgsz, max_gt)

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

    @staticmethod
    def _parse_row(parts: List[str]) -> Optional[Dict]:
        """One detect label row -> {cls, xywhn}; None for a row with a box of no or too large size."""
        vals = [float(x) for x in parts[1:]]
        if len(vals) >= 4 and 0 < vals[2] <= 1.0001 and 0 < vals[3] <= 1.0001:
            return {"cls": int(float(parts[0])), "xywhn": vals[:4]}
        return None

    def _load_label(self, label_file: str) -> Dict[str, np.ndarray]:
        """{cls (n,) int32, xywhn (n, 4) float32} from a label txt; a missing
        file has no labels, and rows that are short or do not parse are skipped."""
        rows = []
        p = Path(label_file)
        if p.exists():
            for line in p.read_text().splitlines():
                parts = line.split()
                if len(parts) < 5:
                    continue
                try:
                    row = self._parse_row(parts)
                except ValueError:
                    row = None
                if row is not None:
                    rows.append(row)
        return {"cls": np.asarray([r["cls"] for r in rows], np.int32),
                "xywhn": np.asarray([r["xywhn"] for r in rows], np.float32).reshape(-1, 4)}

    def __len__(self) -> int:
        return len(self.im_files)

    def load_image(self, i: int) -> np.ndarray:
        """Image i as BGR uint8 (H, W, 3), kept after its first read with cache="ram"."""
        if self.cache_ram and i in self._im_cache:
            return self._im_cache[i]
        img = imread(self.im_files[i])
        if self.cache_ram:
            self._im_cache[i] = img
        return img

    def load_sample(self, i: int, square_to: Optional[int] = None) -> Dict:
        """Image i and its labels as xyxy pixels; with square_to, the image
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
        return {"img": img, "cls": cls, "bboxes": b}

    def get_item(self, i: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        """Sample i: TrainTransform's with the sample's Generator `rng` when
        augmenting, else the val transform's (which draws nothing)."""
        return self.transform(i, rng) if self.augment else self.transform(self.load_sample(i))

    def close_mosaic(self) -> None:
        if self.augment:
            self.transform.close_mosaic()
