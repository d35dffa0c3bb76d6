"""The port's segment training and validation data against the JAX package's, on the CPU.

- Labels: polygon rows parsed as JAX's YOLODataset(task="segment") parses
  them (the box the polygon's bounds), `segments` in each image's labels,
  the JSON cache `<images dir>.labels.segment.json` written with JAX's bytes
  and read by either package; a detect row in a segment split raises
  KeyError in both.
- format_sample's index-encoded instance mask (int32, imgsz / mask_ratio)
  byte-equal to JAX's over seeded polygons inside and across the image's
  edges, with more than 255 instances.
- mosaic4, random_perspective (boxes re-derived from the warped polygons,
  area threshold 0.01) and random_flip carry the polygons as JAX's do:
  every output array equal.
- copy_paste ('flip' mode, fill_poly for cv2.fillPoly): the image, classes,
  boxes and polygons equal to JAX's over seeded samples.
- The samples: ValTransform (letterbox geometry, labels, `masks`,
  ori_shape, ratio_pad), the host TrainTransform (device_augment=False; the
  general warp; copy_paste=0.5, which also sends 'auto' to the host as
  JAX's blocker does) and the device-mode TrainTransform (labels, masks and
  the card's image parameters), each array-equal to JAX's on 16 seeds with
  mosaic on and 8 after close_mosaic().
- mixup drops the polygons in both packages, and format_sample then raises
  IndexError in both (ROADMAP.md §3.23).
- The shapes-seg kind: shapes128-seg.yaml and coco8-seg.yaml (cut to 3 + 2
  images by a temporary YAML) generate JAX's JPEG bytes and label texts.

Every comparison is exact.
"""

from pathlib import Path

import numpy as np
import pytest
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_torch.data.augment as A
from spectrogram_yolov11_torch.cfg import DEFAULT_CFG_DICT, get_cfg
from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset, find_dataset_yaml
from spectrogram_yolov11_torch.data.imageio import imwrite
from spectrogram_yolov11_tpu.cfg import get_cfg as jax_get_cfg
import spectrogram_yolov11_tpu.data.augment as JA
from spectrogram_yolov11_tpu.data.dataset import YOLODataset as JaxYOLODataset
from spectrogram_yolov11_tpu.data.dataset import check_det_dataset as jax_check_det_dataset
from spectrogram_yolov11_tpu.utils import DEFAULT_CFG

ROOT = Path(__file__).resolve().parent.parent
JAX_YAMLS = ROOT / "spectrogram_yolov11_tpu" / "cfg" / "datasets"
SEG_YAMLS = ("shapes128-seg", "shapes_seg_parity", "coco8-seg", "coco128-seg", "carparts-seg", "crack-seg",
             "package-seg")
IMGSZ = 64
SIZES = ((64, 96), (96, 64), (70, 90), (64, 64))
GENERAL = {"degrees": 10.0, "shear": 3.0, "perspective": 5e-4, "flipud": 0.5}  # 'auto' -> host, warpPerspective
LABEL_KEYS = ("cls", "bboxes", "mask_gt", "masks")
DEVICE_KEYS = (*LABEL_KEYS, "aug_src", "aug_regions", "aug_pads", "aug_inv", "aug_hsv")


def polygon(rng: np.random.Generator, n: int, spread: float = 0.2) -> np.ndarray:
    """A star-shaped polygon of n points, normalised, around a random centre."""
    c = rng.uniform(0.2, 0.8, 2)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(0.3, 1.0, n) * spread
    return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1).clip(0, 1)


def write_seg_split(root: Path, n: int = 8, seed: int = 0) -> str:
    """n colour PNGs of SIZES with polygon label rows (one image without a
    label file, one with an empty one) under root/images and root/labels."""
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        h, w = SIZES[i % len(SIZES)]
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        imwrite(root / "images" / f"{i:03d}.png", img)
        if i == 1:
            continue
        rows = [f"{rng.integers(0, 2)} " + " ".join(f"{v:.6f}" for v in polygon(rng, int(rng.integers(3, 12))).ravel())
                for _ in range(0 if i == 2 else int(rng.integers(1, 6)))]
        (root / "labels" / f"{i:03d}.txt").write_text("\n".join(rows))
    return str(root / "images")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_seg_split(tmp_path_factory.mktemp("seg_data"))


def _same(got, ref, what) -> None:
    if isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref), what
        for g, r in zip(got, ref):
            _same(g, r, what)
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(got, ref), what


def _same_sample(got: dict, ref: dict, keys, what: str) -> None:
    for k in keys:
        assert k in got and k in ref, (what, k)
        _same(got[k], ref[k], (what, k))


# -- labels --------------------------------------------------------------------------

def test_labels_and_cache_equal_jax(split):
    cache = Path(split).with_suffix(".labels.segment.json")
    ours = YOLODataset(split, task="segment")
    port_bytes = cache.read_bytes()
    cache.unlink()
    theirs = JaxYOLODataset(split, nc=2, task="segment")
    assert cache.read_bytes() == port_bytes
    assert [len(lab["segments"]) for lab in ours.labels] == [len(lab["cls"]) for lab in ours.labels]
    for a, b in zip(ours.labels, theirs.labels):
        _same_sample(a, b, ("cls", "xywhn", "segments"), "labels")
    for reader in (lambda: YOLODataset(split, task="segment"), lambda: JaxYOLODataset(split, nc=2, task="segment")):
        again = reader()
        assert cache.read_bytes() == port_bytes
        for a, b in zip(again.labels, ours.labels):
            _same_sample(a, b, ("cls", "xywhn", "segments"), "cache")
    for i in range(len(ours)):
        _same_sample(ours.load_sample(i), theirs.load_sample(i), ("img", "cls", "bboxes", "segments"), f"sample {i}")


def test_a_detect_row_in_a_segment_split_raises_as_jax(tmp_path):
    img_dir = write_seg_split(tmp_path, n=3)
    (tmp_path / "labels" / "000.txt").write_text("0 0.5 0.5 0.2 0.2\n")
    for make in (lambda: YOLODataset(img_dir, task="segment"), lambda: JaxYOLODataset(img_dir, nc=2, task="segment")):
        Path(img_dir).with_suffix(".labels.segment.json").unlink(missing_ok=True)
        with pytest.raises(KeyError):
            make()


# -- the label ops -----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_format_sample_mask_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 400 if seed == 0 else int(rng.integers(1, 12))  # more instances than a uint8 holds
    h, w = SIZES[seed]
    segs = [(polygon(rng, int(rng.integers(3, 20)), spread=0.6) * [w * 1.3, h * 1.3] - [w * 0.15, h * 0.15])
            .astype(np.float32) for _ in range(n)]  # some across the edges
    boxes = np.stack([np.concatenate([p.min(0), p.max(0)]) for p in segs]).astype(np.float32)
    boxes[::5, 2] = boxes[::5, 0]  # zero-width boxes: dropped with their polygons
    sample = {"img": rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "cls": rng.integers(0, 3, n).astype(np.int32),
              "bboxes": boxes, "segments": segs}
    for ratio in (4, 2):
        got = A.format_sample(dict(sample), IMGSZ, 512, "segment", ratio)
        ref = JA.format_sample(dict(sample), IMGSZ, 512, task="segment", mask_ratio=ratio)
        _same_sample(got, ref, ("img", *LABEL_KEYS), f"seed {seed} ratio {ratio}")
        assert got["masks"].shape == (IMGSZ // ratio,) * 2 and got["masks"].max() > (255 if seed == 0 else 0)


def _labelled(rng: np.random.Generator, h: int, w: int, n: int) -> dict:
    segs = [(polygon(rng, int(rng.integers(3, 12))) * [w, h]).astype(np.float32) for _ in range(n)]
    boxes = np.stack([np.concatenate([p.min(0), p.max(0)]) for p in segs]).astype(np.float32) if n else \
        np.zeros((0, 4), np.float32)
    return {"img": rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "cls": rng.integers(0, 2, n).astype(np.int32),
            "bboxes": boxes, "segments": segs}


@pytest.mark.parametrize("seed", range(6))
def test_mosaic_warp_and_flip_carry_polygons_as_jax(seed):
    rng = np.random.default_rng(seed)
    samples = [_labelled(rng, IMGSZ, IMGSZ - 8 * (i % 2), int(rng.integers(0, 4))) for i in range(4)]
    got = A.mosaic4([dict(s) for s in samples], IMGSZ, np.random.default_rng(seed), compose_image=True)
    ref = JA.mosaic4([dict(s) for s in samples], IMGSZ, np.random.default_rng(seed))
    _same_sample(got, ref, ("img", "cls", "bboxes", "segments"), "mosaic")
    border = got.pop("mosaic_border")
    ref.pop("mosaic_border")
    hyp = dict(degrees=15.0, translate=0.1, scale=0.5, shear=5.0, perspective=1e-3 if seed % 2 else 0.0)
    got = A.random_perspective(got, **hyp, border=border, rng=np.random.default_rng(seed), warp_image=True)
    ref = JA.random_perspective(ref, **hyp, border=border, rng=np.random.default_rng(seed))
    _same_sample(got, ref, ("img", "cls", "bboxes", "segments"), "warp")
    assert len(ref["segments"]) == len(ref["bboxes"])
    got = A.random_flip(got, 0.5, 0.5, np.random.default_rng(seed + 7), flip_image=True)
    ref = JA.random_flip(ref, 0.5, 0.5, rng=np.random.default_rng(seed + 7))
    _same_sample(got, ref, ("img", "cls", "bboxes", "segments"), "flip")


@pytest.mark.parametrize("seed", range(8))
def test_copy_paste_equals_jax(seed):
    rng = np.random.default_rng(seed)
    sample = _labelled(rng, 48 + 8 * (seed % 3), 64, int(rng.integers(1, 7)))
    p = (0.5, 1.0, 0.3, 0.0)[seed % 4]
    got = A.copy_paste(dict(sample), p, np.random.default_rng(seed))
    ref = JA.copy_paste(dict(sample), p=p, rng=np.random.default_rng(seed))
    _same_sample(got, ref, ("img", "cls", "bboxes", "segments"), f"seed {seed}")


def test_mixup_drops_polygons_and_raises_as_jax():
    rng = np.random.default_rng(0)
    a, b = _labelled(rng, IMGSZ, IMGSZ, 2), _labelled(rng, IMGSZ, IMGSZ, 1)
    for mix, fmt in ((A.mixup, lambda s: A.format_sample(s, IMGSZ, 8, "segment")),
                     (JA.mixup, lambda s: JA.format_sample(s, IMGSZ, 8, task="segment"))):
        mixed = mix(dict(a), dict(b), np.random.default_rng(1))
        assert "segments" not in mixed
        with pytest.raises(IndexError):
            fmt(mixed)


# -- the samples -------------------------------------------------------------------------

def test_val_samples_equal_jax(split):
    port = YOLODataset(split, imgsz=IMGSZ, max_gt=16, task="segment")
    ref = JaxYOLODataset(split, imgsz=IMGSZ, nc=2, max_gt=16, task="segment")
    for i in range(len(port)):
        got, want = port.get_item(i), ref.get_item(i, None)
        _same_sample(got, want, (*LABEL_KEYS, "ori_shape", "ratio_pad"), f"image {i}")
        assert got["masks"].shape == (IMGSZ // 4, IMGSZ // 4)


def _train_datasets(img_dir: str, device: bool, **hyp):
    port = YOLODataset(img_dir, imgsz=IMGSZ, max_gt=0, augment=True, task="segment",
                       hyp=get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **hyp}))
    ref = JaxYOLODataset(img_dir, imgsz=IMGSZ, augment=True, hyp=jax_get_cfg(DEFAULT_CFG, hyp), nc=2, max_gt=0,
                         task="segment", device_augment=device)
    assert port.transform.device_mode == ref.transform.device_mode == device
    return port, ref


@pytest.mark.parametrize("hyp,device", [({"device_augment": False}, False), (GENERAL, False),
                                        ({"copy_paste": 0.5}, False), ({}, True)],
                         ids=["host_default", "host_general_warp", "copy_paste_host", "device"])
def test_train_samples_equal_jax(split, hyp, device, monkeypatch):
    pasted = []
    paste = A.copy_paste
    monkeypatch.setattr(A, "copy_paste", lambda s, p, rng: pasted.append(1) or paste(s, p, rng))
    port, ref = _train_datasets(split, device, **hyp)
    keys = DEVICE_KEYS if device else ("img", *LABEL_KEYS)
    for phase, seeds in (("mosaic", range(16)), ("closed", range(8))):
        if phase == "closed":
            port.close_mosaic()
            ref.close_mosaic()
        for seed in seeds:
            i = seed % len(port)
            got = port.get_item(i, np.random.default_rng(seed))
            _same_sample(got, ref.get_item(i, np.random.default_rng(seed)), keys, f"{phase} seed {seed}")
            assert got["masks"].shape == (IMGSZ // 4, IMGSZ // 4)
    assert len(pasted) == (24 if hyp.get("copy_paste") else 0)


# -- the shapes-seg kind ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["shapes128-seg.yaml", "coco8-seg.yaml"])
def test_shapes_seg_kind_writes_jax_files(name, tmp_path):
    text = (JAX_YAMLS / name).read_text()
    files = {}
    for who, check in (("jax", jax_check_det_dataset), ("port", check_det_dataset)):
        yml = tmp_path / f"{who}.yaml"
        lines = [ln for ln in text.splitlines() if not ln.startswith(("path:", "n_train:", "n_val:"))]
        yml.write_text("\n".join([f"path: {tmp_path / who}", "n_train: 3", "n_val: 2", *lines]) + "\n")
        assert check(str(yml))["nc"] == (80 if name == "coco8-seg.yaml" else 2)
        files[who] = {str(p.relative_to(tmp_path / who)): p.read_bytes()
                      for p in sorted((tmp_path / who).rglob("*")) if p.suffix in (".jpg", ".txt")}
    assert len(files["port"]) == 10 and files["port"] == files["jax"]


def test_segment_dataset_yamls_are_jax_copies():
    for stem in SEG_YAMLS:
        path = find_dataset_yaml(f"{stem}.yaml")
        assert path.parent.parent.parent.name == "spectrogram_yolov11_torch"
        assert path.read_text() == (JAX_YAMLS / f"{stem}.yaml").read_text()
