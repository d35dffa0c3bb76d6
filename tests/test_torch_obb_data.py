"""The port's OBB data against cv2's and the JAX package's, on the CPU.

- min_area_rect against cv2.minAreaRect (OpenCV 5.0.0) on 300 exact
  rectangles (cv2.boxPoints corners), 300 warped quads and 100
  near-degenerate ones (slivers, collinear and repeated points): the same
  convention (angle in [-90, 0) degrees, `w` the side along it), the centre
  and size within 1e-5 relative of max(|value|, 1) and the angle within
  1e-4 degrees, cv2's own float32 rounding (measured: centre 3.4e-6, size
  1.0e-6, angle 3.4e-5 degrees; the port computes the exact rectangle of
  the float32 hull in float64 and rounds once). Where
  cv2's rounding makes it return the other of two rectangles whose areas
  agree to its rounding (22 of the 300 warped quads, nearly rectangles), the
  areas agree within 1e-6 relative (ROADMAP.md §3.39).
- xyxyxyxy2xywhr within 1e-5 of JAX's (cv2's rectangle, radians) on the
  exact rectangles; box_points equal to cv2.boxPoints as float32 and after
  astype(int32), on 2,000 seeded boxes of any size and angle.
- The shapes-obb kind: shapes128-obb.yaml (2 classes) and dota8.yaml (15,
  320 px), cut to 3 + 2 images by a temporary YAML, write JAX's JPEG bytes
  and label texts; the four OBB dataset YAMLs are JAX's copies.
- Labels: OBB rows (`cls x1 y1 ... x4 y4`) parsed as JAX's YOLODataset(task=
  "obb") parses them, the polygon kept as `segments` and the box its
  bounds; the JSON cache `<images dir>.labels.obb.json` written with JAX's
  bytes and read by either package; a detect row in an obb split raises
  KeyError in both.
- format_sample's OBB branch (the rectangle of each polygon, sides under 2
  px dropped, the long side first, the angle wrapped into [-pi/2, pi/2)),
  in host and device mode: cls and mask_gt equal to JAX's, the rotated boxes
  within 1e-5 (normalised cx, cy, w, h) and 1e-5 rad.
- The samples: ValTransform, the host TrainTransform (device_augment=False;
  the general warp; copy_paste 0.5, which also sends device mode to the
  host) and the device-mode TrainTransform (labels and the card's image
  parameters), on 8 seeds with mosaic on and 4 after close_mosaic(): every
  image array and the classes and masks equal to JAX's, the boxes as above.
- mixup on an OBB split raises IndexError in both packages (ROADMAP.md §3.37).
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_torch.data.augment as A
from spectrogram_yolov11_torch.cfg import DEFAULT_CFG_DICT, get_cfg
from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset, find_dataset_yaml
from spectrogram_yolov11_torch.data.imageio import imwrite
from spectrogram_yolov11_torch.ops.boxes import box_points, min_area_rect, xyxyxyxy2xywhr
import spectrogram_yolov11_tpu.data.augment as JA
from spectrogram_yolov11_tpu.cfg import get_cfg as jax_get_cfg
from spectrogram_yolov11_tpu.data.dataset import YOLODataset as JaxYOLODataset
from spectrogram_yolov11_tpu.data.dataset import check_det_dataset as jax_check_det_dataset
from spectrogram_yolov11_tpu.utils import DEFAULT_CFG

ROOT = Path(__file__).resolve().parent.parent
JAX_YAMLS = ROOT / "spectrogram_yolov11_tpu" / "cfg" / "datasets"
OBB_YAMLS = ("shapes128-obb", "dota8", "DOTAv1", "DOTAv1.5")
IMGSZ = 64
SIZES = ((64, 96), (96, 64), (70, 90), (64, 64))
GENERAL = {"degrees": 10.0, "shear": 3.0, "perspective": 5e-4, "flipud": 0.5}  # 'auto' -> host, warpPerspective
BOX_TOL = 1e-5  # normalised cx, cy, w, h and the angle in radians, against JAX's (cv2.minAreaRect's rounding)


def _same(got, ref, what) -> None:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(got, ref), what


def _same_sample(got: dict, ref: dict, keys, what: str) -> None:
    for k in keys:
        assert k in got and k in ref, (what, k)
        if k == "bboxes":
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, (what, k)
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=BOX_TOL, err_msg=f"{what} {k}")
        else:
            _same(got[k], ref[k], (what, k))


# -- min_area_rect and box_points against cv2 ---------------------------------------

def _quads() -> dict:
    rng = np.random.default_rng(0)
    exact, warped, degenerate = [], [], []
    for _ in range(300):
        c, wh, a = rng.uniform(10, 600, 2), rng.uniform(1, 200, 2), rng.uniform(-180, 180)
        exact.append(cv2.boxPoints(((c[0], c[1]), (wh[0], wh[1]), a)))
        q = cv2.boxPoints(((c[0], c[1]), (wh[0], wh[1]), a)) + rng.normal(0, 0.05 * wh.min() + 0.5, (4, 2))
        warped.append(q.astype(np.float32))
    for i in range(100):
        p0, d = rng.uniform(0, 300, 2), rng.normal(0, 50, 2)
        t = np.sort(rng.uniform(0, 1, 4))
        q = p0 + t[:, None] * d
        if i % 4 == 1:
            q = q + rng.normal(0, 0.01, q.shape)  # a sliver
        elif i % 4 == 2:
            q[2:] = q[:2]  # repeated points
        elif i % 4 == 3:
            q = np.round(q)  # integer, often collinear
        degenerate.append(q.astype(np.float32))
    return {"exact": exact, "warped": warped, "degenerate": degenerate}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1.0)


@pytest.mark.parametrize("kind", ["exact", "warped", "degenerate"])
def test_min_area_rect_matches_cv2(kind):
    other, worst = 0, [0.0, 0.0, 0.0]
    quads = _quads()[kind]
    for q in quads:
        (cx, cy), (w, h), ang = min_area_rect(q)
        (rx, ry), (rw, rh), rang = cv2.minAreaRect(q)
        assert -90.0 <= ang < 0.0 and all(isinstance(v, float) for v in (cx, cy, w, h, ang))
        assert all(float(np.float32(v)) == v for v in (cx, cy, w, h, ang))
        if abs(ang - rang) > 1e-4:
            other += 1  # cv2 returned the other rectangle of a near-tie: the areas agree
            assert _rel(w * h, rw * rh) <= 1e-6, (q.tolist(), (w, h, ang), (rw, rh, rang))
            continue
        worst = [max(worst[0], _rel(cx, rx), _rel(cy, ry)), max(worst[1], _rel(w, rw), _rel(h, rh)),
                 max(worst[2], abs(ang - rang))]
        assert worst[0] <= 1e-5 and worst[1] <= 1e-5 and worst[2] <= 1e-4, (q.tolist(), (cx, cy, w, h, ang),
                                                                           (rx, ry, rw, rh, rang))
    print(f"{kind}: worst centre, size (relative), angle (degrees) {worst}; the other rectangle {other}")
    assert other <= (0.1 * len(quads) if kind == "warped" else 0)


def test_xyxyxyxy2xywhr_matches_jax():
    """JAX's xyxyxyxy2xywhr (cv2.minAreaRect, the angle in radians) on the exact rectangles: within 1e-5 relative."""
    from spectrogram_yolov11_tpu.ops.boxes import xyxyxyxy2xywhr as jax_xyxyxyxy2xywhr

    corners = np.stack(_quads()["exact"])
    got, ref = xyxyxyxy2xywhr(corners.reshape(-1, 8)), jax_xyxyxyxy2xywhr(corners)
    assert got.dtype == ref.dtype == np.float32 and got.shape == (300, 5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_box_points_equal_cv2():
    rng = np.random.default_rng(1)
    for _ in range(2000):
        c, wh, a = rng.uniform(-50, 700, 2), rng.uniform(0, 300, 2), rng.uniform(-360, 360)
        rect = ((c[0], c[1]), (wh[0], wh[1]), a)
        got, ref = box_points(rect), cv2.boxPoints(rect)
        assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref), rect
        assert np.array_equal(got.astype(np.int32), ref.astype(np.int32))


# -- the shapes-obb kind and the YAMLs ---------------------------------------------

@pytest.mark.parametrize("name", ["shapes128-obb.yaml", "dota8.yaml"])
def test_shapes_obb_kind_writes_jax_files(name, tmp_path):
    text = (JAX_YAMLS / name).read_text()
    files = {}
    for who, check in (("jax", jax_check_det_dataset), ("port", check_det_dataset)):
        yml = tmp_path / f"{who}.yaml"
        lines = [ln for ln in text.splitlines() if not ln.startswith(("path:", "n_train:", "n_val:"))]
        yml.write_text("\n".join([f"path: {tmp_path / who}", "n_train: 3", "n_val: 2", *lines]) + "\n")
        assert check(str(yml))["nc"] == {"shapes128-obb.yaml": 2, "dota8.yaml": 15}[name]
        files[who] = {str(p.relative_to(tmp_path / who)): p.read_bytes()
                      for p in sorted((tmp_path / who).rglob("*")) if p.suffix in (".jpg", ".txt")}
    assert len(files["port"]) == 10 and files["port"] == files["jax"]
    rows = [ln.split() for k, v in files["port"].items() if k.endswith(".txt") for ln in v.decode().splitlines()]
    assert rows and all(len(r) == 9 for r in rows)


def test_obb_dataset_yamls_are_jax_copies():
    for stem in OBB_YAMLS:
        path = find_dataset_yaml(f"{stem}.yaml")
        assert path.parent.parent.parent.name == "spectrogram_yolov11_torch"
        assert path.read_text() == (JAX_YAMLS / f"{stem}.yaml").read_text()


# -- labels --------------------------------------------------------------------------

def obb_row(rng: np.random.Generator) -> str:
    """`cls` and 4 normalised corners of a rotated rectangle (some past the image's edge)."""
    pts = cv2.boxPoints(((rng.uniform(0.15, 0.85), rng.uniform(0.15, 0.85)),
                         (rng.uniform(0.08, 0.5), rng.uniform(0.05, 0.3)), rng.uniform(0, 180)))
    return f"{rng.integers(0, 2)} " + " ".join(f"{v:.6f}" for v in pts.reshape(-1))


def write_obb_split(root: Path, n: int = 8, seed: int = 0, detect_row: bool = False) -> str:
    """n colour PNGs of SIZES with OBB label rows (one image without a label
    file, one with an empty one) under root/images and root/labels."""
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        h, w = SIZES[i % len(SIZES)]
        imwrite(root / "images" / f"{i:03d}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        if i == 1:
            continue
        rows = [obb_row(rng) for _ in range(0 if i == 2 else int(rng.integers(1, 5)))]
        if detect_row and i == 3:
            rows.append("0 0.5 0.5 0.2 0.2")
        (root / "labels" / f"{i:03d}.txt").write_text("\n".join(rows))
    return str(root / "images")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_obb_split(tmp_path_factory.mktemp("obb_data"))


def test_labels_and_cache_equal_jax(tmp_path):
    img_dir = write_obb_split(tmp_path)
    cache = Path(img_dir).with_suffix(".labels.obb.json")
    ours = YOLODataset(img_dir, task="obb")
    port_bytes = cache.read_bytes()
    cache.unlink()
    theirs = JaxYOLODataset(img_dir, nc=2, task="obb")
    assert cache.read_bytes() == port_bytes
    assert sum(len(lab["cls"]) for lab in ours.labels) > 10
    for a, b in zip(ours.labels, theirs.labels):
        _same_sample(a, b, ("cls", "xywhn"), "labels")
        assert len(a["segments"]) == len(b["segments"]) == len(a["cls"])
        for p, q in zip(a["segments"], b["segments"]):
            _same(p, q, "polygon")
            assert p.shape == (4, 2)
    for reader in (lambda: YOLODataset(img_dir, task="obb"), lambda: JaxYOLODataset(img_dir, nc=2, task="obb")):
        for a, b in zip(reader().labels, ours.labels):
            _same_sample(a, b, ("cls", "xywhn"), "cache")
        assert cache.read_bytes() == port_bytes
    for i in range(len(ours)):
        got, ref = ours.load_sample(i), theirs.load_sample(i)
        _same_sample(got, ref, ("img", "cls", "bboxes"), f"sample {i}")
        for p, q in zip(got["segments"], ref["segments"]):
            _same(p, q, f"sample {i} polygon")


def test_a_detect_row_in_an_obb_split_raises_as_jax(tmp_path):
    img_dir = write_obb_split(tmp_path, detect_row=True)
    for make in (lambda: YOLODataset(img_dir, task="obb"), lambda: JaxYOLODataset(img_dir, nc=2, task="obb")):
        with pytest.raises(KeyError, match="seg"):
            make()
        Path(img_dir).with_suffix(".labels.obb.json").unlink(missing_ok=True)


# -- format_sample and the samples ---------------------------------------------------

def _obb_sample(rng: np.random.Generator, h: int, w: int, n: int) -> dict:
    """n rotated rectangles (some under 2 px on a side), every other one sheared into a parallelogram, as
    the warps leave them."""
    polys = []
    for j in range(n):
        wh = (rng.uniform(1, 25), rng.uniform(1, 25)) if j % 3 else (rng.uniform(4, 25), rng.uniform(4, 25))
        c = (rng.uniform(0, w), rng.uniform(0, h))
        q = cv2.boxPoints((c, wh, rng.uniform(0, 180)))
        if j % 2:
            q = (q - c) @ np.array([[1.0, 0.0], [rng.uniform(-0.4, 0.4), 1.0]]) + c
        polys.append(q.astype(np.float32))
    boxes = np.asarray([np.concatenate([p.min(0), p.max(0)]) for p in polys], np.float32).reshape(-1, 4)
    return {"img": rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "cls": rng.integers(0, 2, n).astype(np.int32),
            "bboxes": boxes, "segments": polys}


@pytest.mark.parametrize("seed", range(4))
def test_format_sample_equals_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = SIZES[seed]
    sample = _obb_sample(rng, h, w, int(rng.integers(3, 12)))
    got = A.format_sample(dict(sample), IMGSZ, 10, "obb")
    ref = JA.format_sample(dict(sample), IMGSZ, 10, task="obb")
    _same_sample(got, ref, ("img", "cls", "bboxes", "mask_gt"), f"seed {seed}")
    b = got["bboxes"][got["mask_gt"]]
    assert got["bboxes"].shape == (10, 5) and len(b) >= 2 and (b[:, 2] * w >= b[:, 3] * h).all()  # long side first
    assert ((b[:, 4] >= -np.pi / 2) & (b[:, 4] < np.pi / 2)).all()
    dev = {k: v for k, v in sample.items() if k != "img"}  # device mode: normalised by img_shape
    got = A.format_sample(dict(dev, img_shape=(h, w)), IMGSZ, 10, "obb")
    ref = JA.format_sample(dict(dev, img=None, img_shape=(h, w)), IMGSZ, 10, task="obb")
    _same_sample(got, ref, ("cls", "bboxes", "mask_gt"), f"seed {seed}, device mode")


def test_mixup_on_obb_raises_as_jax():
    rng = np.random.default_rng(0)
    a, b = _obb_sample(rng, IMGSZ, IMGSZ, 2), _obb_sample(rng, IMGSZ, IMGSZ, 1)
    for mix, fmt in ((A.mixup, lambda s: A.format_sample(s, IMGSZ, 8, "obb")),
                     (JA.mixup, lambda s: JA.format_sample(s, IMGSZ, 8, task="obb"))):
        mixed = mix(dict(a), dict(b), np.random.default_rng(1))
        assert "segments" not in mixed
        with pytest.raises(IndexError):
            fmt(mixed)


def test_val_samples_equal_jax(split):
    port = YOLODataset(split, imgsz=IMGSZ, max_gt=16, task="obb")
    ref = JaxYOLODataset(split, imgsz=IMGSZ, nc=2, max_gt=16, task="obb")
    for i in range(len(port)):
        got = port.get_item(i)
        _same_sample(got, ref.get_item(i, None), ("cls", "bboxes", "mask_gt", "ori_shape", "ratio_pad"), f"image {i}")
        assert got["bboxes"].shape == (16, 5)


@pytest.mark.parametrize("hyp,device", [({"device_augment": False}, False), (GENERAL, False),
                                        ({"copy_paste": 0.5}, False), ({}, True)],
                         ids=["host_default", "host_general_warp", "host_copy_paste", "device"])
def test_train_samples_equal_jax(split, hyp, device):
    port = YOLODataset(split, imgsz=IMGSZ, max_gt=0, augment=True, task="obb",
                       hyp=get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **hyp}))
    ref = JaxYOLODataset(split, imgsz=IMGSZ, augment=True, hyp=jax_get_cfg(DEFAULT_CFG, hyp), nc=2, max_gt=0,
                         task="obb", device_augment=device or "copy_paste" in hyp)
    assert port.transform.device_mode == ref.transform.device_mode == device
    keys = ("cls", "bboxes", "mask_gt", *(("aug_src", "aug_regions", "aug_pads", "aug_inv", "aug_hsv") if device
                                          else ("img",)))
    n_boxes = 0
    for phase, seeds in (("mosaic", range(8)), ("closed", range(4))):
        if phase == "closed":
            port.close_mosaic()
            ref.close_mosaic()
        for seed in seeds:
            i = seed % len(port)
            got = port.get_item(i, np.random.default_rng(seed))
            _same_sample(got, ref.get_item(i, np.random.default_rng(seed)), keys, f"{phase} seed {seed}")
            assert got["bboxes"].shape == (port.max_gt, 5)
            n_boxes += int(got["mask_gt"].sum())
    assert n_boxes > 10
