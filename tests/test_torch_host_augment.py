"""The port's host augmentation and the rest of its detect training data, against cv2 and the JAX package on the CPU.

- Warps: data/warp.py's warp_affine_u8 and warp_perspective_u8 (csrc/warp.cpp)
  and their numpy twins array-equal to cv2.warpAffine / cv2.warpPerspective
  (OpenCV 5.0.0 here) at border 114, on 240 seeded matrices of JAX's form T @
  S @ R @ P @ C (rotations to 45 degrees, scales 0.5-1.5, shears to 10
  degrees, translations past the edges, the mosaic's -S/2 border, perspective
  to 1e-3) over images of odd sizes.
- HSV: bgr_to_hsv_u8 over all 2^24 BGR triples (one 4096 x 4096 image) and
  hsv_to_bgr_u8 over all 180 x 256 x 256 valid HSV triples, in rows of 256
  (OpenCV's vector blocks) and of 1 (its scalar tail), equal to cv2.cvtColor;
  the twins over the same triples; the port's augment_hsv equal to JAX's on
  50 seeded gain draws.
- ellipse_filled and fill_poly (utils/plotting.py) equal to cv2.ellipse(-1)
  and cv2.fillPoly on 200 seeded shapes, degenerate ones among them.
- The committed digests (tests/torch_data/host_augment/cv2_digests.json:
  seeded inputs and the SHA-256 of cv2's outputs, which chip_smoke.py holds
  the card machine's build to, as it has no cv2) still equal cv2's and the
  port's. Run as a script, the file rewrites them
  (`PYTHONPATH=. python tests/test_torch_host_augment.py`).
- Host TrainTransform: the port's samples against JAX's
  TrainTransform(device_mode=False) on tests/test_torch_train_data.py's
  split, array-equal in img, cls, bboxes and mask_gt: 24 seeds with mosaic
  on and 24 after close_mosaic(), at device_augment=False, at degrees, shear
  and perspective under 'auto' (warpPerspective), and at mixup=0.5; the
  train DataLoader at B = 3 over two epochs.
- multi_scale: resize_linear_u8 equal to JAX's _resize_uint8_batch at every
  ladder size for S = 64 and 640, and a 2-step port training draws the
  sizes JAX's loop draws (with device_augment=True it warns and draws none).
- cache="disk": each package reads the other's .npy sidecars; a truncated
  one is rewritten; a failed write warns and runs uncached.
- The shapes kind: coco8.yaml and shapes128.yaml (cut to 4 + 2 images by a
  temporary YAML) generate the JPEG bytes and label texts JAX's
  maybe_generate writes; the detect dataset YAMLs resolve by name.
"""

import hashlib
import json
import math
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from test_torch_train_data import IMGSZ, write_split
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_torch.data.augment as port_augment
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.cfg import DEFAULT_CFG_DICT, get_cfg
from spectrogram_yolov11_torch.data import warp
from spectrogram_yolov11_torch.data.augment import augment_hsv, resize_linear_u8
from spectrogram_yolov11_torch.data.build import DataLoader
from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset, find_dataset_yaml
from spectrogram_yolov11_torch.data.imageio import imread
from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer
from spectrogram_yolov11_torch.utils import yaml_load
from spectrogram_yolov11_torch.utils.plotting import ellipse_filled, fill_poly
from spectrogram_yolov11_tpu.cfg import get_cfg as jax_get_cfg
from spectrogram_yolov11_tpu.data.augment import augment_hsv as jax_augment_hsv
from spectrogram_yolov11_tpu.data.build import DataLoader as JaxDataLoader
from spectrogram_yolov11_tpu.data.dataset import YOLODataset as JaxYOLODataset
from spectrogram_yolov11_tpu.data.dataset import check_det_dataset as jax_check_det_dataset
from spectrogram_yolov11_tpu.engine.trainer import _resize_uint8_batch
from spectrogram_yolov11_tpu.utils import DEFAULT_CFG

ROOT = Path(__file__).resolve().parent.parent
DIGESTS = Path(__file__).resolve().parent / "torch_data" / "host_augment" / "cv2_digests.json"
JAX_YAMLS = ROOT / "spectrogram_yolov11_tpu" / "cfg" / "datasets"
DETECT_YAMLS = ("Argoverse", "CarPK", "GlobalWheat2020", "Objects365", "RSOD", "SKU-110K", "VOC", "VisDrone",
                "african-wildlife", "brain-tumor", "coco", "coco128", "coco8", "lvis", "medical-pills",
                "open-images-v7", "shapes128", "signature", "xView", "yolo_params", "Spectrogram_lap")
KEYS = ("img", "cls", "bboxes", "mask_gt")
GENERAL = {"degrees": 10.0, "shear": 3.0, "perspective": 5e-4, "flipud": 0.5}  # 'auto' -> host, warpPerspective


def warp_matrix(rng: np.random.Generator, in_h: int, in_w: int, border: int, perspective: float) -> np.ndarray:
    """A forward matrix of JAX's random_perspective form T @ S @ R @ P @ C."""
    h, w = in_h + 2 * border, in_w + 2 * border
    C = np.eye(3)
    C[0, 2], C[1, 2] = -in_w / 2, -in_h / 2
    P = np.eye(3)
    P[2, :2] = rng.uniform(-perspective, perspective, 2)
    R = np.eye(3)
    R[:2] = cv2.getRotationMatrix2D((0, 0), rng.uniform(-45, 45), rng.uniform(0.5, 1.5))
    S = np.eye(3)
    S[0, 1], S[1, 0] = (math.tan(v * math.pi / 180) for v in rng.uniform(-10, 10, 2))
    T = np.eye(3)
    T[0, 2], T[1, 2] = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
    return T @ S @ R @ P @ C


def warp_case(seed: int, perspective: bool):
    """(image, M, dsize) of seed: odd sizes; every 4th a mosaic canvas (2S x 2S
    into S x S, border -S/2)."""
    rng = np.random.default_rng(seed)
    if seed % 4 == 0:
        s = int(rng.integers(8, 60)) * 2 + 1
        in_h = in_w = 2 * s
        border = -(s // 2)
    else:
        in_h, in_w = (int(v) * 2 + 1 for v in rng.integers(2, 75, 2))
        border = 0
    img = rng.integers(0, 256, (in_h, in_w, 3), dtype=np.uint8)
    M = warp_matrix(rng, in_h, in_w, border, 1e-3 * rng.random() if perspective else 0.0)
    dsize = (in_w + 2 * border, in_h + 2 * border) if seed % 2 else tuple(int(v) for v in rng.integers(5, 160, 2))
    return img, M, dsize


@pytest.mark.parametrize("kind", ["affine", "perspective"])
def test_warps_equal_cv2(kind):
    for seed in range(120):
        img, M, dsize = warp_case(seed, kind == "perspective")
        if kind == "affine":
            want = cv2.warpAffine(img, M[:2], dsize, borderValue=(114, 114, 114))
            got, twin = warp.warp_affine_u8(img, M, dsize), warp.warp_affine_np(img, M, dsize)
        else:
            want = cv2.warpPerspective(img, M, dsize, borderValue=(114, 114, 114))
            got, twin = warp.warp_perspective_u8(img, M, dsize), warp.warp_perspective_np(img, M, dsize)
        assert np.array_equal(got, want) and np.array_equal(twin, want), (kind, seed)


def all_bgr() -> np.ndarray:
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)


def all_hsv(width: int) -> np.ndarray:
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    return np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, width, 3)


def test_hsv_conversions_equal_cv2_over_every_triple():
    img = all_bgr()
    want = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    assert np.array_equal(warp.bgr_to_hsv_u8(img), want)
    assert all(np.array_equal(warp.bgr_to_hsv_np(img[r : r + 512]), want[r : r + 512]) for r in range(0, 4096, 512))
    for width in (256, 1):  # rows of OpenCV's 32-pixel vector blocks, and rows that are all scalar tail
        hsv = all_hsv(width)
        assert np.array_equal(warp.hsv_to_bgr_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)), width
    hsv = all_hsv(45)  # one block and a tail of 13 per row: the twin over every triple, both roundings
    want = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    n = len(hsv) // 8
    assert all(np.array_equal(warp.hsv_to_bgr_np(hsv[r : r + n]), want[r : r + n]) for r in range(0, len(hsv), n))


def test_augment_hsv_equals_jax():
    for seed in range(50):
        rng = np.random.default_rng(seed)
        img = rng.integers(0, 256, (int(rng.integers(1, 70)), int(rng.integers(1, 70)), 3), dtype=np.uint8)
        gains = (0.015, 0.7, 0.4) if seed % 2 else tuple(rng.uniform(0, 1, 3))  # JAX's defaults, and hue wraps
        want = jax_augment_hsv(img.copy(), *gains, rng=np.random.default_rng(seed))
        assert np.array_equal(augment_hsv(img.copy(), *gains, np.random.default_rng(seed)), want), seed
        luts = np.random.default_rng(seed).uniform(-1, 1, 3) * gains + 1
        x = np.arange(256.0)
        luts = np.stack([(x * luts[0]) % 180, np.clip(x * luts[1], 0, 255), np.clip(x * luts[2], 0, 255)])
        assert np.array_equal(warp.augment_hsv_np(img, luts.astype(np.uint8)), want), seed
    img = np.zeros((3, 3, 3), np.uint8)
    assert augment_hsv(img, 0, 0, 0, np.random.default_rng(0)) is img  # no gains: no draw, no change


def shape_case(seed: int):
    """(canvas, kind, args) of seed: ellipses (centres partly outside, axes 0,
    1, 2 and up) and polygons inside the image (the generator's
    triangles, 2-7 random vertices: collinear, repeated, self-intersecting)."""
    rng = np.random.default_rng(seed)
    s = int(rng.integers(8, 120))
    canvas = rng.integers(0, 256, (s, s, 3), dtype=np.uint8)
    color = tuple(int(c) for c in rng.integers(0, 256, 3))
    if seed % 2 == 0:
        axes = tuple(int(v) for v in (rng.integers(0, 3, 2) if seed % 10 == 0 else rng.integers(0, s // 2 + 2, 2)))
        center = tuple(int(v) for v in rng.integers(-s // 4, s + s // 4, 2))
        return canvas, "ellipse", (center, axes, color)
    if seed % 3 == 0:
        w, h = (int(v) for v in rng.integers(0, s // 2, 2))
        x1, y1 = int(rng.integers(0, s - w)), int(rng.integers(0, s - h))
        pts = [[x1 + w // 2, y1], [x1, y1 + h], [x1 + w, y1 + h]]
    elif seed % 7 == 1:
        p, q = rng.integers(0, s, 2), rng.integers(0, s, 2)
        pts = [list(p), list((p + q) // 2), list(q)]  # collinear
    else:
        pts = rng.integers(0, s, (int(rng.integers(2, 8)), 2)).tolist()
    return canvas, "poly", (np.asarray(pts, np.int32), color)


def draw(canvas: np.ndarray, kind: str, args, port: bool) -> np.ndarray:
    img = canvas.copy()
    if kind == "ellipse":
        center, axes, color = args
        return ellipse_filled(img, center, axes, color) if port else cv2.ellipse(img, center, axes, 0, 0, 360,
                                                                                  color, -1)
    pts, color = args
    return fill_poly(img, pts, color) if port else cv2.fillPoly(img, [pts], color)


def test_ellipse_and_polygon_fills_equal_cv2():
    for seed in range(200):
        canvas, kind, args = shape_case(seed)
        assert np.array_equal(draw(canvas, kind, args, True), draw(canvas, kind, args, False)), (seed, kind, args)


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def fixture_outputs(port: bool) -> dict:
    """name -> output of every recorded case, by the port (port=True) or cv2."""
    spec, out = json.loads(DIGESTS.read_text())["cases"], {}
    for c in spec["warp"]:
        img = np.random.default_rng(c["seed"]).integers(0, 256, c["shape"], dtype=np.uint8)
        M = np.asarray(c["M"], np.float64)
        if c["kind"] == "affine":
            out[c["name"]] = (warp.warp_affine_u8(img, M, c["dsize"]) if port else
                              cv2.warpAffine(img, M[:2], c["dsize"], borderValue=(114, 114, 114)))
        else:
            out[c["name"]] = (warp.warp_perspective_u8(img, M, c["dsize"]) if port else
                              cv2.warpPerspective(img, M, c["dsize"], borderValue=(114, 114, 114)))
    out["bgr_to_hsv_all"] = warp.bgr_to_hsv_u8(all_bgr()) if port else cv2.cvtColor(all_bgr(), cv2.COLOR_BGR2HSV)
    for width in (256, 1):
        hsv = all_hsv(width)
        out[f"hsv_to_bgr_all_w{width}"] = warp.hsv_to_bgr_u8(hsv) if port else cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    for c in spec["augment_hsv"]:
        img = np.random.default_rng(c["seed"]).integers(0, 256, c["shape"], dtype=np.uint8)
        luts = np.asarray(c["luts"], np.uint8)
        if port:
            warp.augment_hsv_u8(img, luts)
            out[c["name"]] = img
        else:
            h, s, v = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
            out[c["name"]] = cv2.cvtColor(cv2.merge([cv2.LUT(ch, lut) for ch, lut in zip((h, s, v), luts)]),
                                          cv2.COLOR_HSV2BGR)
    for c in spec["draw"]:
        canvas = np.random.default_rng(c["seed"]).integers(0, 256, (c["size"], c["size"], 3), dtype=np.uint8)
        args = ((tuple(c["center"]), tuple(c["axes"]), tuple(c["color"])) if c["kind"] == "ellipse"
                else (np.asarray(c["pts"], np.int32), tuple(c["color"])))
        out[c["name"]] = draw(canvas, c["kind"], args, port)
    return out


def test_committed_digests_equal_cv2_and_the_port():
    recorded = json.loads(DIGESTS.read_text())["sha256"]
    for who in (True, False):
        got = {k: _sha(v) for k, v in fixture_outputs(who).items()}
        assert got == recorded, "port" if who else "cv2 (rewrite the fixture: see the module docstring)"


def make_fixtures() -> None:
    """Rewrite tests/torch_data/host_augment/cv2_digests.json: the cases (seeds
    and parameters; images are default_rng(seed).integers(0, 256, shape,
    uint8)) and the SHA-256 of cv2's output for each."""
    warps = []
    for i, seed in enumerate((0, 1, 2, 3, 5, 8)):
        for kind in ("affine", "perspective"):
            img, M, dsize = warp_case(seed, kind == "perspective")
            warps.append({"name": f"warp_{kind}_{i}", "kind": kind, "seed": seed, "shape": list(img.shape),
                          "M": M.tolist(), "dsize": [int(v) for v in dsize]})
    for kind in ("affine", "perspective"):  # a train sample's size: the 1280 x 1280 mosaic canvas into 640 x 640
        img_seed = 7
        M = warp_matrix(np.random.default_rng(11), 1280, 1280, -320, 5e-4 if kind == "perspective" else 0.0)
        warps.append({"name": f"warp_{kind}_mosaic640", "kind": kind, "seed": img_seed, "shape": [1280, 1280, 3],
                      "M": M.tolist(), "dsize": [640, 640]})
    aug = []
    for i, shape in enumerate(([640, 640, 3], [37, 45, 3], [1, 67, 3])):
        r = np.random.default_rng(100 + i).uniform(-1, 1, 3) * [0.5, 0.7, 0.4] + 1
        x = np.arange(256.0)
        luts = np.stack([(x * r[0]) % 180, np.clip(x * r[1], 0, 255), np.clip(x * r[2], 0, 255)]).astype(np.uint8)
        aug.append({"name": f"augment_hsv_{i}", "seed": 200 + i, "shape": shape, "luts": luts.tolist()})
    draws = []  # shape_case's shapes on a canvas of default_rng(seed).integers(0, 256, (size, size, 3), uint8)
    for seed in range(12):
        canvas, kind, args = shape_case(seed)
        c = {"name": f"draw_{kind}_{seed}", "seed": 300 + seed, "size": canvas.shape[0], "kind": kind}
        if kind == "ellipse":
            c.update(center=list(args[0]), axes=list(args[1]), color=list(args[2]))
        else:
            c.update(pts=args[0].tolist(), color=list(args[1]))
        draws.append(c)
    DIGESTS.parent.mkdir(parents=True, exist_ok=True)
    made = ("PYTHONPATH=. python tests/test_torch_host_augment.py (make_fixtures): the SHA-256 of cv2 "
            f"{cv2.__version__}'s output for each case (uint8 inputs: default_rng(seed).integers(0, 256, shape); "
            "bgr_to_hsv_all: every BGR triple as a 4096 x 4096 image, b the high byte; hsv_to_bgr_all_w<W>: every "
            "(H < 180, S, V) triple in rows of W, H slowest)")
    DIGESTS.write_text(json.dumps({"made": made, "cases": {"warp": warps, "augment_hsv": aug, "draw": draws},
                                   "sha256": {}}))
    blob = json.loads(DIGESTS.read_text())
    blob["sha256"] = {k: _sha(v) for k, v in fixture_outputs(False).items()}
    DIGESTS.write_text(json.dumps(blob, indent=1) + "\n")


# -- the train transform and loader in host mode, against JAX -----------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_split(tmp_path_factory.mktemp("host_augment"), "train", 8, 0)


def _datasets(img_dir: str, **hyp):
    port = YOLODataset(img_dir, imgsz=IMGSZ, max_gt=0, augment=True,
                       hyp=get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **hyp}))
    ref = JaxYOLODataset(img_dir, imgsz=IMGSZ, augment=True, hyp=jax_get_cfg(DEFAULT_CFG, hyp), nc=2, max_gt=0,
                         device_augment=False)
    assert not port.transform.device_mode and not ref.transform.device_mode
    return port, ref


def _assert_same(got: dict, ref: dict, what: str) -> None:
    assert set(got) == set(ref) == set(KEYS), what
    for k in KEYS:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, (what, k)
        assert np.array_equal(got[k], ref[k]), (what, k)


@pytest.mark.parametrize("hyp", [{"device_augment": False}, GENERAL, {"mixup": 0.5}],
                         ids=["host_default", "auto_degrees_shear_perspective", "mixup"])
def test_host_train_transform_equals_jax(split, hyp, monkeypatch):
    port, ref = _datasets(split, **hyp)
    mixed = []
    mixup = port_augment.mixup
    monkeypatch.setattr(port_augment, "mixup", lambda a, b, rng: mixed.append(1) or mixup(a, b, rng))
    for phase in ("mosaic", "closed"):
        if phase == "closed":
            port.close_mosaic()
            ref.close_mosaic()
        for seed in range(24):
            i = seed % len(port)
            got = port.get_item(i, np.random.default_rng(seed))
            _assert_same(got, ref.get_item(i, np.random.default_rng(seed)), f"{phase} seed {seed}")
            assert got["img"].shape == (IMGSZ, IMGSZ, 3)
    assert (6 <= len(mixed) <= 18) if hyp.get("mixup") else not mixed  # mixup only while mosaic is on


def test_host_train_loader_equals_jax(split):
    port, ref = _datasets(split, device_augment=False)
    kw = dict(shuffle=True, seed=3, workers=2, drop_last=True)
    pl, rl = DataLoader(port, 3, **kw), JaxDataLoader(ref, 3, **kw)
    for epoch in (0, 1):
        pl.set_epoch(epoch)
        rl.set_epoch(epoch)
        got, want = list(pl), list(rl)
        assert len(got) == len(want) == 2
        for g, r in zip(got, want):
            assert int(g["n_valid"]) == int(r["n_valid"]) == 3
            _assert_same({k: g[k] for k in KEYS}, {k: r[k] for k in KEYS}, f"epoch {epoch}")


# -- multi_scale ----------------------------------------------------------------

def ladder(s: int) -> list:
    """JAX's multi_scale sizes (engine/trainer.py:421-424)."""
    return sorted({max(32, int(round(s * f / 32)) * 32) for f in (0.5, 0.75, 1.0, 1.25, 1.5)})


@pytest.mark.parametrize("s", [64, 640])
def test_multi_scale_resize_equals_jax(s):
    rng = np.random.default_rng(s)
    for size in ladder(s):
        imgs = rng.integers(0, 256, (2 if s == 64 else 1, s, s, 3), dtype=np.uint8)
        assert np.array_equal(resize_linear_u8(torch.from_numpy(imgs), size, size).numpy(),
                              _resize_uint8_batch(imgs, size)), size


@pytest.mark.parametrize("device_augment", ["auto", True])
def test_multi_scale_training_draws_jax_sizes(split, tmp_path, device_augment, caplog):
    """A 2-step training with multi_scale: under 'auto' (host mode) it draws
    JAX's sizes, one per step; with device_augment=True it warns and draws
    none, as JAX's loop (:418-420)."""
    root = Path(split).parent.parent
    val = root / "images" / "val"
    if not val.exists():
        write_split(root, "val", 2, 1)
    data = {"path": str(root), "train": "images/train", "val": "images/val", "names": {0: "a", 1: "b"}}
    seed = 5
    t = DetectionTrainer(YOLO(ROOT / "runs_artifacts" / "spectrogram_yolo11n.ckpt", device="cpu").model,
                         {"data": data, "device": "cpu", "epochs": 1, "batch": 4, "imgsz": IMGSZ, "workers": 2,
                          "multi_scale": True, "device_augment": device_augment, "seed": seed, "plots": False,
                          "save": False, "amp": False, "project": str(tmp_path), "name": "ms"})
    t.train()
    rng = np.random.default_rng(seed + 1234)  # JAX's draw per step (engine/trainer.py:424, :447-450)
    want = [int(rng.choice(ladder(IMGSZ))) for _ in range(2)] if device_augment == "auto" else []
    assert t.ms_sizes_drawn == want and np.isfinite(t.label_loss["train/box_loss"])
    assert ("ignoring multi_scale" in caplog.text) == (device_augment is True)


# -- cache="disk" ---------------------------------------------------------------

def test_disk_cache_sidecars_are_shared(split, tmp_path, monkeypatch, caplog):
    a, b = tmp_path / "a" / "images", tmp_path / "b" / "images"
    shutil.copytree(split, a)
    shutil.copytree(split, b)
    for writer, d in (("jax", a), ("port", b)):
        ds = (JaxYOLODataset(str(d), imgsz=IMGSZ, cache="disk") if writer == "jax" else
              YOLODataset(str(d), imgsz=IMGSZ, cache="disk"))
        originals = [imread(f) for f in ds.im_files]
        for i in range(len(ds)):
            ds.load_image(i)
        with monkeypatch.context() as mp:  # the reader finds every image in its sidecar, decoding none
            mp.setattr("spectrogram_yolov11_torch.data.dataset.imread", None)
            mp.setattr("spectrogram_yolov11_tpu.data.dataset.cv2.imread", None)
            reader = (YOLODataset(str(d), imgsz=IMGSZ, cache="disk") if writer == "jax" else
                      JaxYOLODataset(str(d), imgsz=IMGSZ, cache="disk"))
            assert all(np.array_equal(reader.load_image(i), im) for i, im in enumerate(originals)), writer
    port = YOLODataset(str(b), imgsz=IMGSZ, cache="disk")
    npy = Path(port.im_files[0]).with_suffix(".npy")
    npy.write_bytes(npy.read_bytes()[:-50])  # a truncated sidecar is decoded anew and rewritten
    assert np.array_equal(port.load_image(0), imread(port.im_files[0])) and np.array_equal(np.load(npy),
                                                                                           imread(port.im_files[0]))
    npy.unlink()

    def refuse(*args, **kw):
        raise PermissionError("read-only file system")

    monkeypatch.setattr(np, "save", refuse)
    assert np.array_equal(port.load_image(0), imread(port.im_files[0]))
    assert not port.cache_disk and not npy.exists() and "disk cache write failed" in caplog.text


# -- the shapes datasets --------------------------------------------------------

@pytest.mark.parametrize("name", ["coco8.yaml", "shapes128.yaml"])
def test_shapes_kind_writes_jax_files(name, tmp_path):
    text = (JAX_YAMLS / name).read_text()
    files = {}
    for who, check in (("jax", jax_check_det_dataset), ("port", check_det_dataset)):
        yml = tmp_path / f"{who}.yaml"
        lines = [ln for ln in text.splitlines() if not ln.startswith(("path:", "n_train:", "n_val:"))]
        yml.write_text("\n".join([f"path: {tmp_path / who}", "n_train: 4", "n_val: 2", *lines]) + "\n")
        data = check(str(yml))
        assert data["nc"] == (80 if name == "coco8.yaml" else 3)
        files[who] = {str(p.relative_to(tmp_path / who)): p.read_bytes()
                      for p in sorted((tmp_path / who).rglob("*")) if p.suffix in (".jpg", ".txt")}
    assert len(files["port"]) == 12 and files["port"] == files["jax"]


def test_detect_dataset_yamls_resolve_by_name():
    for stem in DETECT_YAMLS:
        path = find_dataset_yaml(f"{stem}.yaml")
        assert path.parent.name == "datasets" and path.parent.parent.parent.name == "spectrogram_yolov11_torch"
        assert path.read_text() == (JAX_YAMLS / f"{stem}.yaml").read_text()
        assert yaml_load(path)["synthetic"] == ("spectrogram" if stem == "Spectrogram_lap" else "shapes")


if __name__ == "__main__":
    make_fixtures()
    print(f"wrote {DIGESTS}")
