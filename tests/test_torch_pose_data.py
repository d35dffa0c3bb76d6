"""The port's pose training and validation data against the JAX package's, on the CPU.

- Labels: pose rows (`cls cx cy w h` and kpt_shape's nk x nd values)
  parsed as JAX's YOLODataset(task="pose") parses them, at (5, 3) and at
  (4, 2), where a visibility of 1 is added; rows of another length skipped
  as bad; `keypoints` (n, nk, 3) in each image's labels, the JSON cache
  `<images dir>.labels.pose.json` written with JAX's bytes and read by
  either package; load_sample's keypoints in pixels.
- format_sample's (max_gt, nk, 3) keypoint pad (normalised by the image's
  size or, in device mode, by `img_shape`), mosaic4, random_perspective (a
  point warped outside [0, w] x [0, h] gets visibility 0), random_flip with
  flip_idx, copy_paste's mirrored keypoints and _pad_labels: every output
  array equal to JAX's over seeded samples.
- mixup drops the keypoints in both packages, and format_sample then pads
  zeros for them in both (ROADMAP.md §3.32).
- The samples: ValTransform (keypoints scaled and shifted into the
  letterboxed frame), the host TrainTransform (device_augment=False, and the
  general warp) and the device-mode TrainTransform (labels, keypoints and
  the card's image parameters), each array-equal to JAX's on 8 seeds with
  mosaic on and 4 after close_mosaic(), flip_idx from the data.
- The shapes-pose kind: shapes128-pose.yaml, coco8-pose.yaml (17
  keypoints) and tiger-pose.yaml (nd = 2), cut to 3 + 2 images by a
  temporary YAML, generate JAX's JPEG bytes and label texts; the five pose
  dataset YAMLs are JAX's copies.

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
import spectrogram_yolov11_tpu.data.augment as JA
from spectrogram_yolov11_tpu.cfg import get_cfg as jax_get_cfg
from spectrogram_yolov11_tpu.data.dataset import YOLODataset as JaxYOLODataset
from spectrogram_yolov11_tpu.data.dataset import check_det_dataset as jax_check_det_dataset
from spectrogram_yolov11_tpu.utils import DEFAULT_CFG

ROOT = Path(__file__).resolve().parent.parent
JAX_YAMLS = ROOT / "spectrogram_yolov11_tpu" / "cfg" / "datasets"
POSE_YAMLS = ("shapes128-pose", "coco8-pose", "coco-pose", "dog-pose", "tiger-pose")
IMGSZ = 64
SIZES = ((64, 96), (96, 64), (70, 90), (64, 64))
KPT, FLIP_IDX = (5, 3), [1, 0, 3, 2, 4]
GENERAL = {"degrees": 10.0, "shear": 3.0, "perspective": 5e-4, "flipud": 0.5}  # 'auto' -> host, warpPerspective
LABEL_KEYS = ("cls", "bboxes", "mask_gt", "keypoints")
DEVICE_KEYS = (*LABEL_KEYS, "aug_src", "aug_regions", "aug_pads", "aug_inv", "aug_hsv")


def pose_row(rng: np.random.Generator, nk: int, nd: int) -> str:
    """`cls cx cy w h` and nk keypoints (x, y[, v]) in and around the box, normalised."""
    c, wh = rng.uniform(0.25, 0.75, 2), rng.uniform(0.1, 0.5, 2)
    xy = c + rng.uniform(-0.6, 0.6, (nk, 2)) * wh
    vals = [*c, *wh] + [v for p in xy for v in (*p, *([float(rng.integers(0, 3))] if nd == 3 else []))]
    return f"{rng.integers(0, 2)} " + " ".join(f"{v:.6f}" for v in vals)


def write_pose_split(root: Path, kpt=KPT, n: int = 8, seed: int = 0) -> str:
    """n colour PNGs of SIZES with pose label rows (one image without a label
    file, one with an empty one, one with rows of the wrong length) under
    root/images and root/labels."""
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        h, w = SIZES[i % len(SIZES)]
        imwrite(root / "images" / f"{i:03d}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        if i == 1:
            continue
        rows = [pose_row(rng, *kpt) for _ in range(0 if i == 2 else int(rng.integers(1, 5)))]
        if i == 3:
            rows += ["0 0.5 0.5 0.2 0.2", pose_row(rng, kpt[0] + 1, kpt[1])]  # a detect row, one keypoint too many
        (root / "labels" / f"{i:03d}.txt").write_text("\n".join(rows))
    return str(root / "images")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_pose_split(tmp_path_factory.mktemp("pose_data"))


def _same(got, ref, what) -> None:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(got, ref), what


def _same_sample(got: dict, ref: dict, keys, what: str) -> None:
    for k in keys:
        assert k in got and k in ref, (what, k)
        _same(got[k], ref[k], (what, k))


# -- labels --------------------------------------------------------------------------

@pytest.mark.parametrize("kpt", [KPT, (4, 2)])
def test_labels_and_cache_equal_jax(kpt, tmp_path):
    img_dir = write_pose_split(tmp_path, kpt)
    cache = Path(img_dir).with_suffix(".labels.pose.json")
    ours = YOLODataset(img_dir, task="pose", kpt_shape=kpt)
    port_bytes = cache.read_bytes()
    cache.unlink()
    theirs = JaxYOLODataset(img_dir, nc=2, task="pose", kpt_shape=kpt)
    assert cache.read_bytes() == port_bytes
    assert sum(len(lab["cls"]) for lab in ours.labels) > 10 and len(ours.labels[3]["cls"]) >= 1
    for a, b in zip(ours.labels, theirs.labels):
        _same_sample(a, b, ("cls", "xywhn", "keypoints"), "labels")
        assert a["keypoints"].shape == (len(a["cls"]), kpt[0], 3)
    if kpt[1] == 2:
        assert all((lab["keypoints"][..., 2] == 1).all() for lab in ours.labels)
    for reader in (lambda: YOLODataset(img_dir, task="pose", kpt_shape=kpt),
                   lambda: JaxYOLODataset(img_dir, nc=2, task="pose", kpt_shape=kpt)):
        for a, b in zip(reader().labels, ours.labels):
            _same_sample(a, b, ("cls", "xywhn", "keypoints"), "cache")
        assert cache.read_bytes() == port_bytes
    for i in range(len(ours)):
        _same_sample(ours.load_sample(i), theirs.load_sample(i), ("img", "cls", "bboxes", "keypoints"), f"sample {i}")


# -- the label ops -----------------------------------------------------------------------

def _labelled(rng: np.random.Generator, h: int, w: int, n: int, nk: int = 5) -> dict:
    c = rng.uniform(0.2, 0.8, (n, 2)) * [w, h]
    half = rng.uniform(4, 20, (n, 2))
    boxes = np.concatenate([c - half, c + half], -1).astype(np.float32)
    kxy = c[:, None] + rng.uniform(-1.3, 1.3, (n, nk, 2)) * half[:, None]  # some points past their box
    vis = rng.choice([0.0, 1.0, 2.0], (n, nk, 1))
    return {"img": rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "cls": rng.integers(0, 2, n).astype(np.int32),
            "bboxes": boxes, "keypoints": np.concatenate([kxy, vis], -1).astype(np.float32)}


@pytest.mark.parametrize("seed", range(4))
def test_format_sample_and_pad_labels_equal_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = SIZES[seed]
    sample = _labelled(rng, h, w, int(rng.integers(1, 9)))
    sample["bboxes"][::3, 2] = sample["bboxes"][::3, 0]  # zero-width boxes: dropped with their keypoints
    for dw, dh in ((0.0, 3.5), (7.25, 0.0)):
        _same_sample(A.pad_labels(sample, dw, dh), JA._pad_labels(sample, dw, dh), ("bboxes", "keypoints"), "pad")
    got = A.format_sample(dict(sample), IMGSZ, 12, "pose", kpt_shape=KPT)
    ref = JA.format_sample(dict(sample), IMGSZ, 12, task="pose", kpt_shape=KPT)
    _same_sample(got, ref, ("img", *LABEL_KEYS), f"seed {seed}")
    assert got["keypoints"].shape == (12, 5, 3) and got["keypoints"].any()
    dev = {k: v for k, v in sample.items() if k != "img"}  # device mode: normalised by img_shape
    got = A.format_sample(dict(dev, img_shape=(h, w)), IMGSZ, 12, "pose", kpt_shape=KPT)
    ref = JA.format_sample(dict(dev, img=None, img_shape=(h, w)), IMGSZ, 12, task="pose", kpt_shape=KPT)
    _same_sample(got, ref, LABEL_KEYS, f"seed {seed}, device mode")


@pytest.mark.parametrize("seed", range(6))
def test_mosaic_warp_and_flip_carry_keypoints_as_jax(seed):
    rng = np.random.default_rng(seed)
    samples = [_labelled(rng, IMGSZ, IMGSZ - 8 * (i % 2), int(rng.integers(0, 4))) for i in range(4)]
    got = A.mosaic4([dict(s) for s in samples], IMGSZ, np.random.default_rng(seed), compose_image=True)
    ref = JA.mosaic4([dict(s) for s in samples], IMGSZ, np.random.default_rng(seed))
    _same_sample(got, ref, ("img", "cls", "bboxes", "keypoints"), "mosaic")
    border = got.pop("mosaic_border")
    ref.pop("mosaic_border")
    hyp = dict(degrees=15.0, translate=0.1, scale=0.5, shear=5.0, perspective=1e-3 if seed % 2 else 0.0)
    got = A.random_perspective(got, **hyp, border=border, rng=np.random.default_rng(seed), warp_image=True)
    ref = JA.random_perspective(ref, **hyp, border=border, rng=np.random.default_rng(seed))
    _same_sample(got, ref, ("img", "cls", "bboxes", "keypoints"), "warp")
    assert ref["keypoints"].shape == (len(ref["bboxes"]), 5, 3)
    got = A.random_flip(got, 0.5, 0.5, np.random.default_rng(seed + 7), flip_image=True, flip_idx=FLIP_IDX)
    ref = JA.random_flip(ref, 0.5, 0.5, rng=np.random.default_rng(seed + 7), flip_idx=FLIP_IDX)
    _same_sample(got, ref, ("img", "cls", "bboxes", "keypoints"), "flip")


def test_warp_sets_points_outside_invisible_as_jax():
    rng = np.random.default_rng(3)
    sample = _labelled(rng, IMGSZ, IMGSZ, 6)
    sample["keypoints"][..., 2] = 2
    sample["keypoints"][0, :, :2] = [[-1, 5], [IMGSZ + 1, 5], [5, IMGSZ + 0.5], [IMGSZ, IMGSZ], [0, 0]]
    hyp = dict(degrees=0.0, translate=0.0, scale=0.0, shear=0.0, perspective=0.0)
    got = A.random_perspective(dict(sample, img_shape=(IMGSZ, IMGSZ)), **hyp, border=(0, 0),
                               rng=np.random.default_rng(0), warp_image=True)
    ref = JA.random_perspective(dict(sample), **hyp, border=(0, 0), rng=np.random.default_rng(0))
    _same_sample(got, ref, ("img", "cls", "bboxes", "keypoints"), "identity warp")
    assert got["keypoints"][0, :, 2].tolist() == [0, 0, 0, 2, 2]  # the strict > w: a point on the edge stays


@pytest.mark.parametrize("seed", range(4))
def test_copy_paste_mirrors_keypoints_as_jax(seed):
    rng = np.random.default_rng(seed)
    sample = _labelled(rng, 48 + 8 * (seed % 3), 64, int(rng.integers(1, 7)))
    sample["segments"] = [np.asarray([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]], np.float32)
                          for b in sample["bboxes"]]
    got = A.copy_paste(dict(sample), 0.5 + 0.5 * (seed % 2), np.random.default_rng(seed))
    ref = JA.copy_paste(dict(sample), p=0.5 + 0.5 * (seed % 2), rng=np.random.default_rng(seed))
    _same_sample(got, ref, ("img", "cls", "bboxes", "keypoints"), f"seed {seed}")
    pose_only = {k: v for k, v in sample.items() if k != "segments"}  # a pose sample: the step leaves it alone
    assert A.copy_paste(pose_only, 1.0, np.random.default_rng(0)) is pose_only
    assert JA.copy_paste(pose_only, 1.0, np.random.default_rng(0)) is pose_only


def test_mixup_drops_keypoints_as_jax():
    rng = np.random.default_rng(0)
    a, b = _labelled(rng, IMGSZ, IMGSZ, 2), _labelled(rng, IMGSZ, IMGSZ, 1)
    outs = []
    for mix, fmt in ((A.mixup, lambda s: A.format_sample(s, IMGSZ, 8, "pose", kpt_shape=KPT)),
                     (JA.mixup, lambda s: JA.format_sample(s, IMGSZ, 8, task="pose", kpt_shape=KPT))):
        mixed = mix(dict(a), dict(b), np.random.default_rng(1))
        assert "keypoints" not in mixed
        outs.append(fmt(mixed))
    _same_sample(outs[0], outs[1], ("img", *LABEL_KEYS), "mixup")
    assert outs[0]["mask_gt"].sum() == 3 and not outs[0]["keypoints"].any()


# -- the samples -------------------------------------------------------------------------

def test_val_samples_equal_jax(split):
    port = YOLODataset(split, imgsz=IMGSZ, max_gt=16, task="pose", kpt_shape=KPT)
    ref = JaxYOLODataset(split, imgsz=IMGSZ, nc=2, max_gt=16, task="pose", kpt_shape=KPT)
    for i in range(len(port)):
        got, want = port.get_item(i), ref.get_item(i, None)
        _same_sample(got, want, (*LABEL_KEYS, "ori_shape", "ratio_pad"), f"image {i}")
        assert got["keypoints"].shape == (16, 5, 3)


@pytest.mark.parametrize("hyp,device", [({"device_augment": False}, False), (GENERAL, False), ({}, True)],
                         ids=["host_default", "host_general_warp", "device"])
def test_train_samples_equal_jax(split, hyp, device):
    port = YOLODataset(split, imgsz=IMGSZ, max_gt=0, augment=True, task="pose", kpt_shape=KPT, flip_idx=FLIP_IDX,
                       hyp=get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **hyp}))
    ref = JaxYOLODataset(split, imgsz=IMGSZ, augment=True, hyp=jax_get_cfg(DEFAULT_CFG, hyp), nc=2, max_gt=0,
                         task="pose", kpt_shape=KPT, flip_idx=FLIP_IDX, device_augment=device)
    assert port.transform.device_mode == ref.transform.device_mode == device
    keys = DEVICE_KEYS if device else ("img", *LABEL_KEYS)
    for phase, seeds in (("mosaic", range(8)), ("closed", range(4))):
        if phase == "closed":
            port.close_mosaic()
            ref.close_mosaic()
        for seed in seeds:
            i = seed % len(port)
            got = port.get_item(i, np.random.default_rng(seed))
            _same_sample(got, ref.get_item(i, np.random.default_rng(seed)), keys, f"{phase} seed {seed}")
            assert got["keypoints"].shape == (port.max_gt, 5, 3)


# -- the shapes-pose kind ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["shapes128-pose.yaml", "coco8-pose.yaml", "tiger-pose.yaml"])
def test_shapes_pose_kind_writes_jax_files(name, tmp_path):
    text = (JAX_YAMLS / name).read_text()
    files = {}
    for who, check in (("jax", jax_check_det_dataset), ("port", check_det_dataset)):
        yml = tmp_path / f"{who}.yaml"
        lines = [ln for ln in text.splitlines() if not ln.startswith(("path:", "n_train:", "n_val:", "gen_imgsz:"))]
        head = [f"path: {tmp_path / who}", "n_train: 3", "n_val: 2", "gen_imgsz: 160"]
        yml.write_text("\n".join([*head, *lines]) + "\n")
        assert check(str(yml))["kpt_shape"] == {"shapes128-pose.yaml": [5, 3], "coco8-pose.yaml": [17, 3],
                                                "tiger-pose.yaml": [12, 2]}[name]
        files[who] = {str(p.relative_to(tmp_path / who)): p.read_bytes()
                      for p in sorted((tmp_path / who).rglob("*")) if p.suffix in (".jpg", ".txt")}
    assert len(files["port"]) == 10 and files["port"] == files["jax"]


def test_pose_dataset_yamls_are_jax_copies():
    for stem in POSE_YAMLS:
        path = find_dataset_yaml(f"{stem}.yaml")
        assert path.parent.parent.parent.name == "spectrogram_yolov11_torch"
        assert path.read_text() == (JAX_YAMLS / f"{stem}.yaml").read_text()
