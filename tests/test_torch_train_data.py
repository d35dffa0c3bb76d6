"""The port's train data against the JAX package's device-augment mode, on the CPU.

A tiny PNG dataset (8 train images of four sizes around 96 x 64, colour,
1-5 boxes each, one image without a label file and one with an empty one; 4
val images) is written once per module. At imgsz 64 every image is resized
by the train path's long-side resize (cv2's INTER_LINEAR in JAX,
resize_linear_u8 in the port), and the 4-image mosaic mixes the sizes.

- TrainTransform: the port's sample against JAX's
  TrainTransform(device_mode=True) on the same files and seeds, array-equal
  in every key (cls, bboxes, mask_gt, aug_src, aug_regions, aug_pads,
  aug_inv, aug_hsv): 24 seeds at the default hyps with mosaic on, the same
  seeds after close_mosaic(), and 24 with degrees, shear and flipud set
  (device_augment=True, the card's general warp; JAX's 'auto' would augment
  those on the host).
- The automatic GT pad (max_gt=0) equals JAX's, with and without augment.
- The train DataLoader (shuffle, drop_last, per-sample streams) at B = 3 over
  two epochs: the order and every batch equal to JAX's DataLoader.
- The settings under which JAX augments images on the host (device_augment
  False; 'auto' with degrees; multi_scale; mixup) pick JAX's mode, host
  augmentation, with JAX's warning where it falls back (mixup). The host
  mode's samples are held to JAX's in tests/test_torch_host_augment.py.
"""

import logging
from types import SimpleNamespace

import numpy as np
import pytest
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.cfg import DEFAULT_CFG_DICT, get_cfg
from spectrogram_yolov11_torch.data.build import DataLoader
from spectrogram_yolov11_torch.data.dataset import YOLODataset
from spectrogram_yolov11_torch.data.imageio import imwrite
from spectrogram_yolov11_tpu.cfg import get_cfg as jax_get_cfg
from spectrogram_yolov11_tpu.data.build import DataLoader as JaxDataLoader
from spectrogram_yolov11_tpu.data.dataset import YOLODataset as JaxYOLODataset
from spectrogram_yolov11_tpu.engine.trainer import BaseTrainer as JaxBaseTrainer
from spectrogram_yolov11_tpu.utils import DEFAULT_CFG

IMGSZ = 64
SIZES = ((64, 96), (96, 64), (70, 90), (64, 96))  # (h, w) of the train images, in turn
KEYS = ("cls", "bboxes", "mask_gt", "aug_src", "aug_regions", "aug_pads", "aug_inv", "aug_hsv")
GENERAL = {"degrees": 10.0, "shear": 3.0, "flipud": 0.5}


def write_split(root, split: str, n: int, seed: int) -> str:
    """n colour PNGs with YOLO labels under root/images/split and root/labels/split."""
    rng = np.random.default_rng(seed)
    (root / "images" / split).mkdir(parents=True)
    (root / "labels" / split).mkdir(parents=True)
    for i in range(n):
        h, w = SIZES[i % len(SIZES)]
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img[h // 4 : h // 2, w // 4 : w // 2] = rng.integers(0, 256, 3)
        imwrite(root / "images" / split / f"{i:03d}.png", img)
        if i == 1:
            continue  # no label file
        k = 0 if i == 2 else int(rng.integers(1, 6))
        rows = [f"{rng.integers(0, 2)} {rng.uniform(0.25, 0.75):.6f} {rng.uniform(0.25, 0.75):.6f} "
                f"{rng.uniform(0.1, 0.5):.6f} {rng.uniform(0.1, 0.5):.6f}" for _ in range(k)]
        (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows))
    return str(root / "images" / split)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    return write_split(root, "train", 8, 0)


def _datasets(img_dir: str, **hyp):
    port = YOLODataset(img_dir, imgsz=IMGSZ, max_gt=0, augment=True,
                       hyp=get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **hyp}))
    ref = JaxYOLODataset(img_dir, imgsz=IMGSZ, augment=True, hyp=jax_get_cfg(DEFAULT_CFG, hyp), nc=2, max_gt=0,
                         device_augment=True)
    assert ref.transform.device_mode
    return port, ref


def _assert_same(got: dict, ref: dict, what: str) -> None:
    assert set(got) == set(ref), what
    for k in KEYS:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, (what, k)
        assert np.array_equal(got[k], ref[k]), (what, k)


@pytest.mark.parametrize("hyp", [{}, dict(GENERAL, device_augment=True)], ids=["default", "degrees_shear_flipud"])
def test_train_transform_equals_jax(split, hyp):
    port, ref = _datasets(split, **hyp)
    mosaics = 0
    for phase in ("mosaic", "closed"):
        if phase == "closed":
            port.close_mosaic()
            ref.close_mosaic()
        for seed in range(24):
            i = seed % len(port)
            got = port.get_item(i, np.random.default_rng(seed))
            _assert_same(got, ref.get_item(i, np.random.default_rng(seed)), f"{phase} seed {seed}")
            mosaics += int(got["aug_regions"][1:].any())
    assert 12 <= mosaics <= 24  # mosaic on every sample while enabled (p = 1), none after close_mosaic()


def test_auto_max_gt_equals_jax(split):
    for augment in (False, True):
        port = YOLODataset(split, imgsz=IMGSZ, max_gt=0, augment=augment,
                           hyp=get_cfg(DEFAULT_CFG_DICT, {"mode": "train"}))
        ref = JaxYOLODataset(split, imgsz=IMGSZ, augment=augment, hyp=jax_get_cfg(DEFAULT_CFG, {}), max_gt=0,
                             device_augment=True)
        assert port.max_gt == ref.max_gt == 32


def test_train_loader_equals_jax(split):
    port, ref = _datasets(split)
    kw = dict(shuffle=True, seed=3, workers=2, drop_last=True)
    pl, rl = DataLoader(port, 3, **kw), JaxDataLoader(ref, 3, **kw)
    assert len(pl) == len(rl) == 2
    for epoch in (0, 1):
        pl.set_epoch(epoch)
        rl.set_epoch(epoch)
        assert np.array_equal(pl._indices(), rl._indices())
        got, want = list(pl), list(rl)
        assert len(got) == len(want) == 2
        for g, r in zip(got, want):
            assert int(g["n_valid"]) == int(r["n_valid"]) == 3
            _assert_same(g, r, f"epoch {epoch}")


@pytest.mark.parametrize("hyp,what", [({"device_augment": False}, "device_augment=False"),
                                      (GENERAL, "device_augment='auto' with degrees"),
                                      ({"multi_scale": True}, "multi_scale"), ({"mixup": 0.1}, "mixup")])
def test_host_augmentation_raises(split, hyp, what, caplog):
    """Each setting that once raised (item 7b, now closed) resolves as JAX's
    trainer and dataset resolve it: host augmentation, with JAX's warning
    exactly where JAX warns (mixup under 'auto' falls back from the card)."""
    jax_args = jax_get_cfg(DEFAULT_CFG, hyp)
    jax_device = JaxBaseTrainer._resolve_device_augment(SimpleNamespace(args=jax_args))
    jax_logger = logging.getLogger("syt")  # JAX's logger does not propagate to caplog's; the port's does
    warnings = {}
    jax_logger.addHandler(caplog.handler)
    try:
        for who in ("jax", "port"):
            caplog.clear()
            if who == "jax":
                ds = JaxYOLODataset(split, imgsz=IMGSZ, augment=True, hyp=jax_args, nc=2, max_gt=0,
                                    device_augment=jax_device)
            else:
                ds = YOLODataset(split, imgsz=IMGSZ, max_gt=0, augment=True,
                                 hyp=get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **hyp}))
            warnings[who] = (ds.transform.device_mode, [r.getMessage() for r in caplog.records
                                                        if r.levelno >= logging.WARNING])
    finally:
        jax_logger.removeHandler(caplog.handler)
    assert warnings["port"] == warnings["jax"], what
    assert warnings["port"][0] is False and bool(warnings["port"][1]) == (what == "mixup")
