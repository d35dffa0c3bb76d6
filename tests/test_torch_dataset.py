"""The port's dataset side of validation against the JAX package's.

- `yaml_load` reads the dataset YAMLs as yaml.safe_load does, and raises,
  naming the line, on what it does not take.
- `check_det_dataset` resolves names, nc and the split paths as JAX's does.
- `resize_linear_u8` equals cv2.resize(INTER_LINEAR) on uint8 frames: the
  exact 2x downscale cv2 takes as an area average, r = 0.64 with a half-pixel
  pad, other down- and upscales, the 256 -> 640 synth resize, gray and colour.
- The synthetic generator draws JAX's rng stream, so its labels are JAX's
  exactly, and its frames equal JAX's pre-JPEG frames.
- On one PNG split, the port's val batches (DataLoader(YOLODataset(...)),
  frames letterboxed by letterbox_batch(scaleup=False)) equal the JAX
  DataLoader(YOLODataset(..., augment=False)) batches field by field: cls,
  bboxes, mask_gt, ratio_pad, ori_shape and n_valid exactly, with a padded
  tail batch; img exactly, at r = 1 (one of them needs pad) and where the
  letterbox shrinks the image (r = 0.5 and 0.64).
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

import spectrogram_yolov11_tpu.data.synth as jax_synth
from spectrogram_yolov11_torch.data.augment import letterbox_batch, resize_linear_u8
from spectrogram_yolov11_torch.data.build import DataLoader
from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset, find_dataset_yaml
from spectrogram_yolov11_torch.data.imageio import imread, imwrite
from spectrogram_yolov11_torch.data.synth import _gen_spectrogram, maybe_generate
from spectrogram_yolov11_torch.utils import yaml_load
from spectrogram_yolov11_tpu.data import DataLoader as JaxDataLoader
from spectrogram_yolov11_tpu.data import YOLODataset as JaxYOLODataset
from spectrogram_yolov11_tpu.data import check_det_dataset as jax_check_det_dataset

ROOT = Path(__file__).resolve().parent.parent
JAX_YAMLS = ROOT / "spectrogram_yolov11_tpu" / "cfg" / "datasets"
PORT_YAMLS = ROOT / "spectrogram_yolov11_torch" / "cfg" / "datasets"
YAMLS = [JAX_YAMLS / n for n in ("spectrogram_synth.yaml", "spectrogram_synth_640.yaml", "Spectrogram.yaml",
                                 "coco8.yaml")] + sorted(PORT_YAMLS.glob("*.yaml"))


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: f"{p.parent.parent.parent.name}/{p.name}")
def test_yaml_load_equals_pyyaml(path):
    assert yaml_load(path) == yaml.safe_load(path.read_text())
    assert yaml_load(path, append_filename=True)["yaml_file"] == str(path)


def test_yaml_load_reads_the_subset_and_raises_on_the_rest(tmp_path):
    p = tmp_path / "d.yaml"
    p.write_text("# c\npath: '../x y'  # trailing\nnc: 3\nr: 0.5\nf: 1.\nb: true\nn: ~\nl: [a, 'b c', 2]\n"
                 "e: []\nempty:\nnames:\n  0: LTE\n  1: \"RF\"\ns: yes\nseq:\n  - LTE\n  - [-1, 1, Conv, [64, 3]]  # 0\n"
                 "flat:\n- a\n- [[-1, 6], None, nearest, False, 0.25, []]\nnested: [b, [c, [d]]]\n")
    assert yaml_load(p) == yaml.safe_load(p.read_text())
    for bad in ("a: {b: 1}\n", "a: [b, {c: 1}]\n", "a: [b, [c]\n", "a: [b,, c]\n", "a: [b] c\n", "a: |\n  text\n",
                "  a: 1\n", "a: 1\na: 2\n", "names:\n  0:\n    x: 1\n", "s:\n  - a\n  b: 1\n", "s:\n  - a\n    - b\n",
                "- a\n"):
        p.write_text(bad)
        with pytest.raises(ValueError, match=r"d\.yaml:\d"):
            yaml_load(p)


def _split(root: Path, shapes, seed=0):
    """PNG images of the given (h, w, c) under root/images/val with random labels."""
    rng = np.random.default_rng(seed)
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    for i, (h, w, c) in enumerate(shapes):
        img = cv2.resize(rng.integers(0, 256, (9, 11, c), dtype=np.uint8), (w, h), interpolation=cv2.INTER_CUBIC)
        img = img.reshape(h, w, c)
        img[::5] = rng.integers(0, 256, img[::5].shape)
        imwrite(root / "images" / "val" / f"{i:03d}.png", img)
        n = int(rng.integers(0, 5)) if i else 0  # the first image has no labels
        xy = rng.uniform(0.15, 0.85, (n, 2))
        wh = rng.uniform(0.01, 0.3, (n, 2))
        rows = [f"{int(rng.integers(0, 2))} {x:.6f} {y:.6f} {bw:.6f} {bh:.6f}" for (x, y), (bw, bh) in zip(xy, wh)]
        rows += ["1 0.5 0.5 0 0.2", "bad row"] if i == 2 else []  # skipped by both
        (root / "labels" / "val" / f"{i:03d}.txt").write_text("\n".join(rows))
    return root


def test_check_det_dataset_equals_jax(tmp_path):
    _split(tmp_path / "ds", [(8, 8, 1)])
    (tmp_path / "ds" / "images" / "b").mkdir()
    y = tmp_path / "cfg" / "d.yaml"
    y.parent.mkdir()
    for text in ("path: ../ds\ntrain: images/train\nval: images/val\nnames:\n  0: LTE\n  1: RF\n",
                 "path: ../ds\nval: [images/val, images/b]\nnames: [a, b, c]\n",
                 f"path: {tmp_path / 'ds'}\nvalidation: images/val\nnc: 2\n"):
        y.write_text(text)
        ours, theirs = check_det_dataset(y), jax_check_det_dataset(str(y))
        for k in ("names", "nc", "path", "train", "val"):
            assert ours.get(k) == theirs.get(k), k
        d = {k: v for k, v in yaml.safe_load(text).items()}
        d["path"] = str(tmp_path / "ds")
        ours, theirs = check_det_dataset(d), jax_check_det_dataset(d)
        assert {k: ours.get(k) for k in ("names", "nc", "path", "val")} == {k: theirs.get(k) for k in ("names", "nc", "path", "val")}
    assert find_dataset_yaml("spectrogram_synth.yaml") == PORT_YAMLS / "spectrogram_synth.yaml"
    assert yaml_load(PORT_YAMLS / "spectrogram_synth.yaml")["path"] == "../../../datasets/torch/spectrogram_synth"
    with pytest.raises(FileNotFoundError):
        check_det_dataset({"path": str(tmp_path), "val": "missing", "names": ["a"]})
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 10"):  # the detect `shapes` kind is generated
        check_det_dataset({"path": str(tmp_path), "val": "images/val", "names": ["a"], "synthetic": "shapes-seg"})


# (source (h, w, c), destination (h, w)): exact 2x (cv2's area average), r = 0.64 with a half-pixel pad, r = 0.5
# with an odd side, other down- and upscales, the synth resize 256 -> 640 rows, one channel and three
RESIZES = [((1280, 720, 3), (640, 360)), ((1280, 1280, 1), (640, 640)), ((1000, 701, 3), (640, 449)),
           ((641, 640, 1), (320, 320)), ((100, 77, 3), (37, 51)), ((333, 500, 3), (426, 640)),
           ((7, 9, 3), (20, 31)), ((256, 640, 1), (640, 640)), ((360, 640, 1), (360, 641))]


@pytest.mark.parametrize("src,dst", RESIZES, ids=lambda v: "x".join(map(str, v)))
def test_resize_linear_equals_cv2(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    frames = rng.integers(0, 256, (2, *src), dtype=np.uint8)
    frames[1] = cv2.resize(frames[1, ::8, ::8], src[1::-1], interpolation=cv2.INTER_CUBIC).reshape(src)  # smooth
    got = resize_linear_u8(torch.from_numpy(frames), *dst).numpy()
    assert got.shape == (2, *dst, src[2])
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, cv2.resize(f, dst[::-1], interpolation=cv2.INTER_LINEAR).reshape(g.shape))


def test_synth_split_labels_equal_jax(tmp_path, monkeypatch):
    """_gen_spectrogram against JAX's on the val seed: labels exactly, frames
    equal to JAX's frames before they are JPEG-encoded."""
    frames = {}
    write = jax_synth._write_sample

    def keep(root, split, i, img, labels):
        frames[i] = img
        write(root, split, i, img, labels)

    monkeypatch.setattr(jax_synth, "_write_sample", keep)
    jax_synth._gen_spectrogram(tmp_path / "jax", "val", 2, 640, 10_000)
    _gen_spectrogram(tmp_path / "port", "val", 2, 640, 10_000)
    for i in range(2):
        name = f"{i:05d}"
        assert (tmp_path / "port/labels/val" / f"{name}.txt").read_text() == \
            (tmp_path / "jax/labels/val" / f"{name}.txt").read_text()
        ours = imread(tmp_path / "port/images/val" / f"{name}.png")
        assert ours.shape == frames[i].shape == (640, 640, 3)
        np.testing.assert_array_equal(ours, frames[i])
    # maybe_generate: train with seed + j, val with seed + 10000, as JAX's; nothing when val exists
    data = {"path": tmp_path / "m", "train": str(tmp_path / "m/images/train"), "val": str(tmp_path / "m/images/val"),
            "synthetic": "spectrogram", "n_train": 1, "n_val": 2, "gen_imgsz": 64, "seed": 3}
    assert maybe_generate(data)
    assert sorted(p.name for p in (tmp_path / "m/images/val").iterdir()) == ["00000.png", "00001.png"]
    _gen_spectrogram(tmp_path / "ref", "val", 2, 64, 10_003)
    assert (tmp_path / "m/labels/val/00001.txt").read_text() == (tmp_path / "ref/labels/val/00001.txt").read_text()
    assert len(list((tmp_path / "m/images/train").iterdir())) == 1 and maybe_generate(data)
    assert not maybe_generate({"val": "x"})


# (h, w, c): r = 1 without and with pad, gray and colour; r < 1 (0.5, and 0.64 with a pad of .5 px a side)
SHAPES = [(640, 640, 1), (360, 640, 3), (1280, 720, 3), (333, 500, 3), (1000, 701, 3)]


def test_val_batches_equal_jax(tmp_path):
    root = _split(tmp_path, SHAPES)
    img_dir = root / "images" / "val"
    ours = list(DataLoader(YOLODataset(img_dir, imgsz=640), batch_size=2, workers=2))
    theirs = list(JaxDataLoader(JaxYOLODataset(str(img_dir), imgsz=640, augment=False, nc=2, max_gt=256),
                                batch_size=2, shuffle=False, drop_last=False, workers=2))
    assert len(ours) == len(theirs) == 3
    seen = []
    for bi, (a, b) in enumerate(zip(ours, theirs)):
        assert set(a) == set(b) == {"img", "cls", "bboxes", "mask_gt", "ratio_pad", "ori_shape", "n_valid"}
        for k in ("cls", "bboxes", "mask_gt", "ratio_pad", "ori_shape", "n_valid"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        frames = letterbox_batch(a["img"], 640, torch.device("cpu"), scaleup=False)
        rgb = frames.expand(-1, -1, -1, 3).flip(-1).numpy()
        assert rgb.shape == b["img"].shape
        for i in range(len(rgb)):
            r = float(b["ratio_pad"][i][0])
            np.testing.assert_array_equal(rgb[i], b["img"][i], err_msg=f"batch {bi} image {i} at r = {r:.4f}")
            seen.append(round(r, 4))
    assert int(ours[-1]["n_valid"]) == 1 and ours[-1]["img"][1] is ours[-1]["img"][0]  # the padded tail
    assert sorted(set(seen)) == [0.5, 0.64, 1.0]
    assert ours[0]["mask_gt"][0].sum() == 0 and ours[1]["mask_gt"][0].sum() == int(ours[1]["mask_gt"][0].sum())
