"""Image files, directories and globs as predict sources, and val and the
train loader on JPEG datasets the JAX package writes, on the CPU.

- `YOLO(ckpt, device="cpu").predict` on a file, on the fixture directory
  (tests/torch_data/jpeg/spectrogram/images/val: the JAX generator's 8 val
  frames of Spectrogram.yaml) and on a glob (the committed small encodes of
  mixed sizes, 1 x 1 to 641 x 359) equals, exactly, the port's predict on
  the list of cv2.imread arrays of the same files, with Results.path the
  file; the same calls match JAX's predictor within
  tests/test_torch_predict.py's tolerances at its imgsz (96).
- `val(data=<the fixture split>)` lies within 1e-4 per results_dict key of
  JAX's validator on the same JPEGs, at the frames' 320 px.
- The train loader's batches from JAX-written JPEG train images equal JAX's
  host half array for array (as tests/test_torch_train_data.py holds them on
  PNG).
- The port's Spectrogram.yaml is JAX's (the same path and settings), and a
  JAX YAML given by path resolves relative to its own directory.
- Videos in a listing raise NotImplementedError before any frame is read.

The fixture split is copied into a temporary directory first: JAX's dataset
writes its label cache beside the images.
"""

import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
from test_torch_predict import IMGSZ, _assert_same
from test_torch_train_data import _assert_same as _assert_same_batch
from test_torch_train_data import _datasets
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.data.build import DataLoader
from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset, find_dataset_yaml
from spectrogram_yolov11_torch.data.loaders import LoadImagesAndVideos, load_inference_source
from spectrogram_yolov11_torch.utils import yaml_load
from spectrogram_yolov11_tpu import YOLO as JaxYOLO
from spectrogram_yolov11_tpu.data.build import DataLoader as JaxDataLoader
from spectrogram_yolov11_tpu.data.synth import _gen_spectrogram
from spectrogram_yolov11_tpu.utils import yaml_load as jax_yaml_load

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
FIXTURES = ROOT / "tests" / "torch_data" / "jpeg"
VAL_IMGSZ = 320  # the fixture frames' size (Spectrogram.yaml's gen_imgsz)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("jpeg")
    shutil.copytree(FIXTURES, root, dirs_exist_ok=True)
    return root


@pytest.fixture(scope="module")
def models():
    # the JAX facade's logging integrations (TensorBoard through tensorflow) do not touch the results
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        return YOLO(CKPT, device="cpu"), JaxYOLO(str(CKPT))


def _val_dir(fixtures: Path) -> Path:
    return fixtures / "spectrogram" / "images" / "val"


def _equal(got, ref, paths):
    assert [r.path for r in got] == [str(p) for p in paths]
    for g, r in zip(got, ref):
        assert np.array_equal(g.orig_img, r.orig_img) and np.array_equal(g.boxes.data, r.boxes.data)


def test_file_dir_and_glob_equal_the_arrays(models, fixtures):
    port, _ = models
    files = sorted(_val_dir(fixtures).glob("*.jpg"))
    arrays = [cv2.imread(str(f)) for f in files]
    by_dir = port.predict(str(_val_dir(fixtures)), batch=8, imgsz=VAL_IMGSZ)
    _equal(by_dir, port.predict(arrays, batch=8, imgsz=VAL_IMGSZ), files)
    assert sum(map(len, by_dir)) > 0
    _equal(port.predict(str(files[3]), imgsz=VAL_IMGSZ), port.predict(arrays[3], imgsz=VAL_IMGSZ), files[3:4])
    small = sorted(fixtures.glob("*.jpg"))  # mixed sizes and samplings, one batch of 12 and the padded rest
    by_glob = port.predict(str(fixtures / "*.jpg"), batch=5, imgsz=IMGSZ)
    _equal(by_glob, port.predict([cv2.imread(str(f)) for f in small], batch=5, imgsz=IMGSZ), small)
    assert [r.orig_shape for r in by_glob] == [cv2.imread(str(f)).shape[:2] for f in small]
    recursive = port.predict(str(fixtures / "**" / "*.jpg"), imgsz=IMGSZ)
    assert [r.path for r in recursive] == sorted(str(f) for f in fixtures.rglob("*.jpg"))


def test_sources_match_jax_predictor(models, fixtures, tmp_path):
    """The directory, a glob and a file through both predictors; save_txt
    writes one label file per image, named by the file's stem."""
    port, jax_model = models
    for source in (str(_val_dir(fixtures)), str(fixtures / "s4*.jpg"), str(fixtures / "641x359.jpg")):
        got = port.predict(source, imgsz=IMGSZ)
        ref = jax_model.predict(source, imgsz=IMGSZ, save=False)
        assert len(got) == len(ref) > 0
        _assert_same(got, ref)
    assert sum(map(len, port.predict(str(_val_dir(fixtures)), imgsz=IMGSZ))) > 0
    port.predict(str(_val_dir(fixtures)), imgsz=IMGSZ, save_txt=True, project=str(tmp_path), name="run")
    assert sorted(p.name for p in (tmp_path / "run" / "labels").iterdir()) == [f"{i:05d}.txt" for i in range(8)]


def test_val_on_jax_jpegs_matches_jax(models, fixtures):
    port, jax_model = models
    data = {"path": str(fixtures / "spectrogram"), "val": "images/val", "names": ["LTE", "RF"]}
    ours = port.val(data=data, batch=8, imgsz=VAL_IMGSZ)
    theirs = jax_model.val(data=data, batch=8, imgsz=VAL_IMGSZ, plots=False)
    print("port", ours, "\njax ", theirs)
    assert list(ours) == list(theirs) and ours["metrics/mAP50(B)"] > 0.5
    for k in ours:
        assert abs(ours[k] - theirs[k]) <= 1e-4, (k, ours[k], theirs[k])


def test_train_loader_reads_jax_jpegs(tmp_path):
    """The JAX generator's train frames (3-channel JPEG, 96 px) through both
    train loaders at imgsz 64: every batch of an epoch equal."""
    _gen_spectrogram(tmp_path, "train", 6, 96, 0)
    assert len(list((tmp_path / "images" / "train").glob("*.jpg"))) == 6
    port, ref = _datasets(str(tmp_path / "images" / "train"))
    kw = dict(shuffle=True, seed=1, workers=2, drop_last=True)
    got, want = list(DataLoader(port, 3, **kw)), list(JaxDataLoader(ref, 3, **kw))
    assert len(got) == len(want) == 2
    for g, r in zip(got, want):
        _assert_same_batch(g, r, "JPEG train batch")
        assert g["aug_src"].any()


def test_spectrogram_yaml_is_the_ports_copy_of_jaxs(tmp_path):
    port_yaml = find_dataset_yaml("Spectrogram.yaml")
    jax_yaml = ROOT / "spectrogram_yolov11_tpu" / "cfg" / "datasets" / "Spectrogram.yaml"
    assert port_yaml == ROOT / "spectrogram_yolov11_torch" / "cfg" / "datasets" / "Spectrogram.yaml"
    ours, theirs = yaml_load(port_yaml), jax_yaml_load(jax_yaml)
    assert ours == theirs
    assert (port_yaml.parent / ours["path"]).resolve() == (jax_yaml.parent / theirs["path"]).resolve() \
        == ROOT / "datasets" / "spectrogram"
    # a JAX YAML given by path resolves relative to its own directory (no split missing: nothing is generated)
    (tmp_path / "a" / "b" / "c").mkdir(parents=True)
    (tmp_path / "datasets" / "spectrogram" / "images" / "val").mkdir(parents=True)
    shutil.copy(jax_yaml, tmp_path / "a" / "b" / "c" / "Spectrogram.yaml")
    d = check_det_dataset(str(tmp_path / "a" / "b" / "c" / "Spectrogram.yaml"))
    assert d["path"] == tmp_path / "datasets" / "spectrogram" and d["names"] == {0: "LTE", 1: "RF"}
    # where the folder is missing the port's generator writes the stand-in (PNG), with JAX's labels
    d = check_det_dataset(dict(ours, path=str(tmp_path / "stand_in"), n_train=0))
    ds = YOLODataset(d["val"], imgsz=VAL_IMGSZ)
    assert len(ds) == 8 and all(f.endswith(".png") for f in ds.im_files)
    for i, f in enumerate(ds.im_files):
        label = Path(f.replace("images", "labels")).with_suffix(".txt").read_text()
        assert label == (FIXTURES / "spectrogram" / "labels" / "val" / f"{i:05d}.txt").read_text()


def test_listings_and_refusals(fixtures, tmp_path):
    """The listing is JAX's: a sorted rglob of image and video suffixes for a
    directory, a sorted recursive glob; a video raises before any frame is
    read, a missing source FileNotFoundError, streams and screens raise."""
    listing = LoadImagesAndVideos(str(fixtures)).files
    assert listing == sorted(str(f) for f in fixtures.rglob("*.jpg"))
    assert isinstance(load_inference_source(str(fixtures / "*.jpg"), device="cpu"), LoadImagesAndVideos)
    (tmp_path / "clip.mp4").write_bytes(b"")
    shutil.copy(fixtures / "gray.jpg", tmp_path / "a.jpg")
    with pytest.raises(NotImplementedError, match="clip.mp4.*ROADMAP"):
        LoadImagesAndVideos(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        LoadImagesAndVideos(str(tmp_path / "missing.jpg"))
    (tmp_path / "clip.mp4").unlink()
    (tmp_path / "b.jpg").write_bytes(b"\xff\xd8\xff\xd9")  # a JPEG cv2.imread returns None for
    with pytest.raises(FileNotFoundError, match="unreadable image"):
        list(LoadImagesAndVideos(str(tmp_path)))
    for source in ("rtsp://camera/stream", 0, "screen 0"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            load_inference_source(source, device="cpu")
