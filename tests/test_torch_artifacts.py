"""Val and training artifacts on the port against the JAX package's, on the CPU.

- plot_images: the bytes equal JAX's plot_images (cv2 drawing, resize and
  JPEG) on a batch of the port's train loader (its device-augment images
  assembled by ops/device_augment.py, as the trainer does), on 16 seeded
  496 px tiles whose 1984 px canvas is resized to 1920, with boxes that run
  off their tiles, and on 5 tiles in a 3 x 2 grid.
- COCOeval: the 12 stats equal JAX's to 1e-12 on seeded rows that hit every
  area range, crowd ground truth and the max_dets cuts (an image with more
  than 100 detections).
- _pred_to_json / _gt_to_json: the same rows as JAX's for the same
  detections, numeric and other file stems.
- The label cache: the port's bytes equal JAX's, and each package reads the
  other's cache without rewriting it (st_mtime_ns unchanged), the same labels.
- YOLO.embed within 1e-5 of JAX's (8 JPEG frames at 64 px); YOLO.profile's
  rows' i, type and params equal to JAX's, read from the specs and parameter
  tree JAX's profile reads (its 28 per-layer compiles take about 17 s on the CPU).
- autobatch chooses what JAX's chooses on the same probe table and memory
  (hypothesis); check_train_batch_size on the CPU follows that rule on its own
  probes; and train(batch=-1, plots=True, profile=True) trains at the chosen
  batch, writes train_batch0..2.jpg byte-equal to JAX's plot_images of the
  batches it drew, results.png at JAX's pixel size and a trace.
- The charts: each series' pixel at each mapped data point, or one within 1
  px, carries its colour where no later series or the legend covers it; the
  heatmap's cells carry "Blues" at their values, so they are ordered as their
  values; the file names and pixel sizes are JAX's
  (tests/test_torch_validator.py holds the val's charts to JAX's files).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_train_step import TINY
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_torch.utils.autobatch as port_autobatch
import spectrogram_yolov11_torch.utils.plotting as port_plotting
import spectrogram_yolov11_tpu.utils.autobatch as jax_autobatch
import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.cfg import DEFAULT_CFG_DICT, get_cfg
from spectrogram_yolov11_torch.data.build import DataLoader
from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset
from spectrogram_yolov11_torch.data.imageio import imencode, imread, imwrite
from spectrogram_yolov11_torch.engine.trainer import AUG_KEYS, DetectionTrainer
from spectrogram_yolov11_torch.engine.validator import DetectionValidator
from spectrogram_yolov11_torch.nn.tasks import build_model
from spectrogram_yolov11_torch.ops.cocoeval import COCOeval
from spectrogram_yolov11_torch.ops.device_augment import augment_batch
from spectrogram_yolov11_tpu import YOLO as JaxYOLO
from spectrogram_yolov11_tpu.data.dataset import YOLODataset as JaxYOLODataset
from spectrogram_yolov11_tpu.engine.validator import DetectionValidator as JaxDetectionValidator
from spectrogram_yolov11_tpu.ops.cocoeval import COCOeval as JaxCOCOeval
from spectrogram_yolov11_tpu.utils.plotting import plot_images as jax_plot_images
from spectrogram_yolov11_tpu.utils.plotting import plot_results as jax_plot_results

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
JPEG_VAL = ROOT / "tests" / "torch_data" / "jpeg" / "spectrogram" / "images" / "val"
NAMES = {0: "LTE", 1: "RF"}
IMGSZ = 64
EMBED_TOL = 1e-5


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("artifacts")
    d = {"path": str(root / "data"), "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
         "n_train": 16, "n_val": 2, "gen_imgsz": IMGSZ, "seed": 0, "names": NAMES}
    check_det_dataset(d)
    return root, d


# -- plot_images ---------------------------------------------------------------

def _loader_batch(d) -> dict:
    """One batch of 4 from the port's train loader, its images assembled as the trainer's plot assembles them."""
    args = get_cfg(DEFAULT_CFG_DICT, {"imgsz": IMGSZ})
    ds = YOLODataset(check_det_dataset(d)["train"], imgsz=IMGSZ, max_gt=0, augment=True, hyp=args)
    batch = next(iter(DataLoader(ds, 4, workers=1, shuffle=True, seed=0, drop_last=True)))
    batch = {k: v.numpy() if torch.is_tensor(v) else v for k, v in batch.items()}
    img = augment_batch(*(torch.from_numpy(np.asarray(batch[k])) for k in AUG_KEYS)).to(torch.uint8).numpy()
    return {**batch, "img": img}


def _seeded_batch(n: int, size: int, seed: int) -> dict:
    """n seeded noise tiles with 6 boxes each (4 valid), some running off the tile."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, size, size, 3), np.uint8)
    xy, wh = rng.uniform(-0.1, 1.1, (n, 6, 2)), rng.uniform(0.05, 0.9, (n, 6, 2))
    bboxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.zeros((n, 6), bool)
    mask[:, :4] = True
    return {"img": img, "bboxes": bboxes, "cls": rng.integers(0, 25, (n, 6)).astype(np.int32), "mask_gt": mask}


@pytest.mark.parametrize("case", ["loader", "16x496_resized", "5x96"])
def test_plot_images_bytes_equal_jax(case, data, tmp_path):
    batch = {"loader": lambda: _loader_batch(data[1]), "16x496_resized": lambda: _seeded_batch(16, 496, 1),
             "5x96": lambda: _seeded_batch(5, 96, 2)}[case]()
    ours = port_plotting.plot_images(batch, NAMES, tmp_path / "port" / "b.jpg")
    theirs = jax_plot_images(batch, NAMES, tmp_path / "jax" / "b.jpg")
    canvas = port_plotting.images_mosaic(batch)
    assert canvas.shape[:2] == ({"16x496_resized": (1920, 1920), "5x96": (192, 288)}.get(case, canvas.shape[:2]))
    assert ours.read_bytes() == theirs.read_bytes() == imencode(".jpg", canvas)


def test_plot_images_obb_raises(tmp_path):
    """Rotated boxes (the obb task's mosaics) no longer raise: their corners (box_points) drawn by polylines,
    byte-equal to JAX's cv2.boxPoints and cv2.polylines (tests/test_torch_obb_engine.py holds polylines)."""
    batch = _seeded_batch(5, 96, 3)
    angles = np.random.default_rng(4).uniform(-np.pi / 2, np.pi / 2, (5, 6, 1)).astype(np.float32)
    batch["bboxes"] = np.concatenate([batch["bboxes"], angles], -1)
    ours = port_plotting.plot_images(batch, NAMES, tmp_path / "port" / "b.jpg")
    theirs = jax_plot_images(batch, NAMES, tmp_path / "jax" / "b.jpg")
    canvas = port_plotting.images_mosaic(batch)
    assert ours.read_bytes() == theirs.read_bytes() == imencode(".jpg", canvas)
    plain = port_plotting.images_mosaic(dict(batch, mask_gt=np.zeros_like(batch["mask_gt"])))
    assert (canvas != plain).any()


# -- COCO ------------------------------------------------------------------------

def _coco_rows(seed: int):
    """Ground truth over 6 images and 3 categories at small, medium and large
    areas, some crowd; detections near them and elsewhere, 130 on image 0."""
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for img in range(6):
        for _ in range(rng.integers(1, 8)):
            side = rng.choice([rng.uniform(4, 30), rng.uniform(34, 94), rng.uniform(100, 300)])
            box = [float(rng.uniform(0, 500)), float(rng.uniform(0, 500)), float(side),
                   float(side * rng.uniform(0.5, 2))]
            gts.append({"image_id": img, "category_id": int(rng.integers(0, 3)), "bbox": box,
                        "iscrowd": int(rng.random() < 0.15)})
            for _ in range(rng.integers(0, 3)):
                jit = rng.normal(0, 0.1 * side, 4)
                dts.append({"image_id": img, "category_id": gts[-1]["category_id"] if rng.random() < 0.8 else
                            int(rng.integers(0, 3)), "bbox": [float(v) for v in np.abs(np.array(box) + jit)],
                            "score": round(float(rng.random()), 5)})
        for _ in range(130 if img == 0 else int(rng.integers(0, 20))):
            box = [float(v) for v in rng.uniform([0, 0, 2, 2], [500, 500, 200, 200])]
            dts.append({"image_id": img, "category_id": int(rng.integers(0, 3)), "bbox": box,
                        "score": round(float(rng.random()), 5)})
    return gts, dts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cocoeval_stats_equal_jax(seed):
    gts, dts = _coco_rows(seed)
    ours, theirs = COCOeval(gts, dts).evaluate(), JaxCOCOeval(gts, dts).evaluate()
    assert list(ours.stats) == list(theirs.stats) and len(ours.stats) == 12
    for k, v in ours.stats.items():
        assert abs(v - theirs.stats[k]) <= 1e-12, (k, v, theirs.stats[k])
    assert all(v > -1 for v in ours.stats.values())  # every area range and cut has ground truth and a value
    assert len([d for d in dts if d["image_id"] == 0]) > 100
    with pytest.raises(NotImplementedError, match="item 10"):  # segm and keypoints run since their tasks
        COCOeval(gts, dts, iou_type="obb")  # (test_torch_segment.py, test_torch_pose.py)


@pytest.mark.parametrize("stem", ["000123", "frame_7"])
def test_json_rows_equal_jax(stem):
    rng = np.random.default_rng(5)
    det = np.concatenate([np.sort(rng.uniform(0, 600, (7, 4)), 1), rng.random((7, 1)), rng.integers(0, 2, (7, 1))],
                         1).astype(np.float32)
    gt_cls, gxyxy = rng.integers(0, 2, 5), np.sort(rng.uniform(0, 600, (5, 4)), 1)
    rows = []
    for cls in (DetectionValidator, JaxDetectionValidator):
        v = cls.__new__(cls)
        v.jdict, v.gt_jdict, v._cur_im_file = [], [], f"/data/images/val/{stem}.png"
        cls._pred_to_json(v, det)
        cls._gt_to_json(v, gt_cls, gxyxy)
        rows.append((v.jdict, v.gt_jdict))
    assert rows[0] == rows[1] and len(rows[0][0]) == 7 and len(rows[0][1]) == 5
    assert rows[0][0][0]["image_id"] == (123 if stem.isnumeric() else stem)


# -- the label cache ---------------------------------------------------------------

def test_label_cache_bytes_and_sharing_equal_jax(tmp_path):
    root = tmp_path / "split"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(3)
    for i in range(5):
        imwrite(root / "images" / f"{i:03d}.png", np.zeros((8, 8, 3), np.uint8))
        if i == 4:
            continue  # no label file
        rows = [f"{c} {x:.6f} {y:.6f} {w:.6f} {h:.6f}" for c, (x, y, w, h) in
                zip(rng.integers(0, 2, i + 1), rng.uniform(0.05, 0.95, (i + 1, 4)))]
        rows += ["1 0.5 0.5", "0 0.5 0.5 0 0.2", "x 0.5 0.5 0.2 0.2"]  # short, zero width, bad class
        (root / "labels" / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    cache = root / "images.labels.detect.json"
    ours = YOLODataset(root / "images")
    port_bytes = cache.read_bytes()
    cache.unlink()
    theirs = JaxYOLODataset(root / "images", nc=2)
    assert cache.read_bytes() == port_bytes
    for a, b in zip(ours.labels, theirs.labels):
        np.testing.assert_array_equal(a["cls"], b["cls"])
        np.testing.assert_array_equal(a["xywhn"], b["xywhn"])
    mtime = cache.stat().st_mtime_ns
    for reader in (lambda: YOLODataset(root / "images"), lambda: JaxYOLODataset(root / "images", nc=2)):
        again = reader()
        assert cache.stat().st_mtime_ns == mtime and cache.read_bytes() == port_bytes
        assert all(np.array_equal(a["xywhn"], b["xywhn"]) for a, b in zip(again.labels, ours.labels))
    cache.write_text(json.dumps({"hash": "stale", "labels": []}))
    assert [len(lab["cls"]) for lab in YOLODataset(root / "images").labels] == [1, 2, 3, 4, 0]
    assert cache.read_bytes() == port_bytes  # rewritten from the txts


# -- embed and profile ----------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())  # the facade's TensorBoard import costs seconds
        return YOLO(CKPT, device="cpu"), JaxYOLO(str(CKPT))


def test_embed_matches_jax(models):
    port, jax_model = models
    ours, theirs = port.embed(str(JPEG_VAL), imgsz=IMGSZ), jax_model.embed(str(JPEG_VAL), imgsz=IMGSZ)
    assert len(ours) == len(theirs) == 8
    worst = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(ours, theirs))
    print(f"embed: {ours[0].shape} per image, worst distance to JAX {worst:.2e}")
    assert all(a.dtype == np.float32 and a.shape == np.asarray(b).shape for a, b in zip(ours, theirs))
    assert worst <= EMBED_TOL
    two = port.embed(str(JPEG_VAL), embed=[6, 8], imgsz=IMGSZ)
    assert two[0].shape == (port.model.model[6].cv2.conv.out_channels + port.model.model[8].cv2.conv.out_channels,)


def _jax_profile_rows(jax_model) -> list:
    """The (i, type, params) of JAX's profile rows (nn/tasks.py:603-666), from
    the specs and the parameter tree it reads, by its own expressions: JAX's
    profile compiles every layer for its FLOPs, about 17 s on the CPU."""
    params = jax_model.variables["params"]
    rows = []
    for spec in jax_model.model.specs:
        names = [f"model_{spec.i}_{j}" for j in range(spec.n)] if spec.n > 1 else [f"model_{spec.i}"]
        n = sum(int(np.prod(p.shape)) for name in names if spec.cls is not None
                for p in jax.tree_util.tree_leaves(params.get(name, {})))
        rows.append((spec.i, spec.type, n))
    return rows


def test_profile_rows_match_jax(models):
    port, jax_model = models
    ours = port.profile(imgsz=32, timed=True)
    assert [(r["i"], r["type"], r["params"]) for r in ours] == _jax_profile_rows(jax_model)
    assert sum(r["params"] for r in ours) == sum(p.numel() for p in port.model.parameters())
    assert all(r["ms"] > 0 for r in ours)
    gflops = sum(r["gflops"] for r in port.profile(imgsz=64, timed=False))
    assert abs(gflops - port.model.get_flops(64)) <= 1e-6 * gflops  # the layers' counts add up to get_flops'


# -- AutoBatch ------------------------------------------------------------------------

BATCHES = (16, 32, 64, 128, 256)


@settings(max_examples=100, deadline=None, database=None)
@given(readings=st.lists(st.one_of(st.none(), st.integers(1, 2**40)), min_size=5, max_size=5),
       total=st.integers(2**20, 2**41), fraction=st.sampled_from([0.3, 0.6, 0.9]))
def test_autobatch_chooses_as_jax(readings, total, fraction):
    table = dict(zip(BATCHES, readings))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_autobatch, "estimate_step_memory", lambda lowerable, b: table[b])
        mp.setattr(jax_autobatch, "device_memory_bytes", lambda: total)
        mp.setattr(port_autobatch, "device_memory_bytes", lambda device=None: total)
        probes = {}
        ours = port_autobatch.autobatch(table.__getitem__, fraction=fraction, probes=probes)
        assert ours == jax_autobatch.autobatch(None, fraction=fraction)
    assert list(probes) == list(BATCHES[: len(probes)])  # probed upwards, and no further than the first miss


def _recording_plots(mp) -> list:
    drawn, inner = [], port_plotting.plot_images

    def record(batch, names, path, **kw):
        drawn.append(({k: np.asarray(v) for k, v in batch.items() if k in ("img", "cls", "bboxes", "mask_gt")},
                      dict(names), Path(path)))
        return inner(batch, names, path, **kw)

    mp.setattr(port_plotting, "plot_images", record)
    return drawn


def test_autobatch_train_plots_and_profile(data, tmp_path, monkeypatch):
    root, d = data
    model = build_model(TINY).init(0)
    probes = {}
    assert port_autobatch.check_train_batch_size(model, imgsz=IMGSZ, nc=2, probes=probes) == 256  # 16 GiB: all fit
    assert list(probes) == list(BATCHES) and all(probes[a] < probes[b] for a, b in zip(BATCHES, BATCHES[1:]))
    # a memory where 32 fits and 64 does not: the CPU probes follow JAX's rule
    monkeypatch.setattr(port_autobatch, "device_memory_bytes", lambda device=None: (probes[32] + probes[64]) / 2 / 0.6)
    assert port_autobatch.check_train_batch_size(model, imgsz=IMGSZ, nc=2) == 32
    # train(batch=-1) where only 16 fits: one step per epoch, so three epochs draw train_batch0..2
    monkeypatch.setattr(port_autobatch, "device_memory_bytes", lambda device=None: (probes[16] + probes[32]) / 2 / 0.6)
    drawn = _recording_plots(monkeypatch)
    trainer = DetectionTrainer(model, {"data": d, "device": "cpu", "epochs": 3, "imgsz": IMGSZ, "batch": -1,
                                       "workers": 1, "profile": True, "amp": False, "project": str(tmp_path),
                                       "name": "run", "close_mosaic": 0})
    metrics = trainer.train()
    assert all(np.isfinite(v) for v in metrics.values())
    assert trainer.batch_size == trainer.autobatch["batch"] == 16 and list(trainer.autobatch["probes"]) == [16, 32]
    run = tmp_path / "run"
    assert [p for _, _, p in drawn] == [run / f"train_batch{i}.jpg" for i in range(3)]
    for i, (batch, names, path) in enumerate(drawn):
        assert batch["img"].shape == (16, IMGSZ, IMGSZ, 3) and batch["img"].dtype == np.uint8
        theirs = jax_plot_images(batch, names, tmp_path / "jax" / path.name)
        assert path.read_bytes() == theirs.read_bytes(), path.name
    jax_plot_results(run / "results.csv", tmp_path / "jax")
    assert imread(run / "results.png").shape == imread(tmp_path / "jax" / "results.png").shape == (720, 2400, 3)
    trace = json.loads((run / "profile" / "train.pt.trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert "aten::convolution" in names and "aten::convolution_backward" in names
    assert not list((run / "weights").glob("*.json")) and {p.name for p in run.iterdir()} >= {
        "results.csv", "results.png", "train_batch0.jpg", "weights", "profile"}


# -- charts -------------------------------------------------------------------------

def _segment_distance(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,) distance from each point to the nearest of the segments a[k] -> b[k]."""
    d = b - a
    t = np.clip(((p[:, None] - a[None]) * d[None]).sum(-1) / np.maximum((d * d).sum(-1), 1e-12)[None], 0, 1)
    return np.sqrt((((a[None] + t[..., None] * d[None]) - p[:, None]) ** 2).sum(-1)).min(1)


def assert_series_drawn(chart, series) -> list:
    """series: (x, y, rgb, width) in drawing order. Each mapped data point
    inside the axes, off the legend and more than 3 px from every later
    series' polyline has a pixel of its series' colour within 1 px. Returns
    the count of points checked per series."""
    x0, y0, x1, y1 = chart.box
    lb = chart.legend_box
    checked = []
    for s, (x, y, rgb, _) in enumerate(series):
        p = np.stack(chart.to_px(x, y), -1)[::3]
        keep = (p[:, 0] >= x0 + 1) & (p[:, 0] <= x1 - 1) & (p[:, 1] >= y0 + 1) & (p[:, 1] <= y1 - 1)
        if lb is not None:
            keep &= ~((p[:, 0] >= lb[0] - 2) & (p[:, 0] <= lb[2] + 2) & (p[:, 1] >= lb[1] - 2) & (p[:, 1] <= lb[3] + 2))
        for lx, ly, _, lw in series[s + 1 :]:
            q = np.stack(chart.to_px(lx, ly), -1)
            keep &= _segment_distance(p, q[:-1], q[1:]) > 3 + lw // 2
        bgr = np.array(rgb[::-1], np.uint8)
        for cx, cy in np.rint(p[keep]).astype(int):
            win = chart.img[cy - 1 : cy + 2, cx - 1 : cx + 2]
            assert (win == bgr).all(-1).any(), (s, rgb, cx, cy)
        checked.append(int(keep.sum()))
    return checked


def assert_heatmap_ordered(chart, matrix: np.ndarray, normalize: bool) -> None:
    """Each cell's median colour is Blues at its value (0 to the maximum), so cells are ordered as their values."""
    m = matrix.astype(np.float64)
    if normalize:
        m = m / (m.sum(0, keepdims=True) + 1e-9)
    n, half = m.shape[0], (chart.box[2] - chart.box[0]) / m.shape[0] / 2 - 4
    lum = np.zeros(m.shape)
    for i in range(n):
        for j in range(n):
            cx, cy = (int(round(float(v))) for v in chart.to_px(j, i))
            cell = chart.img[int(cy - half) : int(cy + half), int(cx - half) : int(cx + half)].reshape(-1, 3)
            med = np.median(cell, 0).astype(np.uint8)
            want = port_plotting.BLUES_LUT[min(int(m[i, j] / m.max() * 256), 255)][::-1]
            assert np.array_equal(med, want), (i, j, med, want)
            lum[i, j] = med.astype(float) @ [0.114, 0.587, 0.299]
    order = np.argsort(m.ravel(), kind="stable")
    assert np.all(np.diff(lum.ravel()[order]) <= 0)  # larger values are drawn darker


def _curves(seed: int):
    x = np.linspace(0, 1, 1000)
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(1.5, 4, 2)
    p = np.stack([np.clip(1 - x ** a, 0, 1), np.clip(0.8 - 0.5 * x ** b, 0, 1)])
    r = np.stack([np.clip(1 - x, 0, 1), np.clip(1 - x ** 0.5, 0, 1)])
    return x, p, r


@pytest.mark.parametrize("seed", [0, 1])
def test_curve_charts_draw_their_series(seed, tmp_path):
    x, p, r = _curves(seed)
    f1 = 2 * p * r / (p + r + 1e-16)
    ap = np.random.default_rng(seed).random((2, 10))
    pr = port_plotting.render_pr_curve(p, r, ap, NAMES)
    checked = assert_series_drawn(pr, [(r[c], p[c], port_plotting.CYCLE[c], 1) for c in range(2)])
    mc = port_plotting.render_mc_curve(x, f1, NAMES, "F1")
    checked += assert_series_drawn(mc, [(x, f1[0], port_plotting.CYCLE[0], 1), (x, f1[1], port_plotting.CYCLE[1], 1),
                                        (x, f1.mean(0), port_plotting.BLUE, 3)])
    print("points checked per series:", checked)
    assert min(checked) >= 50
    written = port_plotting.plot_mc_curve(x, f1, NAMES, tmp_path, "F1")
    assert written.name == "F1_curve.png" and np.array_equal(imread(written), mc.img)


@pytest.mark.parametrize("normalize", [True, False])
def test_confusion_matrix_cells_ordered_as_values(normalize, tmp_path):
    matrix = np.random.default_rng(4).integers(0, 30, (4, 4)).astype(np.float64)
    matrix[0, 1] = 0
    chart = port_plotting.render_confusion_matrix(matrix, {0: "a", 1: "b", 2: "c"}, normalize)
    assert chart.img.shape == (1050, 1200, 3)
    assert_heatmap_ordered(chart, matrix, normalize)
    out = port_plotting.plot_confusion_matrix(matrix, {0: "a", 1: "b", 2: "c"}, tmp_path, normalize)
    assert out.name == ("confusion_matrix_normalized.png" if normalize else "confusion_matrix.png")
    assert np.array_equal(imread(out), chart.img)
