"""The port's OBB trainer, validator, predictor and results against the JAX package's, on the CPU.

Two models, each with seeded leaves (BN statistics away from 0 and 1, the
class branches' last biases 0: scores near 0.5, so val and predict keep
detections; the tiny model's last class kernels 8x larger, so neighbouring
anchors' scores do not lie within a float32 step of each other, where the
packages' rounding would reorder val's ranking) and zero-mean conv kernels (flax's one-pass BN variance,
ROADMAP.md §3.34): yolo11n-obb at scale n with nc 2 for the train steps, and
a tiny OBB model (strided Convs, one C3k2, an OBB head over three levels)
for val and predict, whose JAX graphs trace in a second. A shapes-obb split
of 4 + 4 images at 96 px.

- The f32 train step of yolo11n-obb (SGD; updates at ni = 0 and 1, the
  second on the updated weights) against JAX's OBBTrainer step at 96 px, B
  = 2: the loss items (box, cls, dfl) within 1e-4 relative.
- Val on a copy of the val split labelled with the port's own rotated
  boxes at conf 0.5 (4-corner rows from the boxes' corners: a random model
  matches no drawn shape), save_json=True: results_dict (P, R, mAP50,
  mAP50-95, fitness) within 1e-4 of JAX's OBBValidator's on the same
  weights, the TP matrix equal, and neither package writing
  predictions.json (JAX's update_stats keeps no rows for rotated boxes,
  ROADMAP.md §3.38).
- Predict on three arrays of odd sizes: per image the detections equal in
  count and class, xywhr within 1e-3 px (and rad), the corners within 1e-3
  px; on JAX's detections, Results.plot with rotated boxes byte-equal to
  JAX's cv2.polylines drawing at line widths 1-3 and the default,
  save_txt's lines equal, the tables and verbose() JAX's.
- polylines: byte-equal to cv2.polylines (OpenCV 5.0.0), closed and open, at
  thickness 1-4, on quads with corners inside, on and past the image's
  edges; the committed digests of its cases and of box_points' corners of
  500 seeded boxes (float32 and truncated to int32)
  (tests/torch_data/obb/polylines_digests.json, rewritten by
  `PYTHONPATH=. python tests/test_torch_obb_engine.py`) hold the card's
  drawing in tests/test_torch_gpu.py and chip_smoke.py.
- The facade and the CLI: YOLO("yolo11n-obb.yaml") (nc 15, task obb in its
  overrides) set up by the trainer on the 2-class data rebuilds its head
  (its steps run in this file's train-step test, its epochs on the card in
  chip_smoke.py's phase `obb`); the tiny checkpoint trained an epoch through the
  facade writes JAX's results.csv columns and a checkpoint that reloads as
  an OBB model and that JAX reads (weights, EMA and optimizer state); `obb
  val` and `obb predict` go through cfg.entrypoint; AutoBatch
  probes an OBB model's step; `-cls` models, a served OBB model and an OBB
  ensemble raise as tabled.
"""

import csv
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_obb import jax_obb
from test_torch_pose_engine import BATCH, IMGSZ, ITEMS_RTOL, NB, PX_TOL, STEPS, VAL_TOL, XLA_OPTIONS, _seeded
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.cfg import entrypoint
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint
from spectrogram_yolov11_torch.engine.predictor import OBBPredictor
from spectrogram_yolov11_torch.engine.results import Results
from spectrogram_yolov11_torch.engine.trainer import OBBTrainer
from spectrogram_yolov11_torch.engine.validator import OBBValidator
from spectrogram_yolov11_torch.nn.autobackend import AutoBackend
from spectrogram_yolov11_torch.nn.tasks import build_model
from spectrogram_yolov11_torch.ops.boxes import box_points
from spectrogram_yolov11_torch.utils.autobatch import check_train_batch_size
from spectrogram_yolov11_torch.utils.plotting import polylines
from spectrogram_yolov11_tpu.engine import optim as jopt
from spectrogram_yolov11_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from spectrogram_yolov11_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from spectrogram_yolov11_tpu.engine.model import YOLO as JaxYOLO
from spectrogram_yolov11_tpu.engine.trainer import OBBTrainer as JaxOBBTrainer
from spectrogram_yolov11_tpu.engine.validator import OBBValidator as JaxOBBValidator
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.ops.metrics import OBBMetrics as JaxOBBMetrics

DIGESTS = Path(__file__).resolve().parent / "torch_data" / "obb" / "polylines_digests.json"
NAMES = {0: "box", 1: "bar"}
TINY_OBB = {"nc": 2, "scales": {"t": [1.0, 1.0, 1024]}, "scale": "t",
            "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                         [-1, 1, "C3k2", [16, True]], [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]]],
            "head": [[[3, 4, 5], 1, "OBB", ["nc", 1]]]}


def _tiny_variables() -> dict:
    """The tiny model's seeded variables, its class branches' last kernels 8x larger: the scores of
    neighbouring anchors, near 0.5, then lie 8 float32 steps or more apart where they would lie 1 apart, so a
    step of rounding between the packages does not reorder val's ranking."""
    v = _seeded(TINY_OBB)
    for i in range(3):
        v["params"]["model_6"]["detect"][f"cv3_{i}_2"]["kernel"] *= 8
    return v


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(root, the data dict, the tiny model's checkpoint written by JAX's save_checkpoint)."""
    root = tmp_path_factory.mktemp("obb_engine")
    data = {"path": str(root / "data"), "train": "images/train", "val": "images/val", "synthetic": "shapes-obb",
            "n_train": 4, "n_val": 4, "gen_imgsz": IMGSZ, "seed": 0, "names": NAMES}
    check_det_dataset(data)
    ckpt = root / "tiny.ckpt"
    jax_save_checkpoint(ckpt, variables=_tiny_variables(), ema_variables=None, opt_state=None, epoch=-1,
                        best_fitness=0.0, updates=0, train_args={}, model_yaml=dict(TINY_OBB), names=NAMES, nc=2)
    return root, data, ckpt


# -- training ---------------------------------------------------------------------

def _batch():
    rng = np.random.default_rng(2)
    g = 5
    cls = rng.integers(0, 2, (BATCH, g)).astype(np.int32)
    bboxes = np.concatenate([rng.uniform(0.3, 0.7, (BATCH, g, 2)), rng.uniform(0.1, 0.4, (BATCH, g, 2)),
                             rng.uniform(-1.5, 1.5, (BATCH, g, 1))], -1).astype(np.float32)
    mask = np.arange(g)[None] < np.array([[4], [2]])
    bboxes[~mask], cls[~mask] = 0, 0
    return {"img": rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8), "cls": cls, "bboxes": bboxes,
            "mask_gt": mask}


def _jax_items(data, jax_model, variables):
    """JAX's OBBTrainer step, compiled once, on the state its train() builds."""
    overrides = dict(data=data, imgsz=IMGSZ, batch=BATCH, amp=False, optimizer="SGD", workers=1,
                     project=str(data["path"]), exist_ok=True, plots=False)
    with pytest.MonkeyPatch.context() as mp:  # the JAX trainer's logging integrations touch no result
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        jt = JaxOBBTrainer(overrides=overrides, model=jax_model, variables=variables)
    jt.setup_model()
    wd = float(jt.args.weight_decay) * BATCH * max(round(jt.args.nbs / BATCH), 1) / jt.args.nbs
    opt = jopt.choose_optimizer(jt.args, 1, NB)
    groups = jopt.param_groups(variables["params"])
    spec = jopt.make_flat_spec(variables["params"], groups)
    copy = lambda t: jax.tree_util.tree_map(lambda x: jnp.array(x, jnp.float32, copy=True), t)  # noqa: E731
    state = {"params": copy(variables["params"]), "batch_stats": copy(variables["batch_stats"]),
             "opt": jopt.init_opt_state_flat(spec), "grad_buf": jnp.zeros((spec.n,), jnp.float32),
             "ema": {"params": copy(variables["params"]), "batch_stats": copy(variables["batch_stats"])},
             "ema_updates": jnp.asarray(0, jnp.int32)}
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    args = (jnp.asarray(STEPS[0][0], jnp.int32), jnp.asarray(STEPS[0][1]))
    step = jt._make_train_step(opt, groups, wd).lower(state, batch, *args).compile(compiler_options=XLA_OPTIONS)
    items = []
    for ni, do_step in STEPS:
        state, _, it = step(state, batch, jnp.asarray(ni, jnp.int32), jnp.asarray(do_step))
        items.append(np.asarray(it))
    return items


def test_train_steps_match_jax(setup):
    _, data, _ = setup
    d, jm, _ = jax_obb(2)
    variables = _seeded(d)
    ref = _jax_items(data, jm, variables)
    t = OBBTrainer(build_model(dict(d), variables=variables),
                   dict(data=data, imgsz=IMGSZ, batch=BATCH, amp=False, optimizer="SGD", device="cpu"))
    t.setup_model()
    t.setup_optimizer(NB)
    assert t.rebuilt is None and t.loss_names == tuple(JaxOBBTrainer.loss_names.fget(None))
    for (ni, do_step), r in zip(STEPS, ref):
        got = t.train_step(_batch(), ni, do_step)[1].numpy()
        print(f"ni {ni}: items {got.tolist()} (JAX {r.tolist()})")
        assert got.shape == (3,) and (r > 0).all()
        np.testing.assert_allclose(got, r, rtol=ITEMS_RTOL, atol=0)


# -- val ----------------------------------------------------------------------------

def _self_labelled(data: dict, ckpt: Path, root: Path) -> dict:
    """A copy of the val split labelled with the port's rotated boxes at conf 0.5 (at most 6 per image), each
    a row of its class and normalised corners."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    files = sorted(Path(data["path"], "images", "val").glob("*.jpg"))
    for f in files:
        (root / "images" / f.name).write_bytes(f.read_bytes())
    res = YOLO(ckpt, device="cpu").predict(str(root / "images"), imgsz=IMGSZ, conf=0.5, max_det=6, save=False)
    for f, r in zip(files, res):
        rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in xy.reshape(-1))
                for xy, c in zip(r.obb.xyxyxyxyn, r.obb.cls)]
        (root / "labels" / f"{f.stem}.txt").write_text("\n".join(rows))
    return {"path": str(root), "train": "images", "val": "images", "names": NAMES}


@pytest.fixture(scope="module")
def jax_yolo(setup):
    """JAX's facade on the tiny checkpoint, its logging integrations off (the TensorBoard one imports TensorFlow)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        return JaxYOLO(str(setup[2]))


@pytest.fixture(scope="module")
def vals(setup, jax_yolo):
    root, data, ckpt = setup
    split = _self_labelled(data, ckpt, root / "val_split")
    kw = dict(data=split, imgsz=IMGSZ, batch=BATCH, plots=False, save_json=True, workers=1)
    jres = jax_yolo.val(**kw, project=str(root / "val_jax"))
    py = YOLO(ckpt, device="cpu")
    return py.val(**kw, project=str(root / "val_port")), py.validator, jres, jax_yolo.validator, root


def test_val_rotated_map_equals_jax(vals):
    got, pv, ref, jv, root = vals
    assert isinstance(pv, OBBValidator) and isinstance(jv, JaxOBBValidator)
    assert list(got) == list(ref) == [*JaxOBBMetrics().keys, "fitness"]
    for k, v in ref.items():
        assert abs(got[k] - v) <= VAL_TOL, (k, got[k], v)
    tp = np.concatenate(pv.stats["tp"])
    np.testing.assert_array_equal(tp, np.concatenate(jv.stats["tp"]))
    print({k: round(v, 5) for k, v in got.items()})
    assert len(tp) > 10 and got["metrics/mAP50-95(B)"] > 0.5
    assert not pv.jdict and not jv.jdict and not list(root.glob("val_*/**/predictions.json"))


# -- predict and the results --------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((70, 90), (96, 64), (120, 150))]


@pytest.fixture(scope="module")
def predictions(setup, jax_yolo):
    _, _, ckpt = setup
    kw = dict(imgsz=IMGSZ, conf=0.3, save=False)
    ref = jax_yolo.predict(_arrays(), **kw)
    port = YOLO(ckpt, device="cpu")
    got = port.predict(_arrays(), batch=2, **kw)
    assert isinstance(port.predictor, OBBPredictor)
    return got, ref


def test_predict_rotated_boxes_match_jax(predictions):
    got, ref = predictions
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert len(g) == len(r) > 0 and g.boxes is None
        np.testing.assert_array_equal(g.obb.cls, r.obb.cls)
        np.testing.assert_allclose(g.obb.xywhr, r.obb.xywhr, atol=PX_TOL, rtol=0)
        np.testing.assert_allclose(g.obb.conf, r.obb.conf, atol=1e-6, rtol=0)
        for name in ("xyxyxyxy", "xyxyxyxyn", "xyxy"):
            np.testing.assert_allclose(getattr(g.obb, name), getattr(r.obb, name), atol=PX_TOL, rtol=0, err_msg=name)


def test_results_plot_txt_and_tables_equal_jax(predictions, tmp_path):
    _, ref = predictions
    for i, r in enumerate(ref):
        ours = Results(r.orig_img, r.path, r.names, obb=r.obb.data)
        for lw in (None, 1, 2, 3):
            got, want = ours.plot(line_width=lw), r.plot(line_width=lw)
            assert got.dtype == want.dtype and np.array_equal(got, want), lw
        for conf in (False, True):
            ours.save_txt(tmp_path / f"p{i}{conf}.txt", save_conf=conf)
            r.save_txt(tmp_path / f"j{i}{conf}.txt", save_conf=conf)
            assert (tmp_path / f"p{i}{conf}.txt").read_text() == (tmp_path / f"j{i}{conf}.txt").read_text()
        assert ours.to_json() == r.to_json() == "[]" and ours.verbose() == r.verbose()
        sub, jsub = ours[1:3], r[1:3]
        assert np.array_equal(sub.obb.data, jsub.obb.data) and len(sub) == len(jsub)
    upd, jupd = Results(ref[0].orig_img, "x", NAMES), ref[0].new()
    for res in (upd, jupd):
        res.update(obb=ref[0].obb.data[:1])
    assert len(upd) == len(jupd) == 1 and upd.verbose() == jupd.verbose()


# -- polylines against cv2 and its digests --------------------------------------------

def polyline_cases() -> list:
    """{name, seed, size, pts, closed, thickness, color} of every drawn case: quads and open paths of 2-5
    points inside, on and past the edges of a 40 x 48 canvas, at thickness 1-4."""
    rng = np.random.default_rng(7)
    out = []
    for t in range(1, 5):
        for j in range(10):
            n = 4 if j < 6 else int(rng.integers(2, 6))
            lo, hi = ((0, 40) if j < 3 else (-15, 60))
            pts = rng.integers(lo, hi, (n, 2))
            if j == 2:
                pts[:, 0] = [0, 47, 47, 0]  # corners on the edges
                pts[:, 1] = [0, 0, 39, 39]
            out.append({"name": f"poly_t{t}_{j}", "seed": 10 * t + j, "size": [40, 48], "pts": pts.tolist(),
                        "closed": j < 8, "thickness": t, "color": [0, 0, 255] if j % 2 else [255, 111, 221]})
    return out


def _polylines(cases: list, port: bool) -> dict:
    import cv2

    out = {}
    for c in cases:
        img = np.random.default_rng(c["seed"]).integers(0, 256, (*c["size"], 3), dtype=np.uint8)
        pts, color = np.asarray(c["pts"], np.int32), tuple(c["color"])
        out[c["name"]] = polylines(img, pts, c["closed"], color, c["thickness"]) if port else \
            cv2.polylines(img, [pts], c["closed"], color, c["thickness"])
    return out


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def box_point_rects(seed: int = 11, n: int = 500) -> list:
    """n seeded ((cx, cy), (w, h), angle in degrees) rectangles of any size, place and angle."""
    rng = np.random.default_rng(seed)
    return [((float(c[0]), float(c[1])), (float(wh[0]), float(wh[1])), float(a))
            for c, wh, a in zip(rng.uniform(-50, 700, (n, 2)), rng.uniform(0, 300, (n, 2)), rng.uniform(-360, 360, n))]


def _box_points(port: bool) -> np.ndarray:
    import cv2

    return np.stack([box_points(r) if port else cv2.boxPoints(r) for r in box_point_rects()])


def test_polylines_equal_cv2_and_its_digests():
    blob = json.loads(DIGESTS.read_text())
    assert blob["cases"] == polyline_cases()
    ours, theirs = _polylines(blob["cases"], True), _polylines(blob["cases"], False)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), k
    assert {k: _sha(v) for k, v in ours.items()} == blob["sha256"]
    pts = _box_points(True)
    assert np.array_equal(pts, _box_points(False)) and pts.dtype == np.float32
    assert blob["box_points"] == {"seed": 11, "n": 500, "sha256_f32": _sha(pts), "sha256_i32": _sha(pts.astype(np.int32))}


def make_fixtures() -> None:
    """Rewrite tests/torch_data/obb/polylines_digests.json: the cases and the
    SHA-256 of cv2's polylines for each."""
    import cv2

    DIGESTS.parent.mkdir(parents=True, exist_ok=True)
    made = (f"PYTHONPATH=. python tests/test_torch_obb_engine.py (make_fixtures): the SHA-256 of cv2 {cv2.__version__}"
            "'s cv2.polylines(img, [pts], closed, color, thickness) for each case (img: default_rng(seed).integers("
            "0, 256, (*size, 3), uint8)), and of cv2.boxPoints of box_point_rects(seed, n) stacked, as float32 and "
            "as int32")
    cases = polyline_cases()
    pts = _box_points(False)
    DIGESTS.write_text(json.dumps({"made": made, "cases": cases,
                                   "sha256": {k: _sha(v) for k, v in _polylines(cases, False).items()},
                                   "box_points": {"seed": 11, "n": 500, "sha256_f32": _sha(pts),
                                                  "sha256_i32": _sha(pts.astype(np.int32))}}, indent=1) + "\n")


# -- the facade, the CLI and the refusals -----------------------------------------------

def test_facade_and_cli_run_the_obb_task(setup, tmp_path):
    root, data, ckpt = setup
    m = YOLO("yolo11n-obb.yaml", device="cpu")
    assert m.task == "obb" and m.overrides["task"] == "obb" and m.model.nc == 15
    t = OBBTrainer(m.model, {**m.overrides, "data": data, "imgsz": IMGSZ, "project": str(tmp_path / "runs")})
    t.setup_model()
    assert t.rebuilt["nc"] == (15, 2) and t.rebuilt["grafted"] > 400 and t.save_dir.parent.name == "runs"
    # an epoch of the tiny model through the facade; the port's checkpoint read by JAX: the model built from its
    # model dict takes the weights and the EMA (a mismatched leaf fails flax's apply), and JAX's resume takes the
    # optimizer state
    tiny = YOLO(ckpt, device="cpu")
    res = tiny.train(data=data, epochs=1, batch=BATCH, imgsz=IMGSZ, plots=False, project=str(tmp_path / "runs"),
                     name="tiny", workers=1, amp=False)
    assert list(res) == [*JaxOBBMetrics().keys, "fitness"]
    with open(tmp_path / "runs" / "tiny" / "results.csv") as f:
        assert next(csv.reader(f)) == ["epoch", *(f"train/{n}" for n in JaxOBBTrainer.loss_names.fget(None)),
                                       *JaxOBBMetrics().keys, "fitness"]
    best = tmp_path / "runs" / "tiny" / "weights" / "best.ckpt"
    assert load_checkpoint(best)[1]["nc"] == 2
    back = YOLO(best, device="cpu")
    assert back.task == "obb" and back.model.nc == 2
    tree, meta = jax_load_checkpoint(tmp_path / "runs" / "tiny" / "weights" / "last.ckpt")
    jm = jax_build_model(meta["model_yaml"], nc=meta["nc"], verbose=False)
    for v in (tree["variables"], tree["ema"]):
        out = jax.eval_shape(lambda w: jm.apply(w, jnp.zeros((1, IMGSZ, IMGSZ, 3))), v)
        assert out[1].shape == (1, 189, 1)
    spec = jopt.make_flat_spec(tree["variables"]["params"], jopt.param_groups(tree["variables"]["params"]))
    assert jopt.flat_opt_state(jopt.OptState(**tree["opt_state"]), spec).mu.shape == (spec.n,)
    y = Path(data["path"]) / "d.yaml"
    y.write_text(f"path: {data['path']}\ntrain: images/train\nval: images/val\nnames:\n  0: box\n  1: bar\n")
    out = entrypoint(f"yolo obb val model={ckpt} data={y} imgsz={IMGSZ} batch=2 device=cpu plots=False "
                     f"project={tmp_path / 'cli'}")
    assert list(out) == list(res)
    pred = entrypoint(f"yolo obb predict model={ckpt} source={data['path']}/images/val imgsz={IMGSZ} device=cpu "
                      f"save=False conf=0.3")
    assert len(pred) == 4 and all(r.obb is not None and r.boxes is None for r in pred)
    probes = {}
    assert check_train_batch_size(YOLO(ckpt, device="cpu").model, imgsz=32, nc=2, probes=probes) >= 16 and probes[16]
    # the classify task builds since its slice (tests/test_torch_classify*.py); a checkpoint's own head names its
    # task; the AutoBackend of an obb checkpoint runs the obb serving graph (held to JAX's in
    # tests/test_torch_serve_tasks.py)
    for model in ("yolo11n-cls.yaml", "yolo11s-cls.yaml"):
        cls_model = YOLO(model)
        assert cls_model.task == "classify" and cls_model.model.nc == 1000
    assert YOLO(str(ckpt), task="classify").task == "obb"
    backend = AutoBackend(str(ckpt), device="cpu")
    assert backend.task == "obb" and backend.forward(np.zeros((1, IMGSZ, IMGSZ, 3), np.uint8)).shape == (1, 189, 7)
    with pytest.raises(AssertionError, match="detect task"):
        YOLO([str(ckpt), str(ckpt)])


if __name__ == "__main__":
    make_fixtures()
    print(f"wrote {DIGESTS}")
