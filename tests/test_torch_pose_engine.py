"""The port's pose trainer, validator, predictor and results against the JAX package's, on the CPU.

Two models, each with the shapes128-pose layout (5, 3), nc = 1, and seeded
leaves (BN statistics away from 0 and 1, the class branches' last biases 0:
scores near 0.5, so val and predict keep detections): yolo11n-pose at scale
n for the train steps and a tiny pose model (strided Convs, one C3k2, a Pose
head over three levels) for val and predict, whose JAX graphs trace in a
second. Every conv kernel is moved to zero mean over its fan-in: flax's
BatchNorm computes a training batch's variance in one pass, E[x^2] - E[x]^2,
which loses digits where a channel's mean dwarfs its spread (ROADMAP.md
§3.34); on zero-mean convs the two packages' train-mode forwards agree, as
their eval forwards do on any weights. A shapes-pose split of 4 + 4 images
at 96 px (at 64 px the batch statistics of the 2 x 2 maps at stride 32,
eight values per channel, spread JAX's rounding to 1e-4 of the loss).

- The f32 train step of yolo11n-pose (SGD; updates at ni = 0 and 1, the
  second on the updated weights) against JAX's PoseTrainer step at 96 px, B
  = 2: the loss items (box, pose, kobj, cls, dfl) within 1e-4 relative.
- Val on a copy of the val split labelled with the port's own boxes and
  keypoints at conf 0.5 (a random model matches no drawn figure; these give
  box and OKS matches to score), save_json=True: results_dict (box and pose
  P, R, mAP50, mAP50-95, fitness, and the COCO stats of the bbox and
  keypoints protocols) within 1e-4 of JAX's PoseValidator's on the same
  weights; the keypoint TP matrix equal; predictions.json and
  annotations.json row for row (the keypoints within 1e-3, JAX's rounding to
  3 decimals); a (17, 3) model on (5, 3) data raises JAX's ValueError.
- Predict on three arrays of odd sizes: per image the detections equal in
  count and class, boxes and keypoints within 1e-3 px; on JAX's detections,
  Results.plot with keypoints byte-equal to JAX's (labels off: the port's
  label font is its own, tests/test_torch_plot.py) and save_txt's lines
  equal; Results' tables JAX's.
- circle: byte-equal to cv2.circle(..., -1) (OpenCV 5.0.0) for radii 0-6 at
  centres inside, on and past the image's edges; the committed digests of
  its cases (tests/torch_data/pose/circle_digests.json, rewritten by
  `PYTHONPATH=. python tests/test_torch_pose_engine.py`) hold the card's
  drawing in tests/test_torch_gpu.py.
- The facade and the CLI: YOLO("yolo11n-pose.yaml") (17, 3) trained on
  the (5, 3) data (an epoch at 96 px) rebuilds its head, runs under
  runs/pose, writes JAX's results.csv columns, its checkpoint carries
  kpt_shape [5, 3] and reloads at (5, 3); the tiny checkpoint trained on
  (17, 3) data is rebuilt from its own model dict (JAX's trainer reads its
  path as a model YAML and fails, ROADMAP.md §3.33), and its last.ckpt is
  read by JAX (weights, EMA and optimizer state); `pose val` and `pose
  predict` go through cfg.entrypoint; AutoBatch probes a pose model's step;
  classify, a served pose model and a pose ensemble raise as tabled.
"""

import csv
import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.cfg import entrypoint
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint
from spectrogram_yolov11_torch.engine.predictor import PosePredictor
from spectrogram_yolov11_torch.engine.results import Results
from spectrogram_yolov11_torch.engine.trainer import PoseTrainer
from spectrogram_yolov11_torch.engine.validator import PoseValidator
from spectrogram_yolov11_torch.nn.autobackend import AutoBackend
from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load
from spectrogram_yolov11_torch.utils.autobatch import check_train_batch_size
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables
from spectrogram_yolov11_torch.utils.plotting import circle
from spectrogram_yolov11_tpu.engine import optim as jopt
from spectrogram_yolov11_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from spectrogram_yolov11_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from spectrogram_yolov11_tpu.engine.model import YOLO as JaxYOLO
from spectrogram_yolov11_tpu.engine.results import Results as JaxResults
from spectrogram_yolov11_tpu.engine.trainer import PoseTrainer as JaxPoseTrainer
from spectrogram_yolov11_tpu.engine.validator import PoseValidator as JaxPoseValidator
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from spectrogram_yolov11_tpu.ops.metrics import PoseMetrics as JaxPoseMetrics

IMGSZ, BATCH, KPT, NB = 96, 2, (5, 3), 50
STEPS = ((0, True), (1, True))
ITEMS_RTOL, VAL_TOL, PX_TOL = 1e-4, 1e-4, 1e-3
DIGESTS = Path(__file__).resolve().parent / "torch_data" / "pose" / "circle_digests.json"
NAMES = {0: "figure"}
TINY_POSE = {"nc": 1, "kpt_shape": list(KPT), "scales": {"t": [1.0, 1.0, 1024]}, "scale": "t",
             "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                          [-1, 1, "C3k2", [16, True]], [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]]],
             "head": [[[3, 4, 5], 1, "Pose", ["nc", "kpt_shape"]]]}
XLA_OPTIONS = {"xla_llvm_disable_expensive_passes": True}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _seeded(model_dict: dict, seed: int = 0) -> dict:
    """Seeded variables for the model of `model_dict`, in the layout the
    bridge gives the port's model (JAX's, tests/test_torch_pose.py): zero-mean
    conv kernels ~ U(+-1/sqrt(fan_in)) less their mean, BN scales and
    variances in [0.5, 1.5], biases and means ~ N(0, 0.1), the class
    branches' last biases 0."""
    shapes = state_dict_to_variables(build_model(dict(model_dict)).state_dict())
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, leaf in _leaves(shapes):
        name = "/".join(path)
        if path[0] == "batch_stats":
            a = rng.uniform(0.5, 1.5, leaf.shape) if path[-1] == "var" else rng.normal(0, 0.1, leaf.shape)
        elif path[-1] == "scale":
            a = rng.uniform(0.5, 1.5, leaf.shape)
        elif path[-1] == "bias":
            a = np.zeros(leaf.shape) if "/detect/cv3_" in name and name.endswith("_2/bias") else \
                rng.normal(0, 0.1, leaf.shape)
        else:
            a = rng.uniform(-1, 1, leaf.shape) / np.sqrt(max(int(np.prod(leaf.shape[:-1])), 1))
            a = a - a.mean((0, 1, 2), keepdims=True) if a.ndim == 4 else a
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(root, the data dict, the tiny model's checkpoint written by JAX's save_checkpoint)."""
    root = tmp_path_factory.mktemp("pose_engine")
    data = {"path": str(root / "data"), "train": "images/train", "val": "images/val", "synthetic": "shapes-pose",
            "n_train": 4, "n_val": 4, "gen_imgsz": IMGSZ, "seed": 0, "kpt_shape": list(KPT),
            "flip_idx": [1, 0, 3, 2, 4], "names": NAMES}
    check_det_dataset(data)
    ckpt = root / "tiny.ckpt"
    jax_save_checkpoint(ckpt, variables=_seeded(TINY_POSE), ema_variables=None, opt_state=None, epoch=-1,
                        best_fitness=0.0, updates=0, train_args={}, model_yaml=dict(TINY_POSE), names=NAMES, nc=1)
    return root, data, ckpt


# -- training ---------------------------------------------------------------------

def _batch():
    rng = np.random.default_rng(2)
    g = 5
    cls = np.zeros((BATCH, g), np.int32)
    xy, wh = rng.uniform(0.3, 0.7, (BATCH, g, 2)), rng.uniform(0.1, 0.4, (BATCH, g, 2))
    bboxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.arange(g)[None] < np.array([[4], [2]])
    bboxes[~mask] = 0
    kxy = xy[:, :, None] + rng.uniform(-0.5, 0.5, (BATCH, g, KPT[0], 2)) * wh[:, :, None]
    kpts = np.concatenate([kxy, rng.choice([0.0, 2.0], (BATCH, g, KPT[0], 1), p=[0.3, 0.7])], -1).astype(np.float32)
    kpts[~mask] = 0
    return {"img": rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8), "cls": cls, "bboxes": bboxes,
            "mask_gt": mask, "keypoints": kpts}


def _jax_items(data, model_dict, variables):
    """JAX's PoseTrainer step, compiled once, on the state its train() builds."""
    overrides = dict(data=data, imgsz=IMGSZ, batch=BATCH, amp=False, optimizer="SGD", workers=1,
                     project=str(data["path"]), exist_ok=True, plots=False)
    with pytest.MonkeyPatch.context() as mp:  # the JAX trainer's logging integrations touch no result
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        jt = JaxPoseTrainer(overrides=overrides, model=jax_build_model(dict(model_dict), verbose=False),
                            variables=variables)
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
    d = {k: v for k, v in yaml_model_load("yolo11n-pose.yaml").items() if k != "yaml_file"}
    d.update(kpt_shape=list(KPT), nc=1)
    variables = _seeded(d)
    ref = _jax_items(data, d, variables)
    t = PoseTrainer(build_model(dict(d), variables=variables),
                    dict(data=data, imgsz=IMGSZ, batch=BATCH, amp=False, optimizer="SGD", device="cpu"))
    t.setup_model()
    t.setup_optimizer(NB)
    assert t.rebuilt is None and t.loss_names == tuple(JaxPoseTrainer.loss_names.fget(None))
    for (ni, do_step), r in zip(STEPS, ref):
        got = t.train_step(_batch(), ni, do_step)[1].numpy()
        print(f"ni {ni}: items {got.tolist()} (JAX {r.tolist()})")
        assert got.shape == (5,) and (r > 0).all()
        np.testing.assert_allclose(got, r, rtol=ITEMS_RTOL, atol=0)


# -- val ----------------------------------------------------------------------------

def _self_labelled(data: dict, ckpt: Path, root: Path) -> dict:
    """A copy of the val split labelled with the port's detections at conf 0.5
    (at most 6 per image): each box and its keypoints, visibility 2 but for
    the second keypoint's 0."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    files = sorted(Path(data["path"], "images", "val").glob("*.jpg"))
    for f in files:
        (root / "images" / f.name).write_bytes(f.read_bytes())
    res = YOLO(ckpt, device="cpu").predict(str(root / "images"), imgsz=IMGSZ, conf=0.5, max_det=6, save=False)
    for f, r in zip(files, res):
        h, w = r.orig_shape
        rows = []
        for (cx, cy, bw, bh), c, kp in zip(r.boxes.xywhn, r.boxes.cls, r.keypoints.data):
            vals = [cx, cy, bw, bh] + [v for j, (x, y, _) in enumerate(kp) for v in (x / w, y / h, 2.0 * (j != 1))]
            rows.append(f"{int(c)} " + " ".join(f"{v:.6f}" for v in vals))
        (root / "labels" / f"{f.stem}.txt").write_text("\n".join(rows))
    return {"path": str(root), "train": "images", "val": "images", "names": NAMES, "kpt_shape": list(KPT)}


@pytest.fixture(scope="module")
def jax_yolo(setup):
    """JAX's facade on the tiny checkpoint, its logging integrations off (they touch no result; the
    TensorBoard one imports TensorFlow)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        return JaxYOLO(str(setup[2]))


@pytest.fixture(scope="module")
def vals(setup, jax_yolo):
    root, data, ckpt = setup
    split = _self_labelled(data, ckpt, root / "val_split")
    kw = dict(data=split, imgsz=IMGSZ, batch=BATCH, plots=False, save_json=True, workers=1)
    jy = jax_yolo
    jres = jy.val(**kw, project=str(root / "val_jax"))
    py = YOLO(ckpt, device="cpu")
    return py.val(**kw, project=str(root / "val_port")), py.validator, jres, jy.validator, root / "val_jax" / "val"


def test_val_box_and_pose_map_equal_jax(vals):
    got, pv, ref, jv, _ = vals
    assert isinstance(pv, PoseValidator) and isinstance(jv, JaxPoseValidator)
    assert list(got) == list(ref) and "metrics/mAP50-95(P)" in got and "metrics/coco_AP(P)" in got
    for k, v in ref.items():
        assert abs(got[k] - v) <= VAL_TOL, (k, got[k], v)
    tp_p = np.concatenate(pv.stats["tp_p"])
    np.testing.assert_array_equal(tp_p, np.concatenate(jv.stats["tp_p"]))
    print({k: round(v, 5) for k, v in got.items()})
    assert len(tp_p) > 20 and got["metrics/mAP50(P)"] > 0.5 and got["metrics/coco_AP50(P)"] > 0.5


def _close_rows(got: list, ref: list) -> None:
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k, v in r.items():
            if isinstance(v, (list, float)):
                np.testing.assert_allclose(g[k], v, atol=PX_TOL, rtol=0, err_msg=k)
            else:
                assert g[k] == v, k


def test_val_json_rows_equal_jax(vals):
    _, pv, _, _, jax_dir = vals
    for name in ("predictions.json", "annotations.json"):
        _close_rows(json.loads((pv.save_dir / name).read_text()), json.loads((jax_dir / name).read_text()))
    rows = json.loads((pv.save_dir / "annotations.json").read_text())
    assert {"keypoints", "num_keypoints", "area"} <= set(rows[0]) and len(rows[0]["keypoints"]) == 15


def test_a_kpt_shape_mismatch_raises_as_jax(setup):
    batch = {"ratio_pad": np.ones((1, 3), np.float32)}
    messages = []
    for update in (PoseValidator.update_stats, JaxPoseValidator.update_stats):
        me = SimpleNamespace(kpt_shape=(17, 3), data={"kpt_shape": [5, 3]})
        with pytest.raises(ValueError, match="kpt_shape") as e:
            update(me, (np.zeros((1, 300, 57), np.float32), np.zeros(1, int)), batch, 0)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


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
    assert isinstance(port.predictor, PosePredictor)
    return got, ref


def test_predict_keypoints_match_jax(predictions):
    got, ref = predictions
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert len(g) == len(r) > 0
        np.testing.assert_array_equal(g.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(g.boxes.xyxy, r.boxes.xyxy, atol=PX_TOL, rtol=0)
        assert g.keypoints.data.shape == r.keypoints.data.shape == (len(g), *KPT)
        np.testing.assert_allclose(g.keypoints.data, r.keypoints.data, atol=PX_TOL, rtol=0)
        np.testing.assert_allclose(g.keypoints.xyn, r.keypoints.xyn, atol=PX_TOL, rtol=0)
        np.testing.assert_array_equal(g.keypoints.conf.shape, r.keypoints.conf.shape)


def test_results_plot_txt_and_tables_equal_jax(predictions, tmp_path):
    _, ref = predictions
    for i, r in enumerate(ref):
        ours = Results(r.orig_img, r.path, r.names, boxes=r.boxes.data, keypoints=r.keypoints.data)
        for lw in (None, 1, 3):
            got, want = ours.plot(line_width=lw, show_labels=False), r.plot(line_width=lw, show_labels=False)
            assert got.dtype == want.dtype and np.array_equal(got, want), lw
        for conf in (False, True):
            ours.save_txt(tmp_path / f"p{i}{conf}.txt", save_conf=conf)
            r.save_txt(tmp_path / f"j{i}{conf}.txt", save_conf=conf)
            assert (tmp_path / f"p{i}{conf}.txt").read_text() == (tmp_path / f"j{i}{conf}.txt").read_text()
        assert ours.to_json() == r.to_json()
        sub, jsub = ours[1:3], r[1:3]
        assert np.array_equal(sub.keypoints.data, jsub.keypoints.data) and len(sub) == 2
    two = np.asarray(ref[0].keypoints.data)[..., :2]  # nd = 2: every point drawn
    sel, jsel = Results(ref[0].orig_img, "x", NAMES), JaxResults(ref[0].orig_img, "x", NAMES)
    for r in (sel, jsel):
        r.update(boxes=ref[0].boxes.data, keypoints=two)
    assert np.array_equal(sel.plot(show_labels=False), jsel.plot(show_labels=False))
    assert sel.keypoints.conf is None


# -- circle against cv2 and its digests ---------------------------------------------

def circle_cases() -> list:
    """{name, seed, size, center, radius, color} of every drawn case: radii 0-6
    at centres inside, on and past the edges of a 32 px canvas."""
    out = []
    for r in range(7):
        for j, c in enumerate(((16, 12), (0, 0), (31, 5), (-2, 10), (33, 33), (10, -4), (3, 29), (-7, -7))):
            out.append({"name": f"circle_r{r}_{j}", "seed": 100 * r + j, "size": 32, "center": list(c), "radius": r,
                        "color": [0, 255, 0] if j % 2 else [0, 0, 255]})
    return out


def _circles(cases: list, port: bool) -> dict:
    import cv2

    out = {}
    for c in cases:
        img = np.random.default_rng(c["seed"]).integers(0, 256, (c["size"], c["size"], 3), dtype=np.uint8)
        center, color = tuple(c["center"]), tuple(c["color"])
        out[c["name"]] = circle(img, center, c["radius"], color) if port else \
            cv2.circle(img, center, c["radius"], color, -1)
    return out


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_circle_equals_cv2_and_its_digests():
    blob = json.loads(DIGESTS.read_text())
    assert blob["cases"] == circle_cases()
    ours, theirs = _circles(blob["cases"], True), _circles(blob["cases"], False)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), k
    assert {k: _sha(v) for k, v in ours.items()} == blob["sha256"]


def make_fixtures() -> None:
    """Rewrite tests/torch_data/pose/circle_digests.json: the cases and the
    SHA-256 of cv2's circle for each."""
    import cv2

    DIGESTS.parent.mkdir(parents=True, exist_ok=True)
    made = (f"PYTHONPATH=. python tests/test_torch_pose_engine.py (make_fixtures): the SHA-256 of cv2 {cv2.__version__}"
            "'s cv2.circle(img, center, radius, color, -1) for each case (img: default_rng(seed).integers(0, 256, "
            "(size, size, 3), uint8))")
    cases = circle_cases()
    DIGESTS.write_text(json.dumps({"made": made, "cases": cases,
                                   "sha256": {k: _sha(v) for k, v in _circles(cases, False).items()}}, indent=1) + "\n")


# -- the facade, the CLI and the refusals -----------------------------------------------

def _write_yaml(data: dict) -> Path:
    y = Path(data["path"]) / "d.yaml"
    y.write_text(f"path: {data['path']}\ntrain: images/train\nval: images/val\nkpt_shape: [5, 3]\n"
                 "flip_idx: [1, 0, 3, 2, 4]\nnames:\n  0: figure\n")
    return y


def test_facade_and_cli_run_the_pose_task(setup, tmp_path):
    root, data, ckpt = setup
    m = YOLO("yolo11n-pose.yaml", device="cpu")
    assert m.task == "pose" and m.overrides["task"] == "pose" and m.model.kpt_shape == (17, 3)
    res = m.train(data=data, epochs=1, batch=BATCH, imgsz=IMGSZ, plots=False, project=str(tmp_path / "runs"),
                  name="pose", workers=1, amp=False)
    assert m.trainer.rebuilt == {"kpt_shape": ((17, 3), KPT)} and m.model.kpt_shape == KPT
    assert list(res) == [*JaxPoseMetrics().keys, "fitness"]
    with open(tmp_path / "runs" / "pose" / "results.csv") as f:
        assert next(csv.reader(f)) == ["epoch", *(f"train/{n}" for n in JaxPoseTrainer.loss_names.fget(None)),
                                       *JaxPoseMetrics().keys, "fitness"]
    best = tmp_path / "runs" / "pose" / "weights" / "best.ckpt"
    assert load_checkpoint(best)[1]["model_yaml"]["kpt_shape"] == list(KPT)
    back = YOLO(best, device="cpu")
    assert back.task == "pose" and back.model.kpt_shape == KPT and back.model.model[-1].cv4[0][2].out_channels == 15
    y = _write_yaml(data)
    out = entrypoint(f"yolo pose val model={ckpt} data={y} imgsz={IMGSZ} batch=2 device=cpu plots=False "
                     f"project={tmp_path / 'cli'}")
    assert list(out) == list(res)
    pred = entrypoint(f"yolo pose predict model={ckpt} source={data['path']}/images/val imgsz={IMGSZ} device=cpu "
                      f"save=False conf=0.3")
    assert len(pred) == 4 and all(r.keypoints is not None for r in pred)
    # a checkpoint whose kpt_shape is not the data's: rebuilt from its own model dict (ROADMAP.md §3.33), where
    # JAX's trainer reads args.model, the checkpoint's path, as a model YAML and fails
    d17 = dict(data, path=str(tmp_path / "d17"), kpt_shape=[17, 3], n_train=2, n_val=2, flip_idx=None)
    check_det_dataset(d17)
    t17 = YOLO(ckpt, device="cpu")
    t17.train(data=d17, epochs=1, batch=BATCH, imgsz=IMGSZ, plots=False, project=str(tmp_path / "runs"), name="p17",
              workers=1, amp=False)
    assert t17.trainer.rebuilt == {"kpt_shape": (KPT, (17, 3))} and t17.model.kpt_shape == (17, 3)
    assert t17.model.yaml["backbone"] == TINY_POSE["backbone"]
    with pytest.raises(AssertionError, match="not a YAML file"):
        jax_yaml_model_load(str(ckpt))
    # the port's pose checkpoint read by JAX: its (17, 3) model built from the model dict takes the weights and the
    # EMA (a mismatched leaf fails flax's apply), and JAX's resume takes the optimizer state
    tree, meta = jax_load_checkpoint(tmp_path / "runs" / "p17" / "weights" / "last.ckpt")
    jm = jax_build_model(meta["model_yaml"], nc=meta["nc"], verbose=False)
    assert tuple(jm.kpt_shape) == (17, 3)
    for v in (tree["variables"], tree["ema"]):
        out = jax.eval_shape(lambda w: jm.apply(w, jnp.zeros((1, IMGSZ, IMGSZ, 3))), v)
        assert out[1].shape == (1, 189, 51)
    spec = jopt.make_flat_spec(tree["variables"]["params"], jopt.param_groups(tree["variables"]["params"]))
    assert jopt.flat_opt_state(jopt.OptState(**tree["opt_state"]), spec).mu.shape == (spec.n,)
    probes = {}
    assert check_train_batch_size(YOLO(ckpt, device="cpu").model, imgsz=32, nc=1, probes=probes) >= 16 and probes[16]
    # the classify task builds since its slice (tests/test_torch_classify*.py); the AutoBackend of a pose
    # checkpoint runs the pose serving graph and carries its kpt_shape (tests/test_torch_serve_tasks.py)
    assert YOLO("yolo11n-cls.yaml").task == "classify"
    backend = AutoBackend(str(ckpt), device="cpu")
    out = backend.forward(np.zeros((1, IMGSZ, IMGSZ, 3), np.uint8))
    assert backend.task == "pose" and backend.kpt_shape == KPT and out.shape == (1, 189, 4 + backend.nc + 15)
    with pytest.raises(AssertionError, match="detect task"):
        YOLO([str(ckpt), str(ckpt)])


if __name__ == "__main__":
    make_fixtures()
    print(f"wrote {DIGESTS}")
