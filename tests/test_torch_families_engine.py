"""yolov8n and yolov10n through the port's trainer, validator, predictor and server against the JAX package's, on the CPU.

Both models from their YAMLs at scale n with nc = 2, the port's init(seed)
with seeded BN statistics and the class biases at 0 (scores near 0.5, so
val and predict keep detections), carried into JAX by the reverse bridge;
64 px, B = 2.

- The first training step (f32, SGD, an accumulation step at ni = 3) of the
  port's DetectionTrainer against JAX's loss and its gradient (jitted) on
  the graph in training mode: the loss items within 1e-4 relative
  (yolov10n: JAX's e2e_detection_loss, the one2many terms at TAL topk 10
  plus the one2one terms at topk 1; yolov8n: detection_loss), and the
  gradient of one one2one and one one2many weight (the class branches' last
  convs of level 0) within 1e-4 of the leaf's largest.
- Val on a 4-image synthetic split labelled with the port's own detections
  (a random model matches nothing drawn), at max_det 10: results_dict within
  1e-6 of JAX's DetectionValidator's (yolov10n on JAX's NMS-free branch, n
  the rows above conf; yolov8n on NMS with the keep kernel's plain
  version). At the default max_det the NMS-free rows are all 84 anchors'
  best pairs at 64 px, whose confidences (scores near 0.5) lie closer than
  the two sides' f32 rounding, so AP's sort by confidence could order two
  of them differently.
- Predict on three arrays of odd sizes: per image, the detections equal in
  count and class, boxes within 1e-3 px; yolov10n with `classes` too (JAX's
  stable kept-rows-first order).
- A served yolov10n (the port's server on the CPU): its outputs are the
  NMS-free rows and n_valid of the local serving graph, and YOLO(url).predict
  gives what JAX's YOLO(url).predict gives through the same server: both
  clients read the rows as decoded predictions and run NMS on them
  (ROADMAP.md §3.49).
- The facade: YOLO("yolov10n.yaml").train one CPU epoch on the split (amp,
  the nc 80 -> 2 rebuild), then val and predict of its best.ckpt (the 84
  NMS-free rows of a 64 px frame at conf 0).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fork_models import scaled_bn
from test_torch_train_step import _flax, _leaves, one_torch_thread  # noqa: F401 (autouse)

import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.engine.checkpoint import save_checkpoint
from spectrogram_yolov11_torch.engine.exporter import build_inference_fn
from spectrogram_yolov11_torch.engine.predictor import BasePredictor
from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer
from spectrogram_yolov11_torch.engine.validator import DetectionValidator
from spectrogram_yolov11_torch.nn.modules.head import Detect
from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load
from spectrogram_yolov11_torch.serve import InferenceServer, RemoteModel
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables
from spectrogram_yolov11_tpu.engine.model import YOLO as JaxYOLO
from spectrogram_yolov11_tpu.engine.predictor import BasePredictor as JaxPredictor
from spectrogram_yolov11_tpu.engine.validator import DetectionValidator as JaxDetectionValidator
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from spectrogram_yolov11_tpu.ops.losses import detection_loss as jax_detection_loss
from spectrogram_yolov11_tpu.ops.losses import e2e_detection_loss as jax_e2e_detection_loss

NAMES = ("yolov8n.yaml", "yolov10n.yaml")
NB, IMGSZ, BATCH = 50, 64, 2
ITEMS_RTOL, GRAD_RTOL, VAL_TOL, BOX_TOL = 1e-4, 1e-4, 1e-6, 1e-3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth64")
    d = {"path": str(root), "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
         "n_train": 4, "n_val": 4, "gen_imgsz": IMGSZ, "seed": 0, "names": {0: "LTE", 1: "RF"}}
    check_det_dataset(d)
    return d


@pytest.fixture(scope="module")
def models():
    """{name: (model dict, the port's model, its variables, JAX's model)}, nc = 2."""
    out = {}
    for name in NAMES:
        d = yaml_model_load(name)
        d["nc"] = 2
        tm = build_model(d).init(len(name))
        scaled_bn(tm, len(name))
        with torch.no_grad():
            for m in tm.modules():
                if isinstance(m, Detect):
                    for branch in [m.cv3] + ([m.one2one_cv3] if m.end2end else []):
                        for seq in branch:
                            seq[-1].bias.zero_()
        tm.names = {0: "LTE", 1: "RF"}
        v = state_dict_to_variables(tm.state_dict())
        jd = jax_yaml_model_load(name)
        jd["nc"] = 2
        jm = jax_build_model(jd, verbose=False)
        jm.names = dict(tm.names)
        out[name] = (d, tm, v, jm)
    return out


def _batch(seed=2, g=5):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 2, (BATCH, g)).astype(np.int32)
    xy, wh = rng.uniform(0.3, 0.7, (BATCH, g, 2)), rng.uniform(0.1, 0.4, (BATCH, g, 2))
    bboxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.arange(g)[None] < np.array([[4], [2]])
    bboxes[~mask], cls[~mask] = 0, 0
    return {"img": rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8), "cls": cls, "bboxes": bboxes,
            "mask_gt": mask}


@pytest.mark.parametrize("name", NAMES)
def test_first_train_step_equals_jax(name, models, data):
    """The port's DetectionTrainer.train_step (f32, an accumulation step) against
    JAX's loss on the graph in training mode and its gradient (jitted): JAX's
    e2e_detection_loss for the dict of v10's head, detection_loss for v8's, as
    JAX's trainer picks them (engine/trainer.py:260-263)."""
    d, _, v, jm = models[name]
    batch = _batch()
    strides = tuple(float(s) for s in jm.stride)

    def loss_fn(params, img):
        out, _ = jm.graph.apply({"params": params, "batch_stats": v["batch_stats"]}, img, train=True,
                                mutable=["batch_stats"])
        loss = jax_e2e_detection_loss if isinstance(out, dict) else jax_detection_loss
        return loss(out, jnp.asarray(batch["cls"]), jnp.asarray(batch["bboxes"]), jnp.asarray(batch["mask_gt"]), nc=2,
                    imgsz=IMGSZ, strides=strides)

    img = jnp.asarray(batch["img"], jnp.float32) / 255.0
    (_, ref_items), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"], img)
    ref_grads = dict(_leaves(ref_grads))

    port = DetectionTrainer(build_model(d, variables=v), dict(data=data, imgsz=IMGSZ, batch=BATCH, amp=False,
                                                              optimizer="SGD", workers=1, device="cpu"))
    port.setup_model()
    port.setup_optimizer(NB)
    _, items = port.train_step(batch, 3, False)
    grads = _flax(port.param_names, port.state["grad_buf"])
    print(f"{name}: items {items.tolist()} (JAX {np.asarray(ref_items).tolist()})")
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=ITEMS_RTOL, atol=0)
    head = f"model_{len(d['backbone']) + len(d['head']) - 1}"
    leaves = [f"{head}/cv3_0_2/kernel"] + ([f"{head}/one2one_cv3_0_2/kernel"] if "10" in name else [])
    for leaf in leaves:
        g, r = grads[leaf], ref_grads[leaf]
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(g, r, atol=GRAD_RTOL * np.abs(r).max(), rtol=0, err_msg=leaf)
    assert grads.keys() == ref_grads.keys()


def _self_labelled(data: dict, tm, root: Path) -> dict:
    """A copy of the val split labelled with the port's detections at conf 0.5 (at most 6 per image)."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    pred = BasePredictor(tm, overrides=dict(imgsz=IMGSZ, conf=0.5, max_det=6, save=False, device="cpu"),
                         names=tm.names)
    for f in sorted(Path(data["path"], "images", "val").glob("*.png")):
        (root / "images" / f.name).write_bytes(f.read_bytes())
        (r,) = pred(str(f))
        h, w = r.orig_shape
        rows = [f"{int(c)} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} {(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}"
                for (x1, y1, x2, y2), c in zip(r.boxes.xyxy, r.boxes.cls)]
        (root / "labels" / f"{f.stem}.txt").write_text("\n".join(rows))
    return {"path": str(root), "train": "images", "val": "images", "names": data["names"]}


@pytest.mark.parametrize("name", NAMES)
def test_val_equals_jax(name, models, data, tmp_path):
    _, tm, v, jm = models[name]
    split = _self_labelled(data, tm, tmp_path / "split")
    kw = dict(data=split, imgsz=IMGSZ, batch=BATCH, plots=False, workers=1, max_det=10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        ref = JaxDetectionValidator(jm, v, overrides=dict(kw, project=str(tmp_path / "jax")))(split)
    got = DetectionValidator(tm, overrides=dict(kw, project=str(tmp_path / "port"), device="cpu"))(split)
    print(name, {k: round(x, 6) for k, x in got.items()})
    assert list(got) == list(ref) and got["metrics/mAP50(B)"] > 0.3
    for k, x in ref.items():
        assert abs(got[k] - x) <= VAL_TOL, (k, got[k], x)


def _arrays():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((50, 70), (64, 40), (90, 120))]


@pytest.mark.parametrize("name, classes", [("yolov8n.yaml", None), ("yolov10n.yaml", None),
                                           ("yolov10n.yaml", [1])])
def test_predict_equals_jax(name, classes, models):
    _, tm, v, jm = models[name]
    kw = dict(imgsz=IMGSZ, conf=0.3, save=False, classes=classes)
    ref = JaxPredictor(jm, v, overrides=kw)(_arrays())
    got = BasePredictor(tm, overrides=dict(kw, device="cpu"), names=tm.names)(_arrays(), batch_size=2)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert len(g) == len(r) > 0
        np.testing.assert_array_equal(g.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(g.boxes.conf, r.boxes.conf, atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.boxes.xyxy, r.boxes.xyxy, atol=BOX_TOL, rtol=0)
        if classes:
            assert set(np.asarray(g.boxes.cls).tolist()) == {1.0}


def test_served_v10_as_jax_client_reads_it(models, tmp_path):
    d, tm, v, _ = models["yolov10n.yaml"]
    ckpt = tmp_path / "v10.ckpt"
    save_checkpoint(ckpt, variables=v, ema_variables=None, opt_state=None, epoch=-1, best_fitness=0.0, updates=0,
                    model_yaml=d, names=tm.names, nc=tm.nc)
    frames = np.random.default_rng(1).integers(0, 255, (2, IMGSZ, IMGSZ, 3), np.uint8)
    srv = InferenceServer({"v10": str(ckpt)}, port=0, device="cpu").start()
    try:
        url = f"http://127.0.0.1:{srv.port}/v10"
        det, nv = RemoteModel(url)(frames)
        ref_det, ref_nv = build_inference_fn(tm.eval())(torch.from_numpy(frames))
        np.testing.assert_allclose(det, ref_det.numpy(), atol=1e-4, rtol=0)
        assert np.array_equal(nv, ref_nv.numpy()) and det.shape == (2, 84, 6)
        kw = dict(imgsz=IMGSZ, conf=0.25, save=False)
        arrays = _arrays()
        got = YOLO(url).predict(arrays, device="cpu", **kw)
        with pytest.MonkeyPatch.context() as mp:  # the JAX facade's logging integrations import TensorFlow
            mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
            ref = JaxYOLO(url).predict(arrays, **kw)
        assert len(got) == len(ref) == 3 and sum(len(g) for g in got) > 0
        for g, r in zip(got, ref):
            assert len(g) == len(r)
            np.testing.assert_array_equal(g.boxes.cls, r.boxes.cls)
            np.testing.assert_allclose(g.boxes.xyxy, r.boxes.xyxy, atol=BOX_TOL, rtol=0)
    finally:
        srv.shutdown()


def test_facade_trains_vals_and_predicts_v10(data, tmp_path):
    model = YOLO("yolov10n.yaml")
    assert model.model.end2end
    model.train(data=data, epochs=1, imgsz=IMGSZ, batch=BATCH, device="cpu", workers=1, plots=False,
                project=str(tmp_path), name="v10", val=True)
    trainer = model.trainer
    assert trainer.rebuilt["nc"] == (80, 2)
    best = Path(trainer.save_dir) / "weights" / "best.ckpt"
    trained = YOLO(str(best))
    assert trained.model.end2end
    res = trained.val(data=data, imgsz=IMGSZ, batch=BATCH, device="cpu", plots=False)
    assert 0.0 <= res["metrics/mAP50-95(B)"] <= 1.0
    (r,) = trained.predict(_arrays()[:1], imgsz=IMGSZ, device="cpu", save=False, conf=0.0)
    assert len(r) == 84 and r.boxes.xyxy.shape == (84, 4)
