"""The port's classify trainer, validator, predictor, results and facade against the JAX package's, on the CPU.

A tiny folder-per-class set (3 classes, 4 train and 2 val images each, JAX's
bytes: data/synth.py:gen_cls_shapes) and yolo11n-cls at nc 3 on seeded
weights carried across both ways.

- The trainer: JAX's ClassificationTrainer and the port's on the same
  weights, 2 epochs at 64 px, batch 4 (3 steps each; AdamW by the 'auto'
  rule, in warmup): each epoch's mean loss within 1e-5 relative, each
  epoch's EMA validation (top-1, top-5) equal, and the final EMA weights
  and BN statistics within 1e-4 of each leaf's max |value|.
- The validator: top-1 and top-5 equal to JAX's ClassificationValidator on
  the same weights, at 48 px with a padded tail (batch 4 over 6 images).
- The predictor: probs within 1e-5 of JAX's ClassificationPredictor and the
  top-5 equal, on images of several sizes, one per call (JAX's) and batched;
  Results' probs rows (verbose, summary, save_txt, plot) equal to JAX's.
- The facade and the command line: YOLO("yolo11n-cls.yaml") keeps the
  YAML's nc (1000) through train, as JAX's facade; save -> YOLO(path)
  predicts the same probs; `classify train|val|predict` run in process.
"""

import shutil

import jax
import numpy as np
import pytest
import torch
from test_torch_classify import jax_cls
from test_torch_pose import _close, _leaves, _seeded
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_tpu.engine.classify as jax_classify_module
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.cfg import entrypoint
from spectrogram_yolov11_torch.data.imageio import imread
from spectrogram_yolov11_torch.data.synth import gen_cls_shapes
from spectrogram_yolov11_torch.engine.classify import ClassificationTrainer
from spectrogram_yolov11_torch.engine.predictor import ClassificationPredictor
from spectrogram_yolov11_torch.engine.results import Results
from spectrogram_yolov11_torch.engine.validator import ClassificationValidator
from spectrogram_yolov11_torch.nn.tasks import build_model
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables
from spectrogram_yolov11_tpu.engine.classify import ClassificationTrainer as JaxClassificationTrainer
from spectrogram_yolov11_tpu.engine.predictor import ClassificationPredictor as JaxClassificationPredictor
from spectrogram_yolov11_tpu.engine.results import Results as JaxResults
from spectrogram_yolov11_tpu.engine.validator import ClassificationValidator as JaxClassificationValidator

IMGSZ, BATCH, EPOCHS = 64, 4, 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(dataset root, model dict, JAX model, seeded variables)."""
    root = tmp_path_factory.mktemp("cls_data")
    gen_cls_shapes(root, "train", 4, 56)
    gen_cls_shapes(root, "val", 2, 72, seed=10_000)
    d, jm, shapes = jax_cls("yolo11n-cls.yaml", 3)
    return root, d, jm, _seeded(shapes, 4)


@pytest.fixture(scope="module")
def trained(setup):
    """JAX's and the port's trainers after EPOCHS epochs, with JAX's logged epoch losses."""
    root, d, jm, variables = setup
    overrides = dict(data=str(root), imgsz=IMGSZ, batch=BATCH, epochs=EPOCHS, workers=1, seed=0)
    logged = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_classify_module.LOGGER, "info", lambda msg, *a, **k: logged.append(str(msg)))
        jt = JaxClassificationTrainer(overrides=overrides, model=jm, variables=variables)
        jax_val = []
        real_call = JaxClassificationValidator.__call__
        mp.setattr(JaxClassificationValidator, "__call__", lambda self, *a, **k: jax_val.append(real_call(self, *a, **k))
                   or jax_val[-1])
        jt.train()
    jax_losses = [float(m.split("loss ")[1]) for m in logged if m.startswith("epoch ")]
    pt = ClassificationTrainer(build_model(dict(d), variables=variables), {**overrides, "device": "cpu"})
    port_val = []
    real_port = ClassificationValidator.__call__
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ClassificationValidator, "__call__", lambda self, *a, **k: port_val.append(real_port(self, *a, **k))
                   or port_val[-1])
        res = pt.train()
    return jt, jax_losses, jax_val, pt, res, port_val


def test_train_epochs_match_jax(trained):
    jt, jax_losses, jax_val, pt, res, port_val = trained
    assert pt.imgsz == jt.imgsz == IMGSZ and pt.batch_size == jt.batch_size == BATCH
    assert len(jax_losses) == EPOCHS == len(pt.epoch_log)
    for got, ref in zip((e["loss"] for e in pt.epoch_log), jax_losses):
        # JAX logs the mean to 4 decimals: held to its printed value, and the port's to 1e-5 of it beyond that
        assert abs(got - ref) <= 5e-5 + 1e-5 * abs(ref), (got, ref)
    assert port_val == jax_val and res == jax_val[-1] and list(res) == ["metrics/accuracy_top1",
                                                                        "metrics/accuracy_top5", "fitness"]
    assert pt.opt.kind == "adamw" and pt.state["opt"]["step"] == EPOCHS * 3 and pt.state["ema_updates"] == 6


def test_train_ema_weights_match_jax(trained):
    jt, _, _, pt, _, _ = trained
    got = dict(_leaves(state_dict_to_variables(pt.model.state_dict())))
    ref = dict(_leaves(jax.tree_util.tree_map(np.asarray, jt.variables)))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        _close(got[k], v, k, 1e-4)
    assert not pt.model.training and pt.model.nc == 3


def test_validator_top1_top5_equal_jax(setup):
    root, d, jm, variables = setup
    for s, batch in ((48, 4), (64, 16)):
        ref = JaxClassificationValidator(jm, variables, overrides={"imgsz": s, "batch": batch})(data=str(root))
        v = ClassificationValidator(build_model(dict(d), variables=variables),
                                    overrides={"imgsz": s, "batch": batch, "device": "cpu"})
        assert v(data=str(root)) == ref
        assert v.metrics.top1 == ref["metrics/accuracy_top1"] and v.metrics.speed["inference"] > 0
    assert 0 < ref["metrics/accuracy_top5"] <= 1.0


@pytest.fixture(scope="module")
def predictions(setup):
    """JAX's results and the port's (one image per call, and batched) on images of three sizes."""
    root, d, jm, variables = setup
    files = sorted(str(p) for p in (root / "val").rglob("*.jpg"))[:3]
    imgs = [imread(f) for f in files] + [np.random.default_rng(5).integers(0, 255, (50, 90, 3), np.uint8)]
    ref = JaxClassificationPredictor(jm, variables, overrides={"imgsz": 48})(imgs)
    model = build_model(dict(d), variables=variables)
    got = ClassificationPredictor(model, overrides={"imgsz": 48, "device": "cpu"}, names=jm.names)(imgs)
    batched = ClassificationPredictor(model, overrides={"imgsz": 48, "device": "cpu"}, names=jm.names)(
        imgs, batch_size=3)
    return ref, got, batched


def test_predict_probs_match_jax(predictions):
    ref, got, batched = predictions
    assert len(got) == len(ref) == len(batched) == 4
    for g, b, r in zip(got, batched, ref):
        assert g.probs.data.shape == (3,) and g.probs.data.dtype == np.float32 and g.boxes is None
        _close(g.probs.data, r.probs.data, "probs", 1e-5)
        _close(b.probs.data, r.probs.data, "probs batched", 1e-5)
        assert g.probs.top5 == r.probs.top5 == b.probs.top5 and g.probs.top1 == r.probs.top1
        assert abs(g.probs.top1conf - r.probs.top1conf) <= 1e-5 and g.orig_shape == r.orig_shape


def test_results_probs_rows_equal_jax(tmp_path):
    img = np.random.default_rng(6).integers(0, 255, (20, 30, 3), np.uint8)
    probs = np.array([0.1, 0.55, 0.05, 0.2, 0.06, 0.04], np.float32)
    names = {i: f"c{i}" for i in range(6)}
    got, ref = Results(img, "a.jpg", names, probs=probs), JaxResults(img, "a.jpg", names, probs=probs)
    assert got.verbose() == ref.verbose() and got.summary() == ref.summary() and got.to_json() == ref.to_json()
    assert got.probs.top5 == ref.probs.top5 and np.array_equal(got.probs.top5conf, ref.probs.top5conf)
    assert len(got) == len(ref) == 0 and np.array_equal(got[0].probs.data, ref[0].probs.data)
    got.save_txt(tmp_path / "p.txt")
    ref.save_txt(tmp_path / "j.txt")
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text() == "0.55 c1\n"
    assert np.array_equal(got.plot(), ref.plot()) and np.array_equal(got.plot(), img)  # JAX draws no probs text
    new = got.new()
    new.update(probs=probs[::-1].copy())
    assert new.probs.top1 == 4 and got.to_df().to_dict() == ref.to_df().to_dict()


def test_facade_and_cli_run_the_classify_task(setup, tmp_path):
    root, *_ = setup
    data = tmp_path / "data"
    shutil.copytree(root, data)
    m = YOLO("yolo11n-cls.yaml", device="cpu")
    assert m.task == "classify" and m.overrides["task"] == "classify" and m.model.nc == 1000
    res = m.train(data=str(data), epochs=1, imgsz=32, batch=BATCH, workers=1)
    # JAX's facade hands the trainer its model: the YAML's nc stays, the data's names do not replace its own
    assert m.model.nc == 1000 and m.trainer.imgsz == 32 and list(res) == list(m.trainer.metrics)
    assert m.val(data=str(data), imgsz=32, batch=4) == res
    ckpt = tmp_path / "cls.ckpt"
    m.save(ckpt)
    back = YOLO(ckpt, device="cpu")
    assert back.task == "classify" and back.model.nc == 1000
    src = str(data / "val" / "circle")
    for a, b in zip(m.predict(src, imgsz=32), back.predict(src, imgsz=32)):
        np.testing.assert_array_equal(a.probs.data, b.probs.data)
    half = m.predict(src, imgsz=32, half=True)
    assert len(half) == 2 and half[0].probs.data.dtype == np.float32 and m.model.dtype == torch.float32
    assert abs(float(half[0].probs.data.sum()) - 1) < 2e-2
    out = entrypoint(f"yolo classify val model={ckpt} data={data} imgsz=32 batch=4 device=cpu")
    assert out == res
    pred = entrypoint(f"yolo classify predict model={ckpt} source={src} imgsz=32 device=cpu")
    assert len(pred) == 2 and all(r.probs is not None and r.boxes is None for r in pred)
    tiny = tmp_path / "tiny"
    shutil.copytree(root, tiny)
    out = entrypoint(f"yolo classify train model=yolo11n-cls.yaml data={tiny} epochs=1 imgsz=32 batch=4 "
                     f"device=cpu workers=1")
    assert list(out) == ["metrics/accuracy_top1", "metrics/accuracy_top5", "fitness"]
