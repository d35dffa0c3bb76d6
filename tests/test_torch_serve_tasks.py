"""Serving every task on the port (engine/exporter.py, nn/autobackend.py, serve.py) against the JAX package's, on the CPU.

Tiny segment, pose (kpt_shape (5, 3)), OBB and classify models (16 wide,
three levels; JAX's layouts) on seeded weights carried across, at 64 px.

- build_inference_fn of each task at nms=False and nms=True against JAX's
  (engine/exporter.py:51): every output within 1e-4 of its max |value|
  (n_valid equal), in JAX's layouts (segment: prototypes NHWC).
- One CPU server on port 0 holds the four checkpoints (the port's
  YOLO.save): the metadata carries each task and the pose model's
  kpt_shape, as JAX's server's; a segment model's two outputs go through
  the dynamic batcher. YOLO(url).predict of each task against local predict
  (YOLO(ckpt)) on the same frames: the rows within 1e-4, segment masks
  equal but for pixels at the 0.5 threshold (at most 0.1 % of them),
  keypoints and rotated boxes within 1e-3 px, probs within 1e-5 and top-5
  equal.
- YOLO(url).val of the served segment, pose and OBB models equals JAX's
  YOLO(url).val through the same server (its BackendValidator scores every
  column past the boxes as a class, ROADMAP.md §3.45), key for key within
  1e-6; of the classifier, JAX's raises and so does the port's (ValueError).
"""

import copy
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pose_engine import TINY_POSE, _seeded
from test_torch_segment_engine import TINY_SEG
from test_torch_obb_engine import TINY_OBB
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.engine.checkpoint import save_checkpoint
from spectrogram_yolov11_torch.engine.exporter import build_inference_fn
from spectrogram_yolov11_torch.nn.tasks import build_model
from spectrogram_yolov11_torch.serve import InferenceServer
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables
from spectrogram_yolov11_tpu.engine.exporter import build_inference_fn as jax_build_inference_fn
from spectrogram_yolov11_tpu.engine.model import YOLO as JaxYOLO
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model

S = 64
TINY_CLS = {"nc": 3, "scales": {"t": [1.0, 1.0, 1024]}, "scale": "t",
            "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "C3k2", [16, True]]],
            "head": [[-1, 1, "Classify", ["nc"]]]}
TASKS = {"segment": TINY_SEG, "pose": TINY_POSE, "obb": TINY_OBB, "classify": TINY_CLS}


def _close(got, ref, what: str, rel: float = 1e-4) -> None:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= rel * max(np.abs(ref).max(), 1e-30), (what, err)


@pytest.fixture(scope="module")
def models():
    """{task: (model dict, JAX model, seeded variables, the port's model carried from them)}."""
    out = {}
    for task, d in TASKS.items():
        v = _seeded(d, seed=len(task))
        out[task] = (d, jax_build_model(copy.deepcopy(d), verbose=False), v, build_model(copy.deepcopy(d), variables=v))
    return out


def _frames(n: int = 2, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (n, S, S, 3), np.uint8)


@pytest.mark.parametrize("nms", [False, True], ids=["raw", "nms"])
@pytest.mark.parametrize("task", list(TASKS))
def test_inference_fn_matches_jax(models, task, nms):
    d, jm, v, tm = models[task]
    x = _frames()
    ref = jax.jit(jax_build_inference_fn(jm, nms=nms))(v, jnp.asarray(x))
    got = build_inference_fn(tm.eval(), nms=nms)(torch.from_numpy(x))
    ref, got = (r if isinstance(r, tuple) else (r,) for r in (ref, got))
    assert len(got) == len(ref) == {"classify": 1, "segment": 3 if nms else 2}.get(task, 2 if nms else 1)
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.numpy(), np.asarray(r)
        if r.dtype == np.int32:  # n_valid
            assert np.array_equal(g, r) and r.min() > 0, (task, g, r)
        else:
            assert g.dtype == np.float32, (task, i, g.dtype)
            _close(g, r, f"{task} output {i}")


@pytest.fixture(scope="module")
def served(models, tmp_path_factory):
    """(the server holding the four tasks' checkpoints, {task: checkpoint})."""
    root = tmp_path_factory.mktemp("served")
    ckpts = {}
    for task, (d, _, _, tm) in models.items():  # as YOLO.save writes them
        ckpts[task] = str(root / f"{task}.ckpt")
        save_checkpoint(root / f"{task}.ckpt", variables=state_dict_to_variables(tm.state_dict()), ema_variables=None,
                        opt_state=None, epoch=-1, best_fitness=0.0, updates=0, model_yaml=d, names=tm.names, nc=tm.nc)
    srv = InferenceServer(ckpts, port=0, device="cpu").start()
    yield srv, ckpts
    srv.shutdown()


def _url(srv, task: str) -> str:
    return f"http://127.0.0.1:{srv.port}/{task}"


def test_metadata_carries_task_and_kpt_shape(served):
    srv, _ = served
    for task in TASKS:
        with urllib.request.urlopen(_url(srv, task).replace(f"/{task}", f"/v2/models/{task}"), timeout=60) as r:
            doc = json.loads(r.read())
        meta = json.loads(doc["parameters"]["metadata"])
        assert meta["task"] == task and ("kpt_shape" in meta) == (task == "pose")
        if task == "pose":
            assert meta["kpt_shape"] == [5, 3]
        shapes = [o["shape"] for o in doc["outputs"]]
        assert shapes == {"segment": [[-1, -1, -1], [-1, -1, -1, -1]], "classify": [[-1, 3]]}.get(task, [[-1, -1, -1]])
        assert YOLO(_url(srv, task)).task == task


@pytest.fixture(scope="module")
def remote_local(served):
    """{task: (remote results, local results)} on colour frames of two sizes at conf 0.3."""
    srv, ckpts = served
    frames = [_frames(1, 3)[0], np.random.default_rng(4).integers(0, 255, (48, 80, 3), np.uint8)]
    out = {}
    for task in TASKS:
        kw = dict(imgsz=S, save=False) if task == "classify" else dict(imgsz=S, save=False, conf=0.3)
        out[task] = (YOLO(_url(srv, task), device="cpu").predict(frames, **kw),
                     YOLO(ckpts[task], device="cpu").predict(frames, **kw))
    return out


@pytest.mark.parametrize("task", list(TASKS))
def test_remote_predict_equals_local(remote_local, task):
    remote, local = remote_local[task]
    assert len(remote) == len(local) == 2
    for r, lo in zip(remote, local):
        if task == "classify":
            _close(r.probs.data, lo.probs.data, "probs", 1e-5)
            assert r.probs.top5 == lo.probs.top5 and r.boxes is None
            continue
        det_r, det_l = (x.obb.data if task == "obb" else x.boxes.data for x in (r, lo))
        assert det_r.shape == det_l.shape and len(det_l) > 0
        np.testing.assert_allclose(det_r, det_l, atol=1e-3, rtol=0)
        if task == "segment":
            assert r.masks.data.shape == lo.masks.data.shape
            assert (r.masks.data != lo.masks.data).mean() <= 1e-3
        if task == "pose":
            np.testing.assert_allclose(r.keypoints.data, lo.keypoints.data, atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def val_data(tmp_path_factory):
    """A detect split (JAX's `shapes` kind, 4 images at 64 px): the data every served model is scored on."""
    root = tmp_path_factory.mktemp("val_data")
    return {"path": str(root), "train": "images/train", "val": "images/val", "synthetic": "shapes", "n_train": 1,
            "n_val": 4, "gen_imgsz": S, "names": {0: "a", 1: "b"}}


@pytest.mark.parametrize("task", list(TASKS))
def test_remote_val_holds_jax_backend_validator(served, val_data, task):
    srv, _ = served
    kw = dict(data=dict(val_data), imgsz=S, batch=2, plots=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())  # its TensorBoard import takes ten seconds or more
        jax_model = JaxYOLO(_url(srv, task))
        if task == "classify":
            with pytest.raises(Exception):
                jax_model.val(**kw)
            with pytest.raises(ValueError, match="classifier"):
                YOLO(_url(srv, task), device="cpu").val(**kw)
            return
        ref = jax_model.val(**kw)
    got = YOLO(_url(srv, task), device="cpu").val(**kw)
    assert list(got) == list(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, (task, k, got[k], ref[k])
