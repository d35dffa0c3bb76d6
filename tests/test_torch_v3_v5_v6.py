"""The YOLOv3, v5 and v6 families and the model YAML's `activation:` key on the port against the JAX package's, on the CPU.

- The `activation:` key (ROADMAP.md §3.56): yolo11.yaml with `activation:
  nn.ReLU()` prepended builds every act=True as ReLU in the port, as JAX's
  graph pins "relu"; its same-width bottlenecks are gated (the kernel
  computes SiLU), and its forward at 64 px lies within 1e-4 of JAX's
  largest output. Two models built in turn, or in two threads, keep their
  own activations. Every activation name of JAX's registry resolves and
  computes as JAX's (2e-6 on [-6, 6]).
- yolov5n (the 6x6 stride-2 stem, C3, SPPF), yolov3-tiny (ZeroPad2d([0, 1,
  0, 1]) then a stride-1 MaxPool2d(2), two levels) and yolov6n (ReLU,
  nn.ConvTranspose2d) at 64 px, B = 2, on the port's init(seed) with seeded
  BN statistics carried into JAX's graph: every output within 1e-4 of the
  largest; the first f32 training step's loss items within 1e-4 relative of
  JAX's detection_loss; predict's detections equal to JAX's predictor's.
- yolov6n in bf16 (set_dtype) against JAX's bf16 graph, and in amp training
  (set_compute_dtype(bfloat16), train mode) against JAX's bf16 training
  graph, each within twice JAX's own bf16-to-f32 distance (or one bf16 ulp
  of the output's largest value, where that is more; the f32 training
  forwards within 1e-3 of the largest: flax's one-pass BN variance): ReLU
  through both bf16 paths.
- yolov6n's val results_dict within 1e-4 of JAX's DetectionValidator.
"""

import copy
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import _whole_flat
from test_torch_families_engine import _arrays, _batch, _self_labelled
from test_torch_fork_models import scaled_bn
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)
from test_torch_v9 import jax_bf16, jax_model

import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
import spectrogram_yolov11_torch.nn.modules as T
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.engine.predictor import BasePredictor
from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer
from spectrogram_yolov11_torch.engine.validator import DetectionValidator
from spectrogram_yolov11_torch.nn.modules.conv import default_act, resolve_act_name
from spectrogram_yolov11_torch.nn.modules.head import Detect
from spectrogram_yolov11_torch.nn.tasks import MODELS_DIR, build_model, yaml_model_load
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables
from spectrogram_yolov11_tpu.engine.predictor import BasePredictor as JaxPredictor
from spectrogram_yolov11_tpu.engine.validator import DetectionValidator as JaxDetectionValidator
from spectrogram_yolov11_tpu.nn.modules.conv import ACTS as JAX_ACTS
from spectrogram_yolov11_tpu.nn.modules.conv import resolve_act_name as jax_resolve_act_name
from spectrogram_yolov11_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from spectrogram_yolov11_tpu.ops.losses import detection_loss as jax_detection_loss

NAMES = ("yolov5n.yaml", "yolov3-tiny.yaml", "yolov6n.yaml")
IMGSZ, BATCH, NB = 64, 2, 50
MODEL_TOL, ITEMS_RTOL, VAL_TOL = 1e-4, 1e-4, 1e-4


def _acts(model) -> set:
    return {type(m.act).__name__ for m in model.modules() if isinstance(m, T.Conv)}


def _x(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (BATCH, IMGSZ, IMGSZ, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_eval(jm):
    """JAX's eval forward of a model, jitted once per model: the tests that run it at one shape share its trace."""
    return jax.jit(lambda v, x: jm.graph.apply(v, x, train=False))


def _forward_matches(model, jm, x, tol=MODEL_TOL):
    v = state_dict_to_variables(model.state_dict())
    ref = _whole_flat(_jax_eval(jm)(v, x))
    with torch.no_grad():
        got = _whole_flat(model(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert len(got) == len(ref) == 2 * len(model.stride)
    assert tuple(model.stride) == tuple(x.shape[1] / r.shape[1] for r in ref[::2])  # JAX's maps: its strides
    scale = max(float(np.abs(r).max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=tol * scale, rtol=0)


# -- the activation key -----------------------------------------------------------------------


def test_relu_key_on_yolo11_matches_jax(tmp_path):
    """The fault's witness: the port once built SiLU whatever the key said."""
    path = tmp_path / "yolo11n.yaml"
    path.write_text("activation: nn.ReLU()\n" + (MODELS_DIR / "11" / "yolo11.yaml").read_text())
    model = build_model(yaml_model_load(path)).init(4)
    scaled_bn(model, 4)
    jm = jax_model(jax_yaml_model_load(path), model.stride)
    assert model.yaml["activation"] == "nn.ReLU()" and model.default_act == jm.default_act == "relu"
    assert isinstance(model.model[0].act, torch.nn.ReLU) and _acts(model) == {"ReLU", "Identity"}
    b, silu = model.bottlenecks(), build_model(yaml_model_load("yolo11n.yaml")).bottlenecks()
    assert not b["fused"] and not silu["gated"] and b["gated"] == silu["fused"] and len(b["gated"]) == 6
    _forward_matches(model, jm, _x(4))


def test_default_activation_does_not_leak_between_models():
    relu = build_model(yaml_model_load("yolov6n.yaml"))
    silu = build_model(yaml_model_load("yolov5n.yaml"))
    assert _acts(relu) == {"ReLU"} and _acts(silu) == {"SiLU"}
    barrier, out = threading.Barrier(2, timeout=60), {}

    def inside_relu():  # holds the ReLU default while the other thread builds
        with default_act("relu"):
            barrier.wait()
            barrier.wait()
            out["relu"] = T.Conv(3, 8)

    def builds_default():
        barrier.wait()
        out["model"] = build_model(yaml_model_load("yolov5n.yaml"))
        barrier.wait()

    threads = [threading.Thread(target=f) for f in (inside_relu, builds_default)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert isinstance(out["relu"].act, torch.nn.ReLU) and _acts(out["model"]) == {"SiLU"}
    assert isinstance(T.Conv(3, 8).act, torch.nn.SiLU)


@pytest.mark.parametrize("name", sorted(JAX_ACTS))
def test_activation_names_as_jax(name):
    """Every name JAX's registry knows (conv.py:39), read from a torch
    spelling by resolve_act_name and built by get_act, against JAX's function."""
    spelled = {"leakyrelu": "nn.LeakyReLU()", "hardswish": "nn.Hardswish()", "relu": "nn.ReLU()"}.get(name, name)
    assert resolve_act_name(spelled) == jax_resolve_act_name(spelled) == name
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    with default_act(name):
        got = T.Conv(1, 1).act(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JAX_ACTS[name](jnp.asarray(x))), atol=2e-6, rtol=0)
    assert resolve_act_name("nn.Mish()") is None and resolve_act_name("") is None


# -- the families ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """{name: (dict, the port's model, its variables, JAX's model)} at nc = 2, class biases 0."""
    out = {}
    for name in NAMES:
        d = yaml_model_load(name)
        d["nc"] = 2
        tm = build_model(d).init(len(name))
        scaled_bn(tm, len(name))
        with torch.no_grad():
            for m in tm.modules():
                if isinstance(m, Detect):
                    for seq in m.cv3:
                        seq[-1].bias.zero_()
        tm.names = {0: "LTE", 1: "RF"}
        jd = jax_yaml_model_load(name)
        jd["nc"] = 2
        jm = jax_model(jd, tm.stride)
        jm.names = dict(tm.names)
        out[name] = (d, tm, state_dict_to_variables(tm.state_dict()), jm)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, models):
    _, tm, _, jm = models[name]
    assert len(tm.stride) == (2 if "v3-tiny" in name else 3)
    assert _acts(tm) == ({"ReLU"} if "v6" in name else {"SiLU"})
    _forward_matches(tm, jm, _x(len(name)))


@pytest.mark.parametrize("name", NAMES)
def test_first_train_step_equals_jax(name, models, data):
    d, _, v, jm = models[name]
    batch = _batch()

    def loss_fn(params, img):
        out, _ = jm.graph.apply({"params": params, "batch_stats": v["batch_stats"]}, img, train=True,
                                mutable=["batch_stats"])
        return jax_detection_loss(out, jnp.asarray(batch["cls"]), jnp.asarray(batch["bboxes"]),
                                  jnp.asarray(batch["mask_gt"]), nc=2, imgsz=IMGSZ,
                                  strides=tuple(float(s) for s in jm.stride))

    _, ref_items = jax.jit(loss_fn)(v["params"], jnp.asarray(batch["img"], jnp.float32) / 255.0)
    port = DetectionTrainer(build_model(d, variables=v), dict(data=data, imgsz=IMGSZ, batch=BATCH, amp=False,
                                                              optimizer="SGD", workers=1, device="cpu"))
    port.setup_model()
    port.setup_optimizer(NB)
    _, items = port.train_step(batch, 3, False)
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=ITEMS_RTOL, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_predict_equals_jax(name, models):
    _, tm, v, jm = models[name]
    kw = dict(imgsz=IMGSZ, conf=0.3, save=False)
    ref = JaxPredictor(jm, v, overrides=kw)(_arrays())
    got = BasePredictor(tm, overrides=dict(kw, device="cpu"), names=tm.names)(_arrays(), batch_size=2)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert len(g) == len(r) > 0
        np.testing.assert_array_equal(g.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(g.boxes.xyxy, r.boxes.xyxy, atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth64v6")
    d = {"path": str(root), "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
         "n_train": 4, "n_val": 4, "gen_imgsz": IMGSZ, "seed": 0, "names": {0: "LTE", 1: "RF"}}
    check_det_dataset(d)
    return d


def test_yolov6n_val_equals_jax(models, data, tmp_path):
    _, tm, v, jm = models["yolov6n.yaml"]
    split = _self_labelled(data, tm, tmp_path / "split")
    kw = dict(data=split, imgsz=IMGSZ, batch=BATCH, plots=False, workers=1, max_det=10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        ref = JaxDetectionValidator(jm, v, overrides=dict(kw, project=str(tmp_path / "jax")))(split)
    got = DetectionValidator(tm, overrides=dict(kw, project=str(tmp_path / "port"), device="cpu"))(split)
    assert list(got) == list(ref) and got["metrics/mAP50(B)"] > 0.1  # the split is labelled with its own detections
    for k, x in ref.items():
        assert abs(got[k] - x) <= VAL_TOL, (k, got[k], x)


def _flat32(out) -> list:
    return [np.asarray(a, np.float32) for a in _whole_flat([(b.float(), c.float()) for b, c in out]
                                                          if torch.is_tensor(out[0][0]) else out)]


def _assert_within_jax_bf16(got, ref16, ref32):
    """Each bf16 output within twice JAX's own bf16-to-f32 distance of JAX's
    bf16 output, or one bf16 ulp of its largest f32 value where that is
    more: two bf16 results one rounding apart, where JAX's distance on a
    small output is below half an ulp (yolov6n's 4 x 4 class map on
    _x(12): one ulp, 1.95e-3, against JAX's 8.3e-4)."""
    for g, r16, r32 in zip(got, ref16, ref32):
        ulp = 2.0 ** (np.floor(np.log2(float(np.abs(r32).max()))) - 7)  # bf16: 8 significant bits
        assert float(np.abs(g - r16).max()) <= max(2 * float(np.abs(r16 - r32).max()), ulp)


def test_yolov6n_bf16_and_amp_within_jax_bf16_distance(models):
    """ReLU in bf16: the eval copy (set_dtype) against JAX's bf16 graph, and
    the training forward at compute dtype bf16 against JAX's bf16 training
    graph, each within JAX's own bf16-to-f32 distance as
    _assert_within_jax_bf16 sets it, output by output."""
    _, tm, v, jm = models["yolov6n.yaml"]
    jm16 = jax_bf16(jm)
    x = _x(len("yolov6n.yaml"))  # test_forward_matches_jax's input: its JAX trace is shared
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ref32, ref16 = _flat32(_jax_eval(jm)(v, x)), _flat32(_jax_eval(jm16)(v, x))
    half = tm.set_dtype(torch.bfloat16)
    assert _acts(half) == {"ReLU"} and half.dtype == torch.bfloat16
    with torch.no_grad():
        got = _flat32(half(xt))
    _assert_within_jax_bf16(got, ref16, ref32)

    def jax_train(graph):
        return _flat32(jax.jit(lambda v, x: graph.apply(v, x, train=True, mutable=["batch_stats"])[0])(v, x))

    tr32, tr16 = jax_train(jm.graph), jax_train(jm16.graph)
    port = copy.deepcopy(tm).train()
    with torch.no_grad():
        p32 = _flat32(port(xt))
        p16 = _flat32(port.set_compute_dtype(torch.bfloat16)(xt))
    for g32, r32 in zip(p32, tr32):  # f32: flax's one-pass BN variance (ROADMAP.md §3.34)
        np.testing.assert_allclose(g32, r32, atol=1e-3 * float(np.abs(r32).max()), rtol=0)
    _assert_within_jax_bf16(p16, tr16, tr32)
