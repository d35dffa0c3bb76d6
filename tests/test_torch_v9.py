"""The YOLOv9 family (and the shared RepConv) on the port against the JAX package's, on the CPU.

- The YAMLs: the port's copies under cfg/models/v9, v3, v5 and v6 read as
  PyYAML reads JAX's, their names equal JAX's listing, and find_model_yaml
  resolves yolov9c, yolov5n, yolov3-tiny, yolov6n (and the rest) as JAX's.
- Parsing, all 13 YAMLs: JAX's parse_model layer types, repeats, scaled
  args, output widths (CBLinear's a list) and save list; the layer count
  and the parameter count of JAX's init (jax.eval_shape); the fused
  bottlenecks the RepBottlenecks of JAX's RepNCSPELAN4 layers at the
  kernel's widths, the rest gated (yolov9c: 16 fused, none gated).
- RepConv's fold: folded() equals JAX's fuse_repconv on the same variables,
  and the folded eval against JAX's train-form eval (its branches) within
  atol 2e-5, rtol 1e-4, with the identity BN off and on, at stride 1 and 2.
  A fusable RepBottleneck at C = 32 runs the kernel's plain version on the
  CPU, against JAX's unfolded block.
- Modules: RepCSP, RepNCSPELAN4, ELAN1, AConv, ADown, SPPELAN, SPP,
  MaxPool2d, ZeroPad2d, ConvTranspose2d, CBLinear and CBFuse at small
  widths, with JAX's init tree filled with numpy-seeded values, carried to
  the port by the bridge: eval outputs within 1e-5 of the largest. CBFuse
  resizes by JAX's nearest rule at non-integer ratios too.
- Whole models at 64 px, B = 2: yolov9t and a narrowed yolov9e-like dict
  (nn.Identity at layer 0, read again by a later layer; CBLinear and
  CBFuse) on the port's init(seed) with seeded BN statistics, carried into
  JAX's graph by the reverse bridge: every output within 1e-4 of the
  largest, and the state dict's paths and shapes those of JAX's init.
  yolov9t in bf16 within twice JAX's own bf16-to-f32 distance of JAX's bf16
  graph (JAX runs RepConv's branches, the port the fold).
- The narrowed v9e's list outputs through embed, profile, info, the
  visualize stages and a torch.export trace.
- init(seed) draws CBLinear's, nn.ConvTranspose2d's and RepConv's leaves
  as JAX's init does; JAX's deploy-form variables (fuse_model, as its
  .stablehlo export's .ckpt holds them) load through the bridge as the fold.
- yolov9t through the trainer, validator and predictor: the first f32
  training step's loss items within 1e-4 relative of JAX's loss, val's
  results_dict within 1e-4 of JAX's DetectionValidator (which runs the
  branches), predict's detections equal to JAX's predictor's (which folds,
  fuse_model).
"""

import copy
import logging
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_families import _flat, _listify, _seeded, _shapes, _whole_flat
from test_torch_families_engine import _arrays, _batch, _self_labelled
from test_torch_fork_models import scaled_bn
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_tpu.nn.modules as J
import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
import spectrogram_yolov11_torch.nn.modules as T
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.engine.predictor import BasePredictor, feature_stages
from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer
from spectrogram_yolov11_torch.engine.validator import DetectionValidator
from spectrogram_yolov11_torch.nn.modules.head import Detect
from spectrogram_yolov11_torch.nn.tasks import (build_model, find_model_yaml, fold_modules, model_act, parse_model,
                                               yaml_model_load)
from spectrogram_yolov11_torch.ops.fused_conv import CHANNELS
from spectrogram_yolov11_torch.utils import yaml_load
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables, variables_to_state_dict
from spectrogram_yolov11_tpu.cfg import find_model_yaml as jax_find_model_yaml
from spectrogram_yolov11_tpu.engine.predictor import BasePredictor as JaxPredictor
from spectrogram_yolov11_tpu.engine.validator import DetectionValidator as JaxDetectionValidator
from spectrogram_yolov11_tpu.nn.modules.conv import fuse_repconv
from spectrogram_yolov11_tpu.nn.tasks import BaseModel as JaxBaseModel
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.nn.tasks import fuse_model as jax_fuse_model
from spectrogram_yolov11_tpu.nn.tasks import parse_model as jax_parse_model
from spectrogram_yolov11_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from spectrogram_yolov11_tpu.ops.losses import detection_loss as jax_detection_loss

ROOT = Path(__file__).resolve().parent.parent
PORT_CFG = ROOT / "spectrogram_yolov11_torch" / "cfg"
JAX_CFG = ROOT / "spectrogram_yolov11_tpu" / "cfg"
FAMILIES = ("v9", "v3", "v5", "v6")
YAMLS = sorted(f"{fam}/{p.name}" for fam in FAMILIES for p in (PORT_CFG / "models" / fam).glob("*.yaml"))
OUT_TOL, MODEL_TOL, ITEMS_RTOL, VAL_TOL = 1e-5, 1e-4, 1e-4, 1e-4
IMGSZ, BATCH, NB = 64, 2, 50
# yolov9e's routing at a small width: nn.Identity at 0 (read again by layer 9), CBLinear's lists and CBFuse
V9E_SMALL = {
    "nc": 3, "yaml_name": "v9e_small",
    "backbone": [
        [-1, 1, "nn.Identity", []],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "RepNCSPELAN4", [32, 32, 16, 1]],
        [-1, 1, "ADown", [64]],
        [-1, 1, "RepNCSPELAN4", [64, 64, 64, 2]],
        [1, 1, "CBLinear", [[16]]],
        [3, 1, "CBLinear", [[16, 32]]],
        [5, 1, "CBLinear", [[16, 32, 64]]],
        [0, 1, "Conv", [16, 3, 2]],
        [[6, 7, 8, -1], 1, "CBFuse", [[0, 0, 0]]],
        [-1, 1, "Conv", [32, 3, 2]],
        [[7, 8, -1], 1, "CBFuse", [[1, 1]]],
        [-1, 1, "ELAN1", [32, 32, 16]],
        [-1, 1, "AConv", [64]],
        [[8, -1], 1, "CBFuse", [[2]]],
        [-1, 1, "RepNCSPELAN4", [64, 64, 64, 1]],
        [-1, 1, "SPPELAN", [64, 32]],
    ],
    "head": [[[13, 17], 1, "Detect", ["nc"]]],
}


# -- the YAMLs and parsing --------------------------------------------------------------------


def test_yaml_copies_read_as_jax():
    names = [Path(n).name for n in YAMLS] + ["yolov9c", "yolov5n.yaml", "yolov5s-p6.yaml", "yolov3-tiny.yaml",
                                            "yolov6n.yaml", "yolov6l"]
    for name in names:
        assert find_model_yaml(name).relative_to(PORT_CFG / "models") == \
            jax_find_model_yaml(name).relative_to(JAX_CFG / "models"), name
    for fam in FAMILIES:
        mine = sorted(p.name for p in (PORT_CFG / "models" / fam).glob("*.yaml"))
        assert mine == sorted(p.name for p in (JAX_CFG / "models" / fam).glob("*.yaml")), fam
    assert len(YAMLS) == 13
    for name in YAMLS:
        assert yaml_load(PORT_CFG / "models" / name) == yaml.safe_load((JAX_CFG / "models" / name).read_text()), name
    assert yaml_model_load("yolov5n.yaml")["scale"] == jax_yaml_model_load("yolov5n.yaml")["scale"] == "n"


def _expected_bottlenecks(jspecs) -> list:
    """(layer, C) of each RepBottleneck of JAX's specs: RepNCSPELAN4(c1, c2,
    c3, c4, n) holds two RepCSP(., c4, n), each n RepBottleneck(c_, c_) at
    c_ = c4 / 2."""
    return [(s.i, int(s.args[3] * 0.5)) for s in jspecs if s.type == "RepNCSPELAN4" for _ in range(2 * s.args[4])]


_LAYER_PARAMS: dict = {}  # (JAX's layer spec, its input widths) -> the parameters of one instance
_NO_PARAMS = {"Concat", "nn.Upsample", "nn.MaxPool2d", "nn.ZeroPad2d", "nn.Identity", "CBFuse"}


def _jax_param_count(specs, jch) -> int:
    """JAX's parameter count of a model dict: each layer's init traced alone
    (jax.eval_shape on 8 x 8 maps of its input widths, n instances of a
    layer repeated n times), cached by module, arguments and input widths
    across the layers and the YAMLs, which share most of them; layers
    without parameters are not traced."""
    total = 0
    for s in specs:
        if s.type in _NO_PARAMS:
            continue
        f = s.f if isinstance(s.f, tuple) else (s.f,)
        widths = tuple(3 if s.i == 0 else jch[s.i + j if j < 0 else j] for j in f)  # -2: two layers back
        key = (s.cls, s.args, s.kwargs, widths)  # not the spec itself: it holds the layer's index and routes
        if key not in _LAYER_PARAMS:
            xs = [jnp.zeros((1, 8, 8, c)) for c in widths]
            m = s.build("m")
            shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), xs if isinstance(s.f, tuple) else xs[0],
                                                   train=False))
            _LAYER_PARAMS[key] = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
        total += s.n * _LAYER_PARAMS[key]
    return total


@pytest.mark.parametrize("name", YAMLS)
def test_parse_model_as_jax(name):
    """The port's parse_model on the meta device (built, nothing drawn)
    against JAX's; the parameter count against JAX's init tree."""
    d, jd = yaml_model_load(str(PORT_CFG / "models" / name)), jax_yaml_model_load(str(JAX_CFG / "models" / name))
    assert (d["scale"], d["yaml_name"]) == (jd["scale"], jd["yaml_name"])
    jspecs, jsave, jch = jax_parse_model(jd, 3, verbose=False)
    with torch.device("meta"):
        layers, _, save, specs = parse_model(d, 3, model_act(d))
    assert len(layers) == len(jspecs)
    assert [s["type"] for s in specs] == [s.type for s in jspecs]
    for i, (mine, ref) in enumerate(zip(specs, jspecs)):
        assert (mine["n"], _listify(mine["args"])) == (ref.n, _listify(ref.args)), (i, ref)
        assert {k: _listify(v) for k, v in mine["kwargs"].items()} == \
            {k: _listify(v) for k, v in dict(ref.kwargs).items()}, (i, ref)
    assert [_listify(s["c2"]) for s in specs] == [_listify(c) for c in jch] and save == list(jsave)
    assert specs[-1]["kwargs"]["legacy"] is True  # no C3k2-kin module: the legacy head (JAX :240)
    blocks = [(i, m) for i, layer in enumerate(layers) for m in layer.modules()
              if isinstance(m, T.Bottleneck) and (m.fusable or m.gated)]
    pairs = [(i, m.cv2.conv.out_channels) for i, m in blocks]
    assert sorted(pairs) == sorted(_expected_bottlenecks(jspecs))
    assert all(isinstance(m, T.RepBottleneck) and m.fusable == (c in CHANNELS) for (_, m), (_, c) in zip(blocks, pairs))
    if name == "v9/yolov9c.yaml":
        assert len(pairs) == sum(m.fusable for _, m in blocks) == 16
    assert sum(p.numel() for layer in layers for p in layer.parameters()) == _jax_param_count(jspecs, jch)


# -- RepConv's fold and the modules -------------------------------------------------------------


def _jax_case(jm, xs, seed: int):
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(seed), x), xs)
    variables = _seeded(dict(shapes), np.random.default_rng(seed))
    return variables, _flat(jax.jit(lambda v, x: jm.apply(v, x))(variables, xs))


def _port_eval(mod, variables, xs):
    """`mod` with the variables through the bridge, in eval and folded (fold_modules), on NCHW xs."""
    mod.load_state_dict(variables_to_state_dict(variables), strict=True)
    mod.eval()
    fold_modules(mod)
    with torch.no_grad():
        return _flat(mod(_nchw(xs)))


def _nchw(xs):
    if isinstance(xs, (list, tuple)):
        return type(xs)(_nchw(x) for x in xs)
    return torch.from_numpy(np.asarray(xs)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("bn, c2, s", [(False, 32, 1), (True, 32, 1), (True, 48, 2)])
def test_repconv_fold_matches_jax_branches(bn, c2, s):
    """folded() equals fuse_repconv; the folded conv in eval against JAX's
    branches (the identity BN only where bn, c1 == c2 and s == 1, as JAX's)."""
    seed = 7 + c2 + s
    xs = np.random.default_rng(seed).normal(0, 1, (2, 12, 12, 32)).astype(np.float32)
    variables, ref = _jax_case(J.RepConv(32, c2, 3, s, bn=bn), xs, seed)
    mod = T.RepConv(32, c2, 3, s, bn=bn)
    assert (mod.bn is not None) == ("bn" in variables["params"]) == (bn and c2 == 32 and s == 1)
    got = _port_eval(mod, variables, xs)
    np.testing.assert_allclose(got[0], ref[0], atol=2e-5, rtol=1e-4)
    w, b = mod.folded()
    jw, jb = fuse_repconv(variables["params"], variables["batch_stats"])
    np.testing.assert_allclose(w.detach().permute(2, 3, 1, 0).numpy(), jw, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), jb, atol=1e-6, rtol=1e-6)


def test_repconv_unfolded_eval_raises_and_train_runs_branches():
    mod = T.RepConv(8, 8, bn=True).eval()
    with pytest.raises(RuntimeError, match="not folded"):
        mod(torch.zeros(1, 8, 4, 4))
    with pytest.raises(ValueError, match="k = 3 and p = 1"):
        T.RepConv(8, 8, 1, p=0)
    mod.train()
    x = torch.randn(2, 8, 6, 6)
    ref = mod.act(mod.conv1(x) + mod.conv2(x) + mod.bn(x))
    torch.testing.assert_close(mod(x), ref)


def test_fused_repbottleneck_plain_kernel_matches_jax():
    """RepBottleneck(32, 32, e=1.0): fusable; in eval on the CPU the wrapper
    runs the kernel's plain version on the RepConv-then-BN fold, against
    JAX's unfolded block."""
    seed = 3
    xs = np.random.default_rng(seed).normal(0, 1, (2, 10, 10, 32)).astype(np.float32)
    variables, ref = _jax_case(J.RepBottleneck(32, 32, e=1.0), xs, seed)
    mod = T.RepBottleneck(32, 32, e=1.0)
    assert mod.fusable and not mod.gated and isinstance(mod.cv1, T.RepConv)
    got = _port_eval(mod, variables, xs)
    assert mod.w1 is not None and mod.cv1.w is None  # the RepConv's fold is in the bottleneck's pack
    np.testing.assert_allclose(got[0], ref[0], atol=OUT_TOL * float(np.abs(ref[0]).max()), rtol=0)
    assert T.RepBottleneck(16, 16, e=1.0).gated and not T.RepBottleneck(32, 32, e=0.5).fusable


def jx(cls, *args, **kwargs):
    return lambda: cls(*args, **kwargs)


CASES = {
    "RepCSP": (jx(J.RepCSP, 32, 64, 2), lambda: T.RepCSP(32, 64, 2), 32),
    "RepNCSPELAN4": (jx(J.RepNCSPELAN4, 32, 64, 64, 64, 1), lambda: T.RepNCSPELAN4(32, 64, 64, 64, 1), 32),
    "RepNCSPELAN4_gated": (jx(J.RepNCSPELAN4, 32, 48, 32, 16, 2), lambda: T.RepNCSPELAN4(32, 48, 32, 16, 2), 32),
    "ELAN1": (jx(J.ELAN1, 32, 64, 32, 16), lambda: T.ELAN1(32, 64, 32, 16), 32),
    "AConv": (jx(J.AConv, 32, 48), lambda: T.AConv(32, 48), 32),
    "ADown": (jx(J.ADown, 32, 64), lambda: T.ADown(32, 64), 32),
    "SPPELAN": (jx(J.SPPELAN, 32, 64, 16), lambda: T.SPPELAN(32, 64, 16), 32),
    "SPP": (jx(J.SPP, 32, 48), lambda: T.SPP(32, 48), 32),
    "SPP_3_7": (jx(J.SPP, 32, 48, (3, 7)), lambda: T.SPP(32, 48, (3, 7)), 32),
    "MaxPool2d": (jx(J.MaxPool2d, 2, 2, 0), lambda: torch.nn.MaxPool2d(2, 2, 0), 16),
    "MaxPool2d_s1": (jx(J.MaxPool2d, 3, 1, 1), lambda: torch.nn.MaxPool2d(3, 1, 1), 16),
    "ZeroPad2d": (jx(J.ZeroPad2d, (0, 1, 0, 1)), lambda: torch.nn.ZeroPad2d((0, 1, 0, 1)), 16),
    "ZeroPad2d_uneven": (jx(J.ZeroPad2d, (2, 0, 1, 3)), lambda: torch.nn.ZeroPad2d((2, 0, 1, 3)), 16),
    "ConvTranspose2d": (jx(J.TorchConvTranspose2d, 32, 16), lambda: T.TorchConvTranspose2d(32, 16), 32),
    "ConvTranspose2d_k4p1": (jx(J.TorchConvTranspose2d, 32, 16, 4, 2, 1),
                             lambda: T.TorchConvTranspose2d(32, 16, 4, 2, 1), 32),
    "CBLinear": (jx(J.CBLinear, 32, (8, 16, 24)), lambda: T.CBLinear(32, (8, 16, 24)), 32),
    "CBLinear_k3s2": (jx(J.CBLinear, 32, (8, 8), 3, 2), lambda: T.CBLinear(32, (8, 8), 3, 2), 32),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_matches_jax(name):
    jmake, tmake, ch = CASES[name]
    seed = len(name)
    xs = np.random.default_rng(seed).normal(0, 1, (2, 15, 15, ch)).astype(np.float32)  # odd: the pads and pools
    if name.startswith(("RepNCSP", "ELAN", "RepCSP", "SPP")):
        xs = xs[:, :14, :14]
    variables, ref = _jax_case(jmake(), xs, seed)
    got = _port_eval(tmake(), variables, xs)
    assert len(got) == len(ref)
    scale = max(float(np.abs(r).max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=OUT_TOL * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("sizes", [((4, 4), (8, 8), (2, 2)), ((5, 3), (7, 9), (8, 6)), ((8, 8), (3, 5), (6, 6))])
def test_cbfuse_matches_jax_nearest(sizes):
    """CBFuse on two CBLinear-like lists and a target map, each piece at its
    own size: downscales and non-integer ratios by jax.image.resize's
    nearest rule (F.interpolate's "nearest" picks other rows)."""
    (h0, w0), (h1, w1), (th, tw) = sizes
    rng = np.random.default_rng(h0 * 7 + w1)
    a = tuple(rng.normal(0, 1, (2, h0, w0, c)).astype(np.float32) for c in (8, 16))
    b = (rng.normal(0, 1, (2, h1, w1, 16)).astype(np.float32),)
    last = rng.normal(0, 1, (2, th, tw, 16)).astype(np.float32)
    ref = np.asarray(J.CBFuse((1, 0)).apply({}, [a, b, last]))
    got = T.CBFuse([1, 0])([_nchw(a), _nchw(b), _nchw(last)]).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


# -- whole models -------------------------------------------------------------------------------


def jax_model(jd: dict, stride):
    """JAX's model of the dict with the port's stride in place of its
    calibrating trace at 256 px (about 2 s a model on the CPU); each test
    that builds one holds the two strides equal through JAX's own forward
    (_assert_forward)."""
    with mock.patch.object(JaxBaseModel, "_calibrate_stride", lambda self: np.asarray(stride, np.float32)):
        return jax_build_model(jd, verbose=False)


def jax_bf16(jm):
    """A copy of JAX's model with its graph at bfloat16 (set_dtype: the same variables, no new calibration)."""
    return copy.copy(jm).set_dtype(jnp.bfloat16)


def _whole(name_or_dict, seed: int):
    d = yaml_model_load(name_or_dict) if isinstance(name_or_dict, str) else dict(name_or_dict)
    model = build_model(d).init(seed)
    scaled_bn(model, seed)
    jd = jax_yaml_model_load(name_or_dict) if isinstance(name_or_dict, str) else dict(name_or_dict)
    return model, jd


@pytest.fixture(scope="module")
def v9e_small():
    """The narrowed v9e on init(5) with seeded BN statistics: (model, JAX's
    model, input NHWC, its variables, JAX's f32 outputs)."""
    model, jd = _whole(V9E_SMALL, 5)
    x = np.random.default_rng(5).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    v = state_dict_to_variables(model.state_dict())
    jm = jax_model(jd, model.stride)
    shapes = jax.eval_shape(lambda: jm.graph.init(jax.random.PRNGKey(0), x[:1], train=False))
    for col in ("params", "batch_stats"):  # the bridge: the leaf paths and shapes of JAX's init
        assert _shapes(v[col]) == _shapes(dict(shapes[col])), col
    return model, jm, x, v, _whole_flat(jax.jit(lambda v, x: jm.graph.apply(v, x))(v, x))


def _assert_forward(model, x, ref, what):
    with torch.no_grad():
        got = _whole_flat(model(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert len(got) == len(ref) == 2 * len(model.stride)
    assert tuple(model.stride) == tuple(x.shape[1] / r.shape[1] for r in ref[::2])  # JAX's maps: its strides
    scale = max(float(np.abs(r).max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=MODEL_TOL * scale, rtol=0, err_msg=what)


def test_v9e_small_matches_jax(v9e_small):
    """The narrowed v9e (its state dict's leaf paths and shapes those of
    JAX's init, checked by the fixture) against JAX's graph."""
    model, _, x, _, ref = v9e_small
    _assert_forward(model, x, ref, "v9e_small")
    assert isinstance(model.model[0], torch.nn.Identity) and 0 in model.save
    assert [len(model.bottlenecks()[k]) for k in ("fused", "gated")] == [6, 2]


def test_bf16_within_jax_bf16_distance(v9e_small):
    """The port's bf16 copy of the narrowed v9e (set_dtype: RepConvs folded
    into bf16 weights, the fused bottlenecks in the bf16 pack) against JAX's
    bf16 graph, which runs RepConv's branches: within twice JAX's own
    bf16-to-f32 distance, per output."""
    model, jm, x, v, ref32 = v9e_small
    ref16 = _whole_flat(jax.jit(lambda v, x: jax_bf16(jm).graph.apply(v, x))(v, x))
    half = model.set_dtype(torch.bfloat16)
    fused = [m for m in half.modules() if isinstance(m, T.Bottleneck) and m.fusable]
    assert len(fused) == 6 and all(m.w1.dtype == torch.bfloat16 for m in fused) and model.dtype == torch.float32
    assert all(m.w.dtype == torch.bfloat16 for m in half.modules() if isinstance(m, T.RepConv) and m.w is not None)
    with torch.no_grad():
        out = half(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = _whole_flat([(b.float(), c.float()) for b, c in out])
    assert len(got) == len(ref16) == 4
    for g, r16, r32 in zip(got, ref16, ref32):
        r16 = np.asarray(r16, np.float32)
        d_jax = float(np.abs(r16 - r32).max())
        assert float(np.abs(g - r16).max()) <= 2 * d_jax


def test_list_outputs_through_embed_profile_info_visualize_and_export(v9e_small):
    """CBLinear's lists: embed of a CBLinear layer pools each piece; profile
    and info count every layer; the visualize stages skip the nn.Identity
    layer (no module in JAX's graph) and the list outputs; the eval graph
    traces with torch.export at a dynamic batch."""
    model = v9e_small[0]
    x = torch.rand(2, 3, IMGSZ, IMGSZ)
    with torch.no_grad():
        e = model(x, embed=(7, 17))
    assert e.shape == (2, 16 + 32 + 64)
    rows = model.profile(imgsz=IMGSZ, timed=False)
    assert len(rows) == len(model.model) and rows[10]["type"] == "CBFuse" and rows[6]["gflops"] > 0
    assert f"{len(model.model)} layers" in model.info(imgsz=IMGSZ)
    names = [n for _, n, _ in feature_stages(model)]
    assert "model_0" not in names and "model_6" in names and len(names) == len(model.model) - 1
    ep = torch.export.export(model, (x,), dynamic_shapes=({0: torch.export.Dim("batch", min=1, max=64)},))
    with torch.no_grad():
        ref = _whole_flat(model(x[:1]))
        got = _whole_flat(ep.module()(x[:1]))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0)


# -- yolov9t through the engine ------------------------------------------------------------------


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth64v9")
    d = {"path": str(root), "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
         "n_train": 4, "n_val": 4, "gen_imgsz": IMGSZ, "seed": 0, "names": {0: "LTE", 1: "RF"}}
    check_det_dataset(d)
    return d


@pytest.fixture(scope="module")
def v9t():
    """yolov9t at nc = 2: (dict, the port's model, its variables, JAX's model); class biases at 0."""
    d = yaml_model_load("yolov9t.yaml")
    d["nc"] = 2
    tm = build_model(d).init(9)
    scaled_bn(tm, 9)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, Detect):
                for seq in m.cv3:
                    seq[-1].bias.zero_()
    tm.eval()
    tm.names = {0: "LTE", 1: "RF"}
    v = state_dict_to_variables(tm.state_dict())
    jd = jax_yaml_model_load("yolov9t.yaml")
    jd["nc"] = 2
    jm = jax_model(jd, tm.stride)
    jm.names = dict(tm.names)
    return d, tm, v, jm


def test_yolov9t_matches_jax(v9t):
    _, tm, v, jm = v9t
    x = np.random.default_rng(9).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    _assert_forward(tm, x, _whole_flat(jax.jit(lambda v, x: jm.graph.apply(v, x))(v, x)), "yolov9t")


def test_jax_deploy_variables_load_as_the_fold(v9t):
    """JAX's fuse_model writes each RepConv as {"reparam": {kernel, bias}}
    (the .ckpt beside its .stablehlo export); the bridge reads it as
    branches whose fold is that conv, so the deploy tree gives the model's
    own outputs."""
    d, tm, v, jm = v9t
    _, deploy = jax_fuse_model(jm, v)
    assert "reparam" in str(jax.tree_util.tree_structure(deploy["params"]))
    model = build_model(d, variables=jax.tree_util.tree_map(np.asarray, deploy))
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, 3, IMGSZ, IMGSZ)).astype(np.float32))
    with torch.no_grad():
        got, ref = _whole_flat(model(x)), _whole_flat(tm(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-6 * float(np.abs(r).max()), rtol=0)


def test_yolov9t_first_train_step_equals_jax(v9t, data):
    """DetectionTrainer.train_step (f32, SGD, an accumulation step) runs the
    RepConvs' branches, as JAX's graph in training mode: the loss items
    within 1e-4 relative of JAX's detection_loss."""
    d, _, v, jm = v9t
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
    print(f"yolov9t: items {items.tolist()} (JAX {np.asarray(ref_items).tolist()})")
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=ITEMS_RTOL, atol=0)


def test_yolov9t_val_equals_jax(v9t, data, tmp_path):
    _, tm, v, jm = v9t
    split = _self_labelled(data, tm, tmp_path / "split")
    kw = dict(data=split, imgsz=IMGSZ, batch=BATCH, plots=False, workers=1, max_det=10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        ref = JaxDetectionValidator(jm, v, overrides=dict(kw, project=str(tmp_path / "jax")))(split)
    got = DetectionValidator(tm, overrides=dict(kw, project=str(tmp_path / "port"), device="cpu"))(split)
    print({k: round(x, 6) for k, x in got.items()})
    assert list(got) == list(ref) and got["metrics/mAP50(B)"] > 0.3
    for k, x in ref.items():
        assert abs(got[k] - x) <= VAL_TOL, (k, got[k], x)


def test_yolov9t_predict_equals_jax(v9t):
    """JAX's predictor folds the RepConvs (fuse_model); the port folds in every eval."""
    _, tm, v, jm = v9t
    kw = dict(imgsz=IMGSZ, conf=0.3, save=False)
    ref = JaxPredictor(jm, v, overrides=kw)(_arrays())
    got = BasePredictor(tm, overrides=dict(kw, device="cpu"), names=tm.names)(_arrays(), batch_size=2)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert len(g) == len(r) > 0
        np.testing.assert_array_equal(g.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(g.boxes.xyxy, r.boxes.xyxy, atol=1e-3, rtol=0)


def test_init_draws_jax_leaves_for_the_new_modules():
    """From-scratch init(seed) draws the new modules' leaves as JAX's init
    does: CBLinear's conv and bias U(+-1/sqrt(fan_in)) (torch_kernel_init,
    torch_bias_init), nn.ConvTranspose2d flax's lecun_normal with a zero
    bias, RepConv's BNs at 1 and 0; each against JAX's own init of the
    module (bounds, zero leaves, standard deviations within 15 %)."""
    model = build_model(dict(V9E_SMALL)).init(3)
    cbl = model.model[8].conv
    fan_in = cbl.weight[0].numel()
    jv = J.CBLinear(64, (16, 32, 64)).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 64)))["params"]["conv"]
    for t, r in ((cbl.weight, jv["kernel"]), (cbl.bias, jv["bias"])):
        bound = 1 / np.sqrt(fan_in)
        assert float(t.abs().max()) <= bound and float(np.abs(r).max()) <= bound
        assert abs(float(t.std()) / float(np.std(r)) - 1) < 0.15
    v6 = build_model(yaml_model_load("yolov6n.yaml")).init(3)
    ct = v6.model[11].conv_transpose
    jct = J.TorchConvTranspose2d(64, 64).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 64)))["params"]
    jct = jct["conv_transpose"]
    assert ct.weight.shape == (64, 64, 2, 2) and not ct.bias.any() and not np.asarray(jct["bias"]).any()
    assert abs(float(ct.weight.std()) / float(np.std(jct["kernel"])) - 1) < 0.15
    rep = next(m for m in model.modules() if isinstance(m, T.RepConv))
    for bn in (rep.conv1.bn, rep.conv2.bn):
        assert bool((bn.weight == 1).all() and (bn.bias == 0).all() and (bn.running_var == 1).all())


def test_unknown_activation_warns_and_keeps_silu(caplog):
    d = dict(V9E_SMALL, activation="nn.Mish()")
    with caplog.at_level(logging.WARNING, logger="spectrogram_yolov11_torch"):
        model = build_model(d)
    assert "unknown activation 'nn.Mish()'" in caplog.text
    assert model.default_act == "silu" and isinstance(model.model[1].act, torch.nn.SiLU)
