"""The YOLOv8 and YOLOv10 families on the port against the JAX package's, on the CPU.

- The YAMLs: the port's 33 copies under cfg/models/v8, v10 and v10/fork
  read (utils.yaml_load) as PyYAML reads JAX's, their names equal JAX's
  listing, and find_model_yaml resolves each name as JAX's does; the port's cfg/datasets/ names equal JAX's, and
  check_det_dataset("hand-keypoints.yaml") gives JAX's kpt_shape and
  flip_idx (ROADMAP.md §3.47).
- Parsing: every buildable v8/v10 YAML and every YAML of cfg/models/11 at
  its first scale gives JAX's parse_model layer types, repeats, scaled args,
  output widths, save list and head kwargs (`legacy`, `end2end`), the
  model's `end2end` equal to JAX's, and the fused bottlenecks the
  same-width 3x3 bottlenecks of JAX's C2f, C2 and C3k2(c3k) layers. The fork
  configs' kwargs are held by tests/test_torch_fork_zoo.py. yolov8-world,
  -worldv2 and -rtdetr raise NotImplementedError naming ROADMAP item 11, as
  does every other name of JAX's MODULE_REGISTRY the port lacks.
- Modules: C2, GhostBottleneck, C3Ghost, ResNetBlock, ResNetLayer, SCDown,
  PSA, RepVGGDW, CIB, C2fCIB, the legacy Detect and v10Detect (each alone
  or inside another case) at (2, 16, 16, C) NHWC, with JAX's init tree
  (jax.eval_shape) filled with numpy-seeded values, carried to the port by
  the bridge;
  eval outputs within 1e-5 of the largest output. PSA below 64 channels
  raises where JAX's does; v10Detect's one2one branch takes no gradient to
  its inputs.
- Whole models at 64 px, B = 2: yolov8n, yolov8n-p6 (four levels),
  yolov8n-ghost, yolov8n-seg, yolov10n and yolov10n_WCC_sand3_new on the
  port's init(seed) with seeded BN statistics, carried into JAX's graph by
  the reverse bridge (JAX's jitted apply): every output within 1e-4 of the
  largest, both branches of a v10 head. For yolov8n, yolov10n and
  yolov10n_WCC_sand3_new the port's state dict has the leaf paths and
  shapes of JAX's init (jax.eval_shape): the bridge.
- decode_e2e within 1e-4 px of JAX's; nms_free_postprocess gives JAX's rows
  exactly on seeded scores built with many ties.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_fork_models import scaled_bn
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_tpu.nn.modules as J
import spectrogram_yolov11_torch.nn.modules as T
from spectrogram_yolov11_tpu.cfg import find_model_yaml as jax_find_model_yaml
from spectrogram_yolov11_tpu.data.dataset import check_det_dataset as jax_check_det_dataset
from spectrogram_yolov11_tpu.nn.tasks import YOLOGraph
from spectrogram_yolov11_tpu.nn.tasks import MODULE_REGISTRY as JAX_REGISTRY
from spectrogram_yolov11_tpu.nn.tasks import parse_model as jax_parse_model
from spectrogram_yolov11_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from spectrogram_yolov11_tpu.ops.decode import decode_e2e as jax_decode_e2e
from spectrogram_yolov11_tpu.ops.decode import nms_free_postprocess as jax_nms_free_postprocess
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.nn.tasks import MODULE_REGISTRY, build_model, find_model_yaml, parse_model, yaml_model_load
from spectrogram_yolov11_torch.ops.decode import decode_e2e, nms_free_postprocess
from spectrogram_yolov11_torch.ops.fused_conv import CHANNELS
from spectrogram_yolov11_torch.utils import yaml_load
from spectrogram_yolov11_torch.utils.jax_compat import sorted_leaves, state_dict_to_variables, variables_to_state_dict

ROOT = Path(__file__).resolve().parent.parent
PORT_CFG = ROOT / "spectrogram_yolov11_torch" / "cfg"
JAX_CFG = ROOT / "spectrogram_yolov11_tpu" / "cfg"
FAMILIES = ("v8", "v10", "v10/fork")
REFUSED = {"yolov8-world.yaml", "yolov8-worldv2.yaml", "yolov8-rtdetr.yaml"}
FAMILY_YAMLS = sorted(f"{fam}/{p.name}" for fam in FAMILIES for p in (PORT_CFG / "models" / fam).glob("*.yaml"))
BUILDABLE = [n for n in FAMILY_YAMLS if Path(n).name not in REFUSED]
ELEVEN = sorted(f"11/{p.name}" for p in (PORT_CFG / "models" / "11").glob("*.yaml"))
OUT_TOL, MODEL_TOL, BOX_TOL = 1e-5, 1e-4, 1e-4
IMGSZ = 64


def test_yaml_copies_read_as_jax():
    """The copies read as JAX's, and each name (bare, or with a scale letter)
    resolves to the same file under cfg/models/ as JAX's rglob search."""
    names = [Path(n).name for n in FAMILY_YAMLS] + ["yolov8n.yaml", "yolov8s-p6.yaml", "yolov8n-seg.yaml", "yolov10n",
                                                   "yolov10x.yaml", "yolo11n.yaml", "yolov10n_WCC_sand3_new"]
    for name in names:
        assert find_model_yaml(name).relative_to(PORT_CFG / "models") == \
            jax_find_model_yaml(name).relative_to(JAX_CFG / "models"), name
    for fam in FAMILIES:
        mine = sorted(p.name for p in (PORT_CFG / "models" / fam).glob("*.yaml"))
        assert mine == sorted(p.name for p in (JAX_CFG / "models" / fam).glob("*.yaml")), fam
    assert len(FAMILY_YAMLS) == 33 and len(BUILDABLE) == 30
    for name in FAMILY_YAMLS:
        assert yaml_load(PORT_CFG / "models" / name) == yaml.safe_load((JAX_CFG / "models" / name).read_text()), name


def test_dataset_yaml_names_equal_jax():
    names = sorted(p.name for p in (PORT_CFG / "datasets").glob("*.yaml"))
    assert names == sorted(p.name for p in (JAX_CFG / "datasets").glob("*.yaml"))
    assert "hand-keypoints.yaml" in names


def test_hand_keypoints_reads_as_jax():
    """The packaged pose set of 21 keypoints: kpt_shape and flip_idx as JAX's
    (its synthetic files go to the git-ignored datasets/ at first use, as the
    other packaged sets')."""
    mine = check_det_dataset("hand-keypoints.yaml")
    ref = jax_check_det_dataset("hand-keypoints.yaml")
    assert list(mine["kpt_shape"]) == list(ref["kpt_shape"]) == [21, 3]
    assert list(mine["flip_idx"]) == list(ref["flip_idx"]) and len(mine["flip_idx"]) == 21
    assert mine["names"] == ref["names"] and mine["nc"] == ref["nc"] == 1


def _listify(a):
    return [_listify(x) for x in a] if isinstance(a, (list, tuple)) else a


def _dicts(name: str):
    return yaml_model_load(str(PORT_CFG / "models" / name)), jax_yaml_model_load(str(JAX_CFG / "models" / name))


def _expected_bottlenecks(jspecs) -> list:
    """(layer, C) of each same-width 3x3 bottleneck of JAX's specs: C2f and C2
    with shortcut hold n Bottleneck(c, c, e=1.0) at c = int(c2 * e); C3k2
    with c3k holds n C3k(c, c, 2) of two Bottleneck(c_, c_) at c_ = c / 2."""
    out = []
    for s in jspecs:
        if s.type in ("C2f", "C2") and len(s.args) > 3 and s.args[3]:
            out += [(s.i, int(s.args[1] * (s.args[5] if len(s.args) > 5 else 0.5)))] * s.args[2]
        elif s.type == "C3k2" and len(s.args) > 3 and s.args[3]:
            c = int(s.args[1] * (s.args[4] if len(s.args) > 4 else 0.5))
            out += [(s.i, int(c * 0.5))] * (2 * s.args[2])
    return out


@pytest.mark.parametrize("name", BUILDABLE + ELEVEN)
def test_parse_model_as_jax(name):
    """The port's parse_model on the meta device (the modules are built, no
    weight is allocated or drawn) against JAX's."""
    d, jd = _dicts(name)
    assert (d["scale"], d["yaml_name"]) == (jd["scale"], jd["yaml_name"])
    jspecs, jsave, jch = jax_parse_model(jd, 3, verbose=False)
    with torch.device("meta"):
        layers, _, save, specs = parse_model(d, 3)
    assert [s["type"] for s in specs] == [s.type for s in jspecs]
    for i, (mine, ref) in enumerate(zip(specs, jspecs)):
        assert (mine["n"], _listify(mine["args"])) == (ref.n, _listify(ref.args)), (i, ref)
        assert {k: _listify(v) for k, v in mine["kwargs"].items() if k != "n"} == \
            {k: _listify(v) for k, v in dict(ref.kwargs).items()}, (i, ref)
    assert [s["c2"] for s in specs] == jch and save == list(jsave)
    if jspecs[-1].type in ("Detect", "v10Detect", "Segment", "Pose", "OBB"):  # v8: legacy, v10: end2end
        assert specs[-1]["kwargs"]["legacy"] == name.startswith("v8/")
        assert specs[-1]["kwargs"].get("end2end", False) == name.startswith("v10")
    pairs = [(i, m.cv2.conv.out_channels) for i, layer in enumerate(layers) for m in layer.modules()
             if isinstance(m, T.Bottleneck) and (m.fusable or m.gated)]
    assert sorted(pairs) == sorted(_expected_bottlenecks(jspecs))
    for i, layer in enumerate(layers):
        for m in layer.modules():
            if isinstance(m, T.Bottleneck) and (m.fusable or m.gated):
                assert m.fusable == (m.cv2.conv.out_channels in CHANNELS)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_other_families_refused_naming_item_11(name):
    with pytest.raises(NotImplementedError, match="item 11"):
        build_model(yaml_model_load(str(PORT_CFG / "models" / "v8" / name)))


MISSING = sorted(set(JAX_REGISTRY) - set(MODULE_REGISTRY))


@pytest.mark.parametrize("name", MISSING)
def test_missing_jax_module_raises_not_implemented(name):
    """Each name of JAX's registry the port lacks raises NotImplementedError
    naming its ROADMAP item, as a backbone layer of a model dict."""
    d = {"nc": 2, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, name, [16]]],
         "head": [[[0, 1], 1, "Concat", [1]]]}
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 item 11 \(other model families: "):
        build_model(d)
    assert re.fullmatch(r"[\w.]+", name)


# -- the modules ---------------------------------------------------------------------


def jx(cls, *args, **kwargs):
    return lambda: cls(*args, **kwargs)


HEAD_CH = (16, 32, 64)
# name: (JAX factory, port factory, input channels (one map, or the head's levels)). GhostBottleneck at
# stride 1 runs inside C3Ghost, ResNetBlock (with and without its shortcut conv) inside ResNetLayer, CIB
# and RepVGGDW inside C2fCIB (lk) and CIB_lk

CASES = {
    "C2": (jx(J.C2, 32, 32, 2), lambda: T.C2(32, 32, 2), 32),
    "GhostBottleneck_s2": (jx(J.GhostBottleneck, 32, 64, 3, 2), lambda: T.GhostBottleneck(32, 64, 3, 2), 32),
    "C3Ghost": (jx(J.C3Ghost, 32, 32, 2), lambda: T.C3Ghost(32, 32, 2), 32),
    "ResNetLayer_stem": (jx(J.ResNetLayer, 3, 16, 1, True), lambda: T.ResNetLayer(3, 16, 1, True), 3),
    "ResNetLayer": (jx(J.ResNetLayer, 32, 16, 2, False, 2), lambda: T.ResNetLayer(32, 16, 2, False, 2), 32),
    "SCDown": (jx(J.SCDown, 32, 64, 3, 2), lambda: T.SCDown(32, 64, 3, 2), 32),
    "PSA": (jx(J.PSA, 128, 128), lambda: T.PSA(128, 128), 128),
    "CIB_lk": (jx(J.CIB, 32, 32, True, 1.0, True), lambda: T.CIB(32, 32, True, 1.0, True), 32),
    "C2fCIB": (jx(J.C2fCIB, 32, 32, 1, True, True), lambda: T.C2fCIB(32, 32, 1, True, True), 32),
    "C2fCIB_plain": (jx(J.C2fCIB, 32, 64, 2), lambda: T.C2fCIB(32, 64, 2), 32),
    "Detect_legacy": (jx(J.Detect, 3, HEAD_CH, True), lambda: T.Detect(3, HEAD_CH, True), HEAD_CH),
    "v10Detect": (jx(J.Detect, 3, HEAD_CH, False, end2end=True), lambda: T.Detect(3, HEAD_CH, False, end2end=True),
                  HEAD_CH),
}


def _seeded(shapes, rng):
    """Values for JAX's init tree (its paths and shapes from jax.eval_shape,
    so no init compiles) drawn with numpy: kernels and dense weights
    U(+-1/sqrt(fan_in)) as JAX's torch_kernel_init, biases and BN scales
    and shifts N(0, 0.2) (BN scales around 1), BN means N(0, 0.1) and
    variances U(0.5, 1.5)."""
    def leaf(path, a):
        key = path[-1].key
        if key == "var":
            v = rng.uniform(0.5, 1.5, a.shape)
        elif key == "mean":
            v = rng.normal(0, 0.1, a.shape)
        elif key == "kernel":
            bound = 1 / np.sqrt(np.prod(a.shape[:-1]))
            v = rng.uniform(-bound, bound, a.shape)
        else:
            v = rng.normal(1.0 if key == "scale" else 0.0, 0.2, a.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _module_inputs(ch, seed: int):
    rng = np.random.default_rng(seed)
    if isinstance(ch, tuple):  # the head's levels at 8, 4, 2 px
        return [rng.normal(0, 1, (2, 8 >> i, 8 >> i, c)).astype(np.float32) for i, c in enumerate(ch)]
    return rng.normal(0, 1, (2, 8 if ch == 128 else 16, 8 if ch == 128 else 16, ch)).astype(np.float32)


def _flat(out) -> list:
    """Every array of a module's output, in order, as NHWC numpy."""
    if isinstance(out, dict):
        return _flat(out["one2many"]) + _flat(out["one2one"])
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    if torch.is_tensor(out):  # a map NCHW -> NHWC; a segment head's (B, A, nm) coefficients as they are
        return [(out.permute(0, 2, 3, 1) if out.ndim == 4 else out).detach().numpy()]
    return [np.asarray(out)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_matches_jax(name):
    jmake, tmake, ch = CASES[name]
    seed = len(name)
    xs = _module_inputs(ch, seed)
    jm = jmake()
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(seed), x), xs)
    variables = _seeded(dict(shapes), np.random.default_rng(seed))
    ref = _flat(jax.jit(lambda v, x: jm.apply(v, x))(variables, xs))
    mod = tmake()
    mod.load_state_dict(variables_to_state_dict(variables), strict=True)
    mod.eval()
    for m in mod.modules():
        if isinstance(m, T.Bottleneck) and m.fusable:
            m.fold()
    tx = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs] if isinstance(xs, list) else \
        torch.from_numpy(xs).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = _flat(mod(tx))
    assert len(got) == len(ref)
    scale = max(float(np.abs(r).max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=OUT_TOL * scale, rtol=0, err_msg=name)


def test_psa_below_64_channels_raises_as_jax():
    """PSA(64, 64): c = 32, so c // 64 = 0 heads; JAX's Attention divides by it at init, and so does the port's."""
    jm = J.PSA(64, 64)
    with pytest.raises(ZeroDivisionError):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 64)))
    with pytest.raises(ZeroDivisionError):
        T.PSA(64, 64)


def test_v10_one2one_branch_is_detached():
    """v10Detect's one2one branch runs on its inputs detached (JAX's stop_gradient):
    its outputs carry gradient to its own weights only, the one2many branch's to the inputs."""
    head = T.Detect(3, HEAD_CH, end2end=True)
    xs = [torch.randn(2, c, 8 >> i, 8 >> i, requires_grad=True) for i, c in enumerate(HEAD_CH)]
    out = head.train()(xs)
    one2one = sum(t.sum() for pair in out["one2one"] for t in pair)
    grads = torch.autograd.grad(one2one, xs + list(head.one2one_cv2.parameters()) + list(head.cv2.parameters()),
                                allow_unused=True)
    assert all(g is None for g in grads[:3])
    assert all(g is not None for g in grads[3:3 + len(list(head.one2one_cv2.parameters()))])
    assert all(g is None for g in grads[3 + len(list(head.one2one_cv2.parameters())):])
    one2many = sum(t.sum() for pair in out["one2many"] for t in pair)
    assert all(g is not None for g in torch.autograd.grad(one2many, xs))


# -- the bridge and whole models --------------------------------------------------------


def _shapes(tree) -> dict:
    return {"/".join(p): tuple(a.shape) for p, a in sorted_leaves(tree)}


WHOLE = ["yolov8n.yaml", "yolov8n-p6.yaml", "yolov8n-ghost.yaml", "yolov8n-seg.yaml", "yolov10n.yaml",
         "yolov10n_WCC_sand3_new.yaml"]
BRIDGED = {"yolov8n.yaml", "yolov10n.yaml", "yolov10n_WCC_sand3_new.yaml"}


def _whole_flat(out) -> list:
    if isinstance(out, dict):
        return _whole_flat(out["one2many"]) + _whole_flat(out["one2one"])
    if isinstance(out, tuple) and not isinstance(out[0], torch.Tensor) and not hasattr(out[0], "shape"):
        return _whole_flat(out[0]) + _whole_flat(list(out[1:]))
    return _flat(out)


@pytest.mark.parametrize("name", WHOLE)
def test_whole_model_matches_jax(name):
    seed = len(name)
    model = build_model(yaml_model_load(name)).init(seed)
    scaled_bn(model, seed)
    jd = jax_yaml_model_load(name)
    specs, save, _ = jax_parse_model(jd, 3, verbose=False)
    graph = YOLOGraph(specs=tuple(specs), save=tuple(save))
    x = np.random.default_rng(seed).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    variables = state_dict_to_variables(model.state_dict())
    if name in BRIDGED:  # the bridge: the leaf paths and shapes of JAX's init
        shapes = jax.eval_shape(lambda: graph.init(jax.random.PRNGKey(0), x[:1], train=False))
        for col in ("params", "batch_stats"):
            assert _shapes(variables[col]) == _shapes(dict(shapes[col])), col
    assert model.end2end == name.startswith("yolov10")
    ref = jax.jit(lambda v, x: graph.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    if name.startswith("yolov10"):
        assert isinstance(out, dict) and isinstance(ref, dict) and len(out["one2one"]) == 3
    got, ref = _whole_flat(out), _whole_flat(ref)
    if "-seg" in name:  # the prototypes: the port's NCHW, JAX's NHWC
        assert got[-1].shape == ref[-1].shape
    assert len(got) == len(ref) == {"yolov8n-p6.yaml": 8, "yolov8n-seg.yaml": 8}.get(name, 6 * (1 + ("10" in name)))
    scale = max(float(np.abs(r).max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=MODEL_TOL * scale, rtol=0, err_msg=name)


# -- decode and postprocess -----------------------------------------------------------------


def _feats(seed: int, nc: int, b: int = 2, shapes=((8, 8), (4, 4), (2, 2))):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 2, (b, h, w, 64)).astype(np.float32), rng.normal(0, 2, (b, h, w, nc)).astype(np.float32))
            for h, w in shapes]


def test_decode_e2e_matches_jax():
    feats = _feats(0, 5)
    ref = np.asarray(jax_decode_e2e([(jnp.asarray(b), jnp.asarray(c)) for b, c in feats], nc=5, strides=(8, 16, 32)))
    got = decode_e2e([(torch.from_numpy(b).permute(0, 3, 1, 2), torch.from_numpy(c).permute(0, 3, 1, 2))
                      for b, c in feats], 5, (8.0, 16.0, 32.0)).numpy()
    assert got.shape == ref.shape == (2, 84, 9)
    np.testing.assert_allclose(got[..., :4], ref[..., :4], atol=BOX_TOL, rtol=0)
    np.testing.assert_allclose(got[..., 4:], ref[..., 4:], atol=1e-6, rtol=0)
    assert (got[..., 2:4] >= got[..., :2]).all()  # xyxy


@pytest.mark.parametrize("max_det", [300, 20, 7])
def test_nms_free_postprocess_equals_jax_on_ties(max_det):
    """Scores drawn from a few levels, so most anchors tie on their best class and
    many (anchor, class) pairs tie on the second top-k: the rows, their order
    and classes equal JAX's exactly."""
    rng = np.random.default_rng(max_det)
    b, a, nc = 3, 84, 4
    boxes = rng.uniform(0, 64, (b, a, 4)).astype(np.float32)
    scores = rng.choice(np.float32([0.0, 0.25, 0.5, 0.75]), (b, a, nc)).astype(np.float32)
    scores[1] = 0.5  # one image of all-equal scores
    preds = np.concatenate([boxes, scores], -1)
    ref = np.asarray(jax_nms_free_postprocess(jnp.asarray(preds), max_det, nc))
    got = nms_free_postprocess(torch.from_numpy(preds), max_det, nc).numpy()
    assert got.shape == ref.shape == (b, min(max_det, a), 6)
    np.testing.assert_array_equal(got, ref)
