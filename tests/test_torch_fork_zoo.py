"""The fork's model zoo on the port against the JAX package's, on the CPU.

- The port's copies of the 139 fork YAMLs read (utils.yaml_load) as PyYAML
  reads JAX's, and yaml_model_load gives each name the scale JAX's gives it.
- One case per buildable detect config (136; tests/test_model_zoo.py's
  scale: n, the SMSC family at l): the port's parse_model gives JAX's
  parse_model's layer types, repeats, scaled args and output widths; the
  fused and gated bottlenecks are the same-width 3x3 bottlenecks of JAX's
  C3k2(c3k=True) layers, each fused where its width is in
  ops/fused_conv.py:CHANNELS; the port's model, with its init(seed),
  forwards a 64 px batch finitely in eval and in training mode, with a
  (box, cls) pair per level at JAX's strides.
- For 10 configs sampled with a seeded generator (and the ones the
  whole-config tests use), the state dict through the bridge has the leaf
  paths and shapes of JAX's init (jax.eval_shape).
- The bf16 copy of yolo11_fusion_sand3_new_GC against JAX's graph at
  dtype=bfloat16.
- The refusals: yolo11_DYHEAD.yaml (DyHeadBlock, ROADMAP item 11),
  yolo11-cls-resnet18.yaml (TorchVision and Classify, items 10 and 11), and
  yolo11_SChannel_bifpn.yaml, broken in the reference at every scale
  (tests/test_model_zoo.py:22), which raises in the port where JAX's raises:
  building it.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_fork_models import scaled_bn
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_tpu.nn.tasks import YOLOGraph
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.nn.tasks import parse_model as jax_parse_model
from spectrogram_yolov11_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load
from spectrogram_yolov11_torch.ops.fused_conv import CHANNELS
from spectrogram_yolov11_torch.utils import yaml_load
from spectrogram_yolov11_torch.utils.jax_compat import sorted_leaves, state_dict_to_variables

ROOT = Path(__file__).resolve().parent.parent
PORT_FORK = ROOT / "spectrogram_yolov11_torch" / "cfg" / "models" / "11" / "fork"
JAX_FORK = ROOT / "spectrogram_yolov11_tpu" / "cfg" / "models" / "11" / "fork"
REFUSED = {"yolo11_DYHEAD.yaml", "yolo11_SChannel_bifpn.yaml"}
BUILDABLE = sorted(p.name for p in PORT_FORK.glob("*.yaml") if p.name not in REFUSED)
DETECT = [n for n in BUILDABLE if n != "yolo11-cls-resnet18.yaml"]  # the classify config aside
SAMPLED = sorted(np.random.default_rng(0).choice(DETECT, 10, replace=False).tolist()
                 + ["yolo11_p2_WCC_BiFPN_AKCBam_head.yaml", "yolo11_recycleconv.yaml"])
IMGSZ = 64


def _dict(name: str, jax: bool = False) -> dict:
    d = (jax_yaml_model_load if jax else yaml_model_load)(str((JAX_FORK if jax else PORT_FORK) / name))
    d["scale"] = "l" if "SMSC" in name else "n"
    return d


def test_yaml_copies_read_as_jax():
    assert sorted(p.name for p in PORT_FORK.glob("*.yaml")) == sorted(p.name for p in JAX_FORK.glob("*.yaml"))
    assert len(BUILDABLE) == 137
    for p in sorted(JAX_FORK.glob("*.yaml")):
        mine = yaml_load(PORT_FORK / p.name)
        assert mine == yaml.safe_load(p.read_text()), p.name


@pytest.mark.parametrize("name", ["yolo11_HCA.yaml", "yolo11_AKCBam.yaml", "yolo11_SMSC.yaml",
                                  "yolo11_noP5_SMSC_all.yaml", "yolo11_p2_fusion.yaml", "yolo11n_HCA.yaml",
                                  "yolo11l_SMSC.yaml", "yolo11s_fusion_sand3_new_GC"])
def test_yaml_model_load_scale_as_jax(name):
    """JAX's names: a scale letter after the digits picks that scale of the fork config; its
    name regex also reads a trailing letter (yolo11_AKCBam -> m) as JAX's does."""
    mine, ref = yaml_model_load(name), jax_yaml_model_load(name)
    assert mine["scale"] == ref["scale"] and mine["yaml_name"] == ref["yaml_name"]
    assert Path(mine["yaml_file"]).name == Path(ref["yaml_file"]).name
    assert mine["backbone"] == ref["backbone"] and mine["head"] == ref["head"]


def _listify(a):
    return [_listify(x) for x in a] if isinstance(a, (list, tuple)) else a


def _expected_bottlenecks(jspecs) -> list:
    """(layer, C) of each same-width 3x3 bottleneck in JAX's specs: C3k2 with
    c3k set holds n C3k(c, c, 2), each two Bottleneck(c_, c_, e=1.0) with
    c = int(c2 * e), c_ = int(c * 0.5)."""
    out = []
    for s in jspecs:
        if s.type == "C3k2" and len(s.args) > 3 and s.args[3]:
            c = int(s.args[1] * (s.args[4] if len(s.args) > 4 else 0.5))
            out += [(s.i, int(c * 0.5))] * (2 * s.args[2])
    return out


@pytest.mark.parametrize("name", BUILDABLE)
def test_fork_config_builds_and_forwards(name):
    jspecs, jsave, _ = jax_parse_model(_dict(name, jax=True), 3, verbose=False)
    d = _dict(name)
    model = build_model(d)
    assert [s["type"] for s in model.specs] == [s.type for s in jspecs]
    for i, (mine, ref) in enumerate(zip(model.specs, jspecs)):
        assert (mine["n"], _listify(mine["args"])) == (ref.n, _listify(ref.args)), (i, ref)
        # the port's TorchVision takes its input's width, which JAX's flax module reads from its input
        assert {k: _listify(v) for k, v in mine["kwargs"].items()
                if k != "n" and not (k == "c1" and mine["type"] == "TorchVision")} == \
            {k: _listify(v) for k, v in dict(ref.kwargs).items()}, (i, ref)
    assert model.save == list(jsave)
    b = model.bottlenecks()
    want = _expected_bottlenecks(jspecs)
    assert sorted(b["fused"] + b["gated"]) == sorted(want)
    assert all(c in CHANNELS for _, c in b["fused"]) and not any(c in CHANNELS for _, c in b["gated"])

    model.init(0)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 3, IMGSZ, IMGSZ)).astype(np.float32))
    with torch.no_grad():
        outs = [model(x), model.train()(x)]
    model.eval()
    for out in outs:
        if model.task == "classify":  # yolo11-cls-resnet18: logits (B, nc)
            assert out.shape == (2, model.nc) and bool(torch.isfinite(out).all())
            continue
        assert [tuple(box.shape[-2:]) for box, _ in out] == [(int(IMGSZ / s),) * 2 for s in model.stride]
        assert all(bool(torch.isfinite(t).all()) for pair in out for t in pair)
        assert all(cls.shape[1] == model.nc for _, cls in out)


def _shapes(tree) -> dict:
    return {"/".join(p): tuple(a.shape) for p, a in sorted_leaves(tree)}


@pytest.mark.parametrize("name", SAMPLED)
def test_state_dict_has_jax_leaves(name):
    specs, save, _ = jax_parse_model(_dict(name, jax=True), 3, verbose=False)
    graph = YOLOGraph(specs=tuple(specs), save=tuple(save))
    shapes = jax.eval_shape(lambda: graph.init(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
    mine = state_dict_to_variables(build_model(_dict(name)).state_dict())
    for col in ("params", "batch_stats"):
        assert _shapes(mine[col]) == _shapes(dict(shapes[col])), col


def test_whole_config_bf16_matches_jax():
    """The bf16 copy (DetectionModel.set_dtype) of a fork config with Fusion,
    GlobalContext, FGM and a gated C3k, from the port's init(seed) with
    seeded BN statistics (scaled_bn), against
    JAX's graph at dtype=bfloat16 on the same weights (the reverse bridge), at
    64 px: within twice JAX's own bf16-to-f32 distance per output."""
    name, seed = "yolo11_fusion_sand3_new_GC.yaml", 3
    model = build_model(_dict(name)).init(seed)
    scaled_bn(model, seed)
    variables = state_dict_to_variables(model.state_dict())
    specs, save, _ = jax_parse_model(_dict(name, jax=True), 3, verbose=False)
    graph = YOLOGraph(specs=tuple(specs), save=tuple(save))
    x = np.random.default_rng(seed).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    pairs = lambda out: [np.asarray(t, np.float32) for pair in out for t in pair]  # noqa: E731
    want = pairs(graph.apply(variables, jnp.asarray(x), train=False))
    graph16 = YOLOGraph(specs=tuple(specs), save=tuple(save), dtype=jnp.bfloat16)
    ref16 = pairs(graph16.apply(variables, jnp.asarray(x, jnp.bfloat16), train=False))
    with torch.no_grad():
        out16 = model.set_dtype(torch.bfloat16)(tx)
    assert all(t.dtype == torch.bfloat16 for pair in out16 for t in pair)
    got16 = [t.float().permute(0, 2, 3, 1).numpy() for pair in out16 for t in pair]
    for g, w16, w32 in zip(got16, ref16, want):
        d_jax = float(np.abs(w16 - w32).max())
        assert float(np.abs(g - w16).max()) <= 2 * d_jax, (float(np.abs(g - w16).max()), d_jax)


def test_refusals():
    with pytest.raises(NotImplementedError, match="item 11"):
        build_model(PORT_FORK / "yolo11_DYHEAD.yaml")
    # yolo11-cls-resnet18 builds since the classify task (tests/test_torch_classify.py holds it to JAX's)
    resnet = build_model(PORT_FORK / "yolo11-cls-resnet18.yaml")
    assert resnet.task == "classify" and resnet.nc == 10 and type(resnet.model[0]).__name__ == "TorchVision"
    with pytest.raises(TypeError, match="concatenat"):
        jax_build_model(_dict("yolo11_SChannel_bifpn.yaml", jax=True), verbose=False)
    for scale in ("n", "l"):
        d = _dict("yolo11_SChannel_bifpn.yaml")
        d["scale"] = scale
        with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
            build_model(d)
