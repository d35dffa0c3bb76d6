"""Whole fork configs on the port against the JAX package's, and a fork
config through the facade, on the CPU at 64 px.

- Whole-config parity: five configs chosen to cover HCoordAtt with Fusion
  (yolo11_fusion_HCA), AKCBAM (SAKAM, LDConv) with Fusion on a P2 head and a
  gated C3k (yolo11_p2_bifpn_AKCBam, layer 37 at C = 16), AKCBAM with the
  BiFPN concats on a P2 head (yolo11_p2_WCC_BiFPN_AKCBam_head),
  GlobalContext and FGM (C3k2GC) with a gated C3k at C = 16
  (yolo11_fusion_sand3_new_GC, layer 27), and the SMSC family at its scale l
  (yolo11_SMSC: C3MSCk2 with DenseCross, the fused bottlenecks at C = 128;
  64 px at l costs about 1.3 s in JAX's apply, so no stand-in is needed).
  The weights are the port's init(seed) (JAX's distributions;
  tests/test_torch_fork.py holds the init kinds to JAX's) with seeded BN
  statistics (scaled_bn), carried into JAX's graph through the reverse
  bridge: JAX's
  eager init of a whole config costs 5-33 s on the CPU (its random draws
  compile per leaf shape), its apply under a second. Raw per-level (box,
  cls) outputs at B = 4 (one batch size, so JAX's eager ops compile once for
  each shape):
  - f32 eval within 1e-4 absolute plus 1e-4 relative (about 25 conv layers
    in f32, summed in other orders, and the port's fused bottlenecks hold BN
    folded into their weights; measured at most 9.5e-7);
  - bf16 eval: tests/test_torch_fork_zoo.py (this file's time is JAX's
    eager compile of each graph's ops, 4-16 s a config on the CPU);
  - training mode (BN batch statistics), on the last two, the outputs and the
    updated BN statistics within 4 times (+1e-5) how far JAX's own outputs
    move when x is perturbed by a relative 1e-6: BN over the 2 x 2 P5 maps
    of a few images divides by small spreads, so the rounding of the sums
    before it grows through the network (at B = 2 JAX moved 6.5e-3 on
    yolo11_SMSC for that perturbation, the port lay 1.5e-2 from it; at B = 4
    8.4e-4 and 1.8e-3).
- The facade: YOLO("yolo11_fusion_sand3_new_GC.yaml") trains one epoch on a
  tiny synthetic split (device="cpu", at its defaults: amp), with the nc
  rebuild grafting JAX's count (_intersect_variables on the same pair of
  eval_shape trees); val and predict(save=False) run; save -> YOLO(saved)
  validates equal; info() names the gated bottlenecks. The command line's
  detect predict and the server take the fork YAML.
"""

import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_tpu.engine.model import _intersect_variables
from spectrogram_yolov11_tpu.nn.tasks import YOLOGraph, _to_mutable
from spectrogram_yolov11_tpu.nn.tasks import parse_model as jax_parse_model
from spectrogram_yolov11_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.nn.autobackend import AutoBackend
from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load
from spectrogram_yolov11_torch.serve import RemoteModel, serve
from spectrogram_yolov11_torch.utils.jax_compat import sorted_leaves, state_dict_to_variables

ROOT = Path(__file__).resolve().parent.parent
IMGSZ = 64
TOL = 1e-4
TRAIN_MULTIPLE, ATOL = 4.0, 1e-5
CONFIGS = [("yolo11_fusion_HCA.yaml", "n"), ("yolo11_p2_bifpn_AKCBam.yaml", "n"),
           ("yolo11_p2_WCC_BiFPN_AKCBam_head.yaml", "n"), ("yolo11_fusion_sand3_new_GC.yaml", "n"),
           ("yolo11_SMSC.yaml", "l")]
FACADE = "yolo11_fusion_sand3_new_GC.yaml"


def _jax_graph(name: str, scale: str, dtype=None, nc=None) -> YOLOGraph:
    d = jax_yaml_model_load(name)
    d["scale"] = scale
    if nc:
        d["nc"] = nc
    specs, save, _ = jax_parse_model(d, 3, verbose=False)
    return YOLOGraph(specs=tuple(specs), save=tuple(save), dtype=dtype)


@torch.no_grad()
def scaled_bn(model, seed: int) -> None:
    """Seeded BN statistics (means N(0, 0.05), variances U(0.15, 0.25)) in
    place of init's 0 and 1, then eval mode (which folds the fused
    bottlenecks from them): the activations keep 0.05-0.9 standard deviation
    through the depth (about 0.02 with variance 1, where the head's biases
    are most of an output), and no BN divides by a small variance."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
            m.running_var.copy_(torch.empty(m.running_var.shape).uniform_(0.15, 0.25, generator=g))
    model.eval()


def _port(name: str, scale: str, seed: int):
    d = yaml_model_load(name)
    d["scale"] = scale
    model = build_model(d).init(seed)
    scaled_bn(model, seed)
    return model


def _pairs(out) -> list:
    return [np.asarray(t, np.float32) for pair in out for t in pair]


def _nhwc_pairs(out) -> list:
    return [t.detach().float().permute(0, 2, 3, 1).numpy() for pair in out for t in pair]


def _case(name: str, scale: str):
    seed = len(name)
    model = _port(name, scale, seed)
    return seed, model, state_dict_to_variables(model.state_dict()), _jax_graph(name, scale)


def _input(seed: int, b: int = 4):
    x = np.random.default_rng(seed).uniform(0, 1, (b, IMGSZ, IMGSZ, 3)).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name,scale", CONFIGS)
def test_whole_config_matches_jax(name, scale):
    seed, model, variables, graph = _case(name, scale)
    fused = model.bottlenecks()["fused"]
    assert fused and (name != "yolo11_SMSC.yaml" or 128 in {c for _, c in fused})
    x, tx = _input(seed)
    with torch.no_grad():
        got = _nhwc_pairs(model(tx))
    want = _pairs(graph.apply(variables, jnp.asarray(x), train=False))
    assert len(got) == len(want) == 2 * len(model.stride)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name,scale", [CONFIGS[3], CONFIGS[4]])
def test_whole_config_training_mode_matches_jax(name, scale):
    """Training mode at B = 4: outputs and the updated BN statistics, against
    JAX's own move under a relative 1e-6 perturbation of x."""
    seed, model, variables, graph = _case(name, scale)
    x4, tx4 = _input(seed + 1)
    x4b = (x4 * (1 + 1e-6 * np.random.default_rng(seed + 2).standard_normal(x4.shape))).astype(np.float32)
    (out, upd), (out_b, upd_b) = (graph.apply(variables, jnp.asarray(a), train=True, mutable=["batch_stats"])
                                  for a in (x4, x4b))
    with torch.no_grad():
        got = _nhwc_pairs(model.train()(tx4))
    stats = state_dict_to_variables(model.state_dict())["batch_stats"]
    leaves = [[np.asarray(a) for _, a in sorted_leaves(jax.tree_util.tree_map(np.asarray, dict(u["batch_stats"])))]
              for u in (upd, upd_b)]
    for what, mine, ref, moved in (("outputs", got, _pairs(out), _pairs(out_b)),
                                   ("BN statistics", [a for _, a in sorted_leaves(stats)], *leaves)):
        err = max(float(np.abs(a - b).max()) for a, b in zip(mine, ref))
        own = max(float(np.abs(a - b).max()) for a, b in zip(moved, ref))
        assert err <= TRAIN_MULTIPLE * own + ATOL, f"{what}: port {err} from JAX, JAX's own move {own}"


def _jax_shapes(nc=None) -> dict:
    graph = _jax_graph(FACADE, "n", nc=nc)
    return _to_mutable(jax.eval_shape(lambda: graph.init(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)),
                                                         train=False)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("fork")
    d = {"path": str(root / "data"), "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
         "n_train": 4, "n_val": 4, "gen_imgsz": IMGSZ, "seed": 0, "names": {0: "LTE", 1: "RF"}}
    check_det_dataset(d)
    return root, d


def test_fork_yaml_through_the_facade(data, tmp_path):
    d = data[1]
    yolo = YOLO(FACADE, device="cpu")
    assert yolo.model.yaml["scale"] == jax_yaml_model_load(FACADE)["scale"] == "n"
    metrics = yolo.train(data=d, epochs=1, imgsz=IMGSZ, batch=2, workers=1, project=str(tmp_path), name="fork",
                         exist_ok=True, plots=False)
    _, n = _intersect_variables(_jax_shapes(nc=2), _jax_shapes())
    assert yolo.trainer.rebuilt == {"nc": (80, 2), "grafted": n} and yolo.model.nc == 2
    assert all(np.isfinite(v) for v in metrics.values())

    kw = dict(data=d, imgsz=IMGSZ, batch=2, device="cpu", plots=False)
    val = yolo.val(**kw)
    assert all(np.isfinite(v) for v in val.values())
    frame = np.random.default_rng(0).integers(0, 255, (48, 64, 3), dtype=np.uint8)
    res = yolo.predict(frame, imgsz=IMGSZ, save=False, device="cpu")
    assert len(res) == 1 and res[0].boxes.data.shape[1] == 6
    yolo.save(tmp_path / "fork.ckpt")
    back = YOLO(tmp_path / "fork.ckpt", device="cpu")
    assert back.val(**kw) == val
    info = YOLO(FACADE, device="cpu").info(imgsz=IMGSZ)
    assert "gated (layer, C): (27, 16), (27, 16)" in info and "4 fused bottlenecks" in info


def test_command_line_and_server_take_a_fork_yaml(data, capsys, monkeypatch):
    """`python -m spectrogram_yolov11_torch detect predict model=<fork yaml>`
    (in process, device=cpu) and the server on the YAML (fresh weights, seed
    0) answering as a local AutoBackend of it."""
    root, _ = data
    monkeypatch.setattr(sys, "argv", ["spectrogram_yolov11_torch", "detect", "predict", f"model={FACADE}",
                                      f"source={root / 'data' / 'images' / 'val'}", f"imgsz={IMGSZ}", "save=False",
                                      "device=cpu"])
    with pytest.raises(SystemExit) as e:
        runpy.run_module("spectrogram_yolov11_torch", run_name="__main__")
    assert e.value.code == 0 and len(capsys.readouterr().out.strip().splitlines()) == 4
    frames = np.random.default_rng(1).integers(0, 255, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    local = AutoBackend(FACADE, device="cpu")
    assert local.kind == "yaml"
    srv = serve({"fork": FACADE}, port=0, block=False, device="cpu")
    try:
        got = RemoteModel(srv.url)(frames)[0]
    finally:
        srv.shutdown()
    np.testing.assert_allclose(got, local(frames).numpy(), rtol=1e-5, atol=1e-4)
