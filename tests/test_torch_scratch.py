"""Models from YAML on the port against the JAX package's, on the CPU.

- Build: `yolo11n.yaml`, the bare `yolo11n` and `spectrogram_yolo11n.yaml`
  give the port's facade a model whose leaves (through the weight bridge)
  have JAX's paths and shapes, and whose `info` line (layers, parameters)
  is JAX's; yaml_model_load gives JAX's dict. JAX's shapes come from
  jax.eval_shape of its init: no JAX init is compiled for them.
- GFLOPs at 640 px: the port counts 2 x the multiply-adds of every conv and
  matrix product (torch's flop counter); XLA's cost analysis also counts the
  elementwise work (BN's affine, SiLU's sigmoid and product, the residual
  adds, SPPF's max pools, attention's softmax: a few flops per conv output
  element, 16.35 M of them in yolo11n at 640 px, so at most about 1.3 % of
  its 6.5 GFLOPs at 5 flops each) and counts a padded conv's taps on the
  image only (a 3x3 conv loses at most its border rows and columns, well
  under 1 % at 640 px; 12 % at 64 px, where P5 is 2 x 2, so the test reads
  640 px). Tolerance: JAX's count within -1 % and +2 % of the port's
  (measured +0.42 %).
- Init (seed 0, as JAX's facade uses PRNGKey(0)): BN leaves and Detect's
  bias-init leaves equal JAX's init of yolo11n exactly (JAX's one compiled
  init in this file, at 64 px) and JAX's _bias_init of the spectrogram model.
  Every random leaf (the conv kernels) lies within +-1/sqrt(fan_in); its mean
  within 5 standard errors of 0 and its variance within 5 standard errors of
  b^2 / 3, the moments of U(-b, b) (for n draws the mean's standard error is
  b / sqrt(3n), the biased variance's about b^2 sqrt(4 / (45 n))); JAX's
  leaves meet the same test. The init is reproducible from the seed, another
  seed draws other weights, and reset_weights draws seed 0's again.
- Transfer: the trainer's nc rebuild (yolo11n 80 -> 2, spectrogram_yolo11n
  2 -> 1) and YOLO(yaml).load(ckpt) (every leaf of the trained model; the
  trained spectrogram model's into yolo11n, in part) graft the leaves JAX's
  _intersect_variables grafts on the same pair, no more and no fewer; the
  grafted leaves equal the source's and the rest the fresh init's.
- YOLO(yaml).load(ckpt) validates equal to YOLO(ckpt) (exactly, at 64 px on 4
  images); save writes what JAX's load_checkpoint reads back with the same
  variables and metadata keys as JAX's save, and JAX's saved file loads in
  the port with the checkpoint's weights.
- From scratch: YOLO("yolo11n.yaml").train on the CPU rebuilds for nc = 2
  with JAX's grafted count and trains; the trainer given no model builds
  args.model from args.seed; `python -m spectrogram_yolov11_torch detect
  val|predict|train` runs (in process, device=cpu), val printing the facade's
  metrics; AutoBackend and the server take a YAML.
"""

import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint
from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer
from spectrogram_yolov11_torch.nn.autobackend import AutoBackend
from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load
from spectrogram_yolov11_torch.serve import RemoteModel, serve
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables
from spectrogram_yolov11_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from spectrogram_yolov11_tpu.engine.model import YOLO as JaxYOLO
from spectrogram_yolov11_tpu.engine.model import _intersect_variables
from spectrogram_yolov11_tpu.nn.tasks import _to_mutable
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
IMGSZ = 64
Z = 5.0  # standard errors allowed for a leaf's mean and variance
FLOPS_TOL = (-0.01, 0.02)  # JAX's GFLOPs relative to the port's at 640 px (see above)
_JAX = {}


def _jax_shapes(name: str, nc=None):
    """(JAX model, its variables' shapes as plain dicts) without compiling its init."""
    if (name, nc) not in _JAX:
        m = jax_build_model(name, nc=nc, verbose=False)
        tree = jax.eval_shape(lambda: m.graph.init(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
        _JAX[name, nc] = m, _to_mutable(tree)
    return _JAX[name, nc]


def _leaves(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + (k,))
        elif v is not None:
            yield "/".join(pre + (k,)), v


def _flat(model) -> dict:
    return dict(_leaves(state_dict_to_variables(model.state_dict())))


def _grafted(dst_shapes: dict, src) -> set:
    """The paths JAX's _intersect_variables grafts from `src` onto `dst_shapes`: the merged leaves that are src's."""
    merged, n = _intersect_variables(dst_shapes, src)
    src_leaves = {id(v) for _, v in _leaves(src)}
    paths = {p for p, v in _leaves(merged) if id(v) in src_leaves}
    assert len(paths) == n
    return paths


@pytest.fixture(scope="module", autouse=True)
def no_jax_integrations():
    """JAX's facade without its logging integrations (TensorBoard's import costs 10 s; they touch no result)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        yield


@pytest.fixture(scope="module")
def jax_yolo11n():
    m = jax_build_model("yolo11n.yaml", verbose=False)
    return m, jax.tree_util.tree_map(np.asarray, m.init(jax.random.PRNGKey(0), imgsz=IMGSZ))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("scratch")
    d = {"path": str(root / "data"), "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
         "n_train": 4, "n_val": 4, "gen_imgsz": IMGSZ, "seed": 0, "names": {0: "LTE", 1: "RF"}}
    check_det_dataset(d)
    yaml_path = root / "data.yaml"
    yaml_path.write_text(f"path: {root / 'data'}\ntrain: images/train\nval: images/val\nnames:\n  0: LTE\n  1: RF\n")
    return root, d, yaml_path


@pytest.mark.parametrize("name,jax_name", [("yolo11n.yaml", "yolo11n.yaml"), ("yolo11n", "yolo11n.yaml"),
                                           ("spectrogram_yolo11n.yaml", "spectrogram_yolo11n.yaml")])
def test_model_builds_as_jax(name, jax_name):
    port = YOLO(name)
    assert port.overrides["model"] == jax_name
    if name != jax_name:  # the bare name, read as JAX's facade reads it
        assert JaxYOLO(name).overrides["model"] == jax_name
    jm, shapes = _jax_shapes(jax_name)
    assert {p: tuple(v.shape) for p, v in _flat(port.model).items()} == {p: tuple(v.shape) for p, v in _leaves(shapes)}
    assert port.info(flops=False) == jm.info(shapes, flops=False)
    drop = lambda d: {k: v for k, v in d.items() if k != "yaml_file"}  # noqa: E731
    assert drop(yaml_model_load(name)) == drop(jax_yaml_model_load(name))
    assert drop(port.model.yaml) == drop(jm.yaml) and port.model.stride == tuple(float(s) for s in jm.stride)


def test_gflops_against_xla(jax_yolo11n):
    jm, v = jax_yolo11n
    port, xla = YOLO("yolo11n.yaml").model.get_flops(640), jm.get_flops(v, 640)
    print(f"GFLOPs at 640 px: port {port:.4f}, XLA {xla:.4f} ({xla / port - 1:+.2%})")
    assert FLOPS_TOL[0] <= xla / port - 1 <= FLOPS_TOL[1]


def _deterministic(path: str) -> bool:
    """BN leaves and Detect's bias-init leaves (each level's last box and class conv bias)."""
    parts = path.split("/")
    return (parts[0] == "batch_stats" or parts[-2] == "bn"
            or (parts[-1] == "bias" and parts[-2].startswith(("cv2_", "cv3_")) and parts[-2].endswith("_2")))


def test_init_deterministic_leaves_equal_jax(jax_yolo11n):
    _, v = jax_yolo11n
    port, ref = _flat(YOLO("yolo11n.yaml").model), dict(_leaves(v))
    det = [p for p in ref if _deterministic(p)]
    assert len(det) == 2 * sum(p.endswith("/scale") for p in ref) + 2 * sum(p.endswith("/mean") for p in ref) + 6
    for p in det:
        np.testing.assert_array_equal(port[p], ref[p], err_msg=p)
    # the spectrogram model's head (nc = 2, its own strides): JAX's _bias_init on a zero tree of its shapes
    jm, shapes = _jax_shapes("spectrogram_yolo11n.yaml")
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    jm._bias_init(zeros)
    port = _flat(YOLO("spectrogram_yolo11n.yaml").model)
    head = {p: np.asarray(leaf) for p, leaf in _leaves(zeros) if p.endswith("_2/bias")}
    assert len(head) == 6
    for p, leaf in head.items():
        np.testing.assert_array_equal(port[p], leaf, err_msg=p)


def _uniform_ok(w: np.ndarray) -> bool:
    """w (HWIO) drawn from U(-b, b), b = 1/sqrt(kh * kw * cin/g): bounds, mean and variance."""
    n, b = w.size, 1.0 / np.sqrt(np.prod(w.shape[:3]))
    w = w.astype(np.float64)
    return (np.abs(w).max() <= b * (1 + 1e-6) and abs(w.mean()) <= Z * b / np.sqrt(3 * n)
            and abs(w.var() - b * b / 3) <= Z * b * b * np.sqrt(4 / 45 / n) + b * b / (3 * n))


def test_random_leaves_follow_the_init_distribution(jax_yolo11n):
    _, v = jax_yolo11n
    port = YOLO("yolo11n.yaml")
    for name, leaves in (("port", _flat(port.model)), ("jax", dict(_leaves(v)))):
        kernels = {p: w for p, w in leaves.items() if p.endswith("/kernel")}
        assert len(kernels) == sum(isinstance(m, torch.nn.Conv2d) for m in port.model.modules())
        assert not any(_deterministic(p) for p in kernels)
        bad = [p for p, w in kernels.items() if not _uniform_ok(np.asarray(w))]
        assert not bad, f"{name}: {bad}"
    again = YOLO("yolo11n.yaml").model.state_dict()
    other = build_model("yolo11n.yaml").init(1).state_dict()
    state = port.model.state_dict()
    assert all(torch.equal(state[k], again[k]) for k in state)
    assert not torch.equal(state["model.0.conv.weight"], other["model.0.conv.weight"])
    port.model.init(1)
    assert torch.equal(port.model.state_dict()["model.0.conv.weight"], other["model.0.conv.weight"])
    port.reset_weights()
    assert all(torch.equal(port.model.state_dict()[k], again[k]) for k in state)


@pytest.mark.parametrize("name,nc", [("yolo11n.yaml", 2), ("spectrogram_yolo11n.yaml", 1)])
def test_nc_rebuild_grafts_as_jax(name, nc, data):
    root, d, _ = data
    old = YOLO(name).model
    t = DetectionTrainer(old, {"data": dict(d, names={i: f"c{i}" for i in range(nc)}), "device": "cpu",
                               "project": str(root / "rebuild"), "seed": 3})
    t.setup_model()
    want = _grafted(_jax_shapes(name, nc)[1], _jax_shapes(name)[1])
    assert t.model.nc == nc and t.rebuilt == {"nc": (old.nc, nc), "grafted": len(want)}
    new, before, fresh = _flat(t.model), _flat(old), _flat(build_model(name, nc=nc).init(3))
    for p in new:
        np.testing.assert_array_equal(new[p], before[p] if p in want else fresh[p], err_msg=p)


@pytest.mark.parametrize("name", ["spectrogram_yolo11n.yaml", "yolo11n.yaml"])
def test_load_transfers_as_jax(name):
    tree, _ = jax_load_checkpoint(CKPT)
    src = tree.get("ema") or tree["variables"]
    want = _grafted(_jax_shapes(name)[1], src)
    port = YOLO(name)
    fresh = _flat(port.model)
    assert port.load(CKPT) is port and port.transferred == len(want)
    got, ref = _flat(port.model), dict(_leaves(src))
    for p in got:
        np.testing.assert_array_equal(got[p], ref[p] if p in want else fresh[p], err_msg=p)
    if name == "spectrogram_yolo11n.yaml":
        assert len(want) == len(ref) == 421


def test_load_then_val_and_save_round_trip(data, tmp_path):
    root, d, _ = data
    kw = dict(data=d, imgsz=IMGSZ, batch=2, device="cpu", plots=False)
    port = YOLO("spectrogram_yolo11n.yaml", device="cpu").load(CKPT)
    ref = YOLO(CKPT, device="cpu").val(**kw)
    assert port.val(**kw) == ref
    port.save(tmp_path / "port.ckpt")
    jtree, jmeta = jax_load_checkpoint(tmp_path / "port.ckpt")
    assert jtree["ema"] is None and jtree["opt_state"] is None and jmeta["epoch"] == -1
    ours = dict(_leaves(state_dict_to_variables(port.model.state_dict())))
    assert dict(_leaves(jtree["variables"])).keys() == ours.keys()
    for p, leaf in _leaves(jtree["variables"]):
        np.testing.assert_array_equal(leaf, ours[p], err_msg=p)
    jax_yolo = JaxYOLO(str(tmp_path / "port.ckpt"))
    jax_yolo.save(tmp_path / "jax.ckpt")
    assert load_checkpoint(tmp_path / "jax.ckpt")[1].keys() == jmeta.keys() == load_checkpoint(tmp_path / "port.ckpt")[1].keys()
    assert jmeta["model_yaml"] == {k: v for k, v in port.model.yaml.items() if k != "yaml_file"}
    back = YOLO(tmp_path / "jax.ckpt", device="cpu")
    assert _flat(back.model).keys() == ours.keys() and all(np.array_equal(_flat(back.model)[p], ours[p]) for p in ours)
    assert back.val(**kw) == ref
    assert port.eval() is port and port.fuse() is port and port.transforms is None
    # embed and profile run on the loaded model (held to JAX's in tests/test_torch_artifacts.py)
    rows = port.profile(imgsz=32, timed=False)
    assert [r["i"] for r in rows] == list(range(len(port.model.model)))
    assert sum(r["params"] for r in rows) == sum(p.numel() for p in port.model.parameters())
    (vec,) = port.embed(np.zeros((20, 30, 3), np.uint8), imgsz=32)
    assert vec.dtype == np.float32 and vec.ndim == 1 and np.isfinite(vec).all()


def test_from_scratch_train_on_cpu(data):
    root, d, _ = data
    yolo = YOLO("yolo11n", device="cpu")
    metrics = yolo.train(data=d, epochs=1, imgsz=IMGSZ, batch=2, workers=1, project=str(root), name="scratch",
                         exist_ok=True, plots=False)
    want = len(_grafted(_jax_shapes("yolo11n.yaml", 2)[1], _jax_shapes("yolo11n.yaml")[1]))
    assert yolo.trainer.rebuilt == {"nc": (80, 2), "grafted": want} and yolo.model.nc == 2
    assert all(np.isfinite(v) for v in metrics.values())
    _, meta = jax_load_checkpoint(yolo.trainer.last)
    assert meta["train_args"]["model"] == "yolo11n.yaml" and meta["nc"] == 2 and meta["model_yaml"]["nc"] == 2
    # the trainer given no model builds args.model at args.seed
    t = DetectionTrainer(None, {"data": d, "device": "cpu", "model": "spectrogram_yolo11n.yaml", "seed": 7,
                                "project": str(root / "none")})
    t.setup_model()
    ref = build_model("spectrogram_yolo11n.yaml", nc=2).init(7).state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in t.model.state_dict().items())


@pytest.mark.parametrize("verb", ["val", "predict", "train"])
def test_module_runner(verb, data, capsys, monkeypatch):
    root, d, yaml_path = data
    args = {"val": [f"model={CKPT}", f"data={yaml_path}", f"imgsz={IMGSZ}", "batch=2", "plots=False"],
            "predict": ["model=spectrogram_yolo11n.yaml", f"source={root / 'data' / 'images' / 'val'}",
                        f"imgsz={IMGSZ}", f"project={root}", "name=cli_predict"],
            "train": ["model=spectrogram_yolo11.yaml", f"data={yaml_path}", "epochs=1", f"imgsz={IMGSZ}", "batch=2",
                      "workers=1", f"project={root}", "name=cli", "exist_ok=True", "plots=False"]}[verb]
    monkeypatch.setattr(sys, "argv", ["spectrogram_yolov11_torch", "detect", verb, *args, "device=cpu"])
    with pytest.raises(SystemExit) as e:
        runpy.run_module("spectrogram_yolov11_torch", run_name="__main__")
    assert e.value.code == 0
    lines = capsys.readouterr().out.strip().splitlines()
    if verb == "val":
        assert json.loads(lines[-1]) == YOLO(CKPT, device="cpu").val(data=str(yaml_path), imgsz=IMGSZ, batch=2,
                                                                     plots=False)
    elif verb == "predict":
        assert len(lines) == 4 and all(line.split(": ")[0].endswith(".png") for line in lines)
        # at its defaults (save=True, as JAX's CLI) each image's plot is written as <stem>.jpg
        stems = sorted(Path(line.split(": ")[0]).stem for line in lines)
        assert sorted(p.stem for p in (root / "cli_predict").glob("*.jpg")) == stems
    else:
        assert (root / "cli" / "weights" / "last.ckpt").exists() and set(json.loads(lines[-1])) >= {"fitness"}


def test_autobackend_and_server_take_a_yaml():
    backend = AutoBackend("yolo11n", device="cpu")
    frames = np.zeros((2, IMGSZ, IMGSZ, 3), np.uint8)
    out = backend(frames)
    assert backend.kind == "yaml" and out.shape == (2, 84, 84) and backend.names[79] == "79"
    ref = YOLO("yolo11n.yaml").model  # the same fresh weights (seed 0)
    assert all(torch.equal(v, ref.state_dict()[k]) for k, v in backend.model.state_dict().items())
    srv = serve({"spec": "yolo11n.yaml"}, port=0, block=False, device="cpu")
    try:
        got = RemoteModel(srv.url)(frames)[0]
    finally:
        srv.shutdown()
    np.testing.assert_allclose(got, out.numpy(), rtol=1e-5, atol=1e-4)
