"""The Exporter and the artifact kinds of the port (engine/exporter.py, nn/autobackend.py, the kernels' operators in
ops/fused_conv.py and ops/nms_kernel.py) against the JAX package's, on the CPU.

Six tiny models at 64 px in JAX's layouts: detect, segment (nm 8), pose
(kpt_shape (5, 3)), OBB, classify and the v10Detect NMS-free head, each with
a C3k2 whose two 32-wide bottlenecks run the fused kernel's operator and a
head on one level (stride 8), on JAX-initialised weights (init at
PRNGKey(0)) carried through the bridge. Exporting is torch.export tracing
with symbolic shapes and loading parses them again, seconds each here, so
each artifact is written and loaded once for the module.

- The operators: on the CPU each gives its plain version's output bit for
  bit, and torch.library.opcheck passes for each on seeded inputs.
- export_formats has JAX's rows and gates; an unknown format raises
  ValueError, the TensorFlow rows ModuleNotFoundError without tensorflow and
  NotImplementedError naming item 9 with it, an artifact's or a served
  model's export ValueError; a missing TensorFlow or ONNX artifact
  FileNotFoundError.
- format="ckpt": JAX's AutoBackend reads the port's .ckpt and its forward
  agrees with JAX's build_inference_fn (atol 1e-5, rtol 1e-4, as
  tests/test_export_backend.py:104 holds JAX's own).
- format="stablehlo" writes the .pt2 program, its .ckpt and the weights
  pack; the reloaded program agrees with JAX's build_inference_fn at
  nms=False at the example's batch and size and at another batch and size,
  within the same tolerance; at nms=True it gives JAX's kept rows (n_valid
  and classes equal, boxes and keypoints within 1e-3 px, the rest within
  1e-4); the pack's leaves and the frames fed to the program's graph give
  its output.
- JAX's own .stablehlo artifact loads in the port through its sidecar
  .ckpt, and its predict gives JAX's boxes within 1e-3 px (as
  tests/test_export_backend.py:184 holds JAX's); without the sidecar it
  raises FileNotFoundError, as JAX's.
- YOLO(.pt2).predict and .val give the .ckpt's rows and metrics; `yolo
  export` writes the artifact; a CPU server of the .pt2 answers as a local
  AutoBackend of it.
"""

import copy
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.cfg import entrypoint
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.engine.exporter import Exporter, build_inference_fn, export_formats
from spectrogram_yolov11_torch.nn import autobackend
from spectrogram_yolov11_torch.nn.autobackend import AutoBackend
from spectrogram_yolov11_torch.nn.tasks import build_model
from spectrogram_yolov11_torch.ops import fused_conv, nms_kernel
from spectrogram_yolov11_torch.serve import RemoteModel, serve
from spectrogram_yolov11_tpu.engine.exporter import Exporter as JaxExporter
from spectrogram_yolov11_tpu.engine.exporter import build_inference_fn as jax_build_inference_fn
from spectrogram_yolov11_tpu.engine.model import YOLO as JaxYOLO
from spectrogram_yolov11_tpu.nn import autobackend as jax_autobackend
from spectrogram_yolov11_tpu.nn.autobackend import AutoBackend as JaxAutoBackend
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model

S = 64
ATOL, RTOL, PX_TOL, ROW_TOL = 1e-5, 1e-4, 1e-3, 1e-4
MASK_SHARE = 1e-2  # mask pixels of the kept rows that one crop keeps and the other zeroes
CONF, MAX_DET = 1e-5, 20  # a JAX-initialised model's class scores start near 2e-4
BACKBONE = [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "C3k2", [128, True]],
            [-1, 1, "Conv", [64, 3, 2]]]
HEADS = {"detect": ["Detect", ["nc"]], "segment": ["Segment", ["nc", 8, 16]], "pose": ["Pose", ["nc", "kpt_shape"]],
         "obb": ["OBB", ["nc", 1]], "v10": ["v10Detect", ["nc"]]}
MODELS = {name: {"nc": 3, "kpt_shape": [5, 3], "scale": "n", "backbone": BACKBONE,
                 "head": [[[3], 1, head, args]]} for name, (head, args) in HEADS.items()}
MODELS["classify"] = {"nc": 5, "scale": "n", "backbone": BACKBONE, "head": [[-1, 1, "Classify", ["nc"]]]}
# v10's and the classifier's graphs are the same at either nms; pose carries its keypoints through the NMS
# of segment's coefficients (ops/nms.py:non_max_suppression_extras), and is held to JAX at nms=False
NMS_TASKS = ("detect", "segment", "obb")


@pytest.fixture(scope="module")
def models():
    """{name: (model dict, JAX model, its variables from init(PRNGKey(0)), the port's model carried across)}."""
    out = {}
    for name, d in MODELS.items():
        jm = jax_build_model(copy.deepcopy(d), verbose=False)
        v = jax.device_get(jm.init(jax.random.PRNGKey(0), imgsz=S))
        tm = build_model(copy.deepcopy(d), variables=v)
        tm.names = {i: f"class{i}" for i in range(tm.nc)}
        jm.names = dict(tm.names)
        out[name] = (d, jm, v, tm)
    return out


@pytest.fixture(scope="module")
def exported(models, tmp_path_factory):
    """exported(name, fmt, nms) -> the path Exporter wrote, each artifact written once for the module."""
    cache = {}

    def get(name: str, fmt: str = "stablehlo", nms: bool = False) -> str:
        key = (name, fmt, nms)
        if key not in cache:
            root = tmp_path_factory.mktemp(f"{name}_{fmt}_{int(nms)}")
            cache[key] = Exporter(models[name][3], {"format": fmt, "imgsz": S, "nms": nms, "conf": CONF,
                                                    "max_det": MAX_DET, "device": "cpu", "project": str(root)})()
        return cache[key]

    return get


@pytest.fixture(scope="module")
def programs(exported):
    """programs(name, nms) -> the AutoBackend of that .pt2, each loaded once for the module."""
    cache = {}

    def get(name: str, nms: bool = False) -> AutoBackend:
        if (name, nms) not in cache:
            cache[name, nms] = AutoBackend(exported(name, nms=nms), device="cpu")
        return cache[name, nms]

    return get


def _frames(n: int = 2, h: int = S, w: int = S, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (n, h, w, 3), np.uint8)


def _tuple(out):
    return tuple(np.asarray(o) for o in (out if isinstance(out, tuple) else (out,)))


_JITTED = {}


def _jax(models, name, x, nms=False, **kw):
    """JAX's graph at nms, the exports' conf and max_det unless given (jitted once per setting)."""
    _, jm, v, _ = models[name]
    kw = {"conf": CONF, "max_det": MAX_DET, **kw} if nms or name == "v10" else {}  # else the graph takes neither
    key = (name, nms, tuple(sorted(kw.items())))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(jax_build_inference_fn(jm, nms=nms, **kw))
    return _tuple(_JITTED[key](v, jnp.asarray(x)))


def _close_all(got, ref, what):
    assert len(got) == len(ref), what
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(r, np.float64), atol=ATOL, rtol=RTOL,
                                   err_msg=f"{what} output {i}")


def _kept_rows(got, ref, name, what):
    """nms=True outputs: n_valid and the kept rows' classes equal, boxes and keypoints within PX_TOL px, the
    confidence (and an OBB row's angle) within ROW_TOL; a segment model's masks of the kept rows within ATOL."""
    np.testing.assert_array_equal(got[1], ref[1], err_msg=f"{what} n_valid")
    assert ref[1].sum() > 0, f"{what}: nothing kept"
    for b, n in enumerate(ref[1]):
        g, r = got[0][b, :n].astype(np.float64), ref[0][b, :n].astype(np.float64)
        cls_col = 6 if name == "obb" else 5
        np.testing.assert_array_equal(g[:, cls_col], r[:, cls_col], err_msg=f"{what} classes")
        np.testing.assert_allclose(g[:, :4], r[:, :4], atol=PX_TOL, err_msg=f"{what} boxes")
        np.testing.assert_allclose(g[:, 4:cls_col], r[:, 4:cls_col], atol=ROW_TOL, err_msg=f"{what} conf")
        np.testing.assert_allclose(g[:, cls_col + 1:], r[:, cls_col + 1:], atol=PX_TOL, err_msg=f"{what} keypoints")
        if name == "segment":  # equal but where a box edge within PX_TOL of JAX's moves a pixel across the crop
            g, r = got[2][b, :n], ref[2][b, :n]
            off = np.abs(g - r) > ATOL
            assert not (off & (g != 0) & (r != 0)).any() and off.mean() <= MASK_SHARE, f"{what} masks"


# -- the operators ----------------------------------------------------------------------------------------------

def _bottleneck_args(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x, w1, b1, w2, b2 = (torch.randn(s, generator=g) * k for s, k in (
        ((2, 6, 5, 32), 1.0), ((3, 3, 32, 32), 0.1), ((32,), 0.1), ((3, 3, 32, 32), 0.1), ((32,), 0.1)))
    if dtype == torch.bfloat16:
        return x.bfloat16(), fused_conv.pack_bottleneck_weights_bf16(w1), b1, fused_conv.pack_bottleneck_weights_bf16(w2), b2
    return x, fused_conv.pack_bottleneck_weights(w1), b1, fused_conv.pack_bottleneck_weights(w2), b2


def _keep_args(seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 50, (2, 96, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 20, (2, 96, 2))], -1).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(rng.uniform(size=(2, 96)) > 0.3), 0.45


@pytest.mark.parametrize("op", ["fused_bottleneck_f32", "fused_bottleneck_bf16", "greedy_keep"])
def test_operators_equal_their_plain_versions(op):
    """Each registered operator gives its plain version's output bit for bit on the CPU, and passes opcheck
    (schema, fake tensor, autograd registration, dynamic-shape dispatch)."""
    if op == "greedy_keep":
        args = _keep_args()
        got, ref = nms_kernel.greedy_keep(*args), nms_kernel.greedy_keep_reference(*args)
    else:
        args = _bottleneck_args(torch.bfloat16 if op.endswith("bf16") else torch.float32)
        x, p1, b1, p2, b2 = args
        if op.endswith("bf16"):
            ref = fused_conv.bottleneck_reference_bf16(x, fused_conv.unpack_bottleneck_weights_bf16(p1), b1,
                                                       fused_conv.unpack_bottleneck_weights_bf16(p2), b2)
        else:
            ref = fused_conv.bottleneck_reference(x, fused_conv.unpack_bottleneck_weights(p1), b1,
                                                  fused_conv.unpack_bottleneck_weights(p2), b2)
        got = fused_conv.fused_bottleneck(*args)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert torch.equal(getattr(torch.ops.syt, op)(*args), ref)
    torch.library.opcheck(getattr(torch.ops.syt, op), args)


# -- formats, refusals, sidecars --------------------------------------------------------------------------------

def test_export_formats_and_refusals(models, exported, tmp_path):
    rows = export_formats()
    tf_ok = importlib.util.find_spec("tensorflow") is not None
    assert rows == {"ckpt": {"suffix": ".ckpt", "available": True}, "stablehlo": {"suffix": ".pt2", "available": True},
                    "saved_model": {"suffix": "_saved_model", "available": tf_ok},
                    "tflite": {"suffix": ".tflite", "available": tf_ok},
                    "onnx": {"suffix": ".onnx", "available": tf_ok and importlib.util.find_spec("tf2onnx") is not None,
                             "experimental": True}}
    model = models["detect"][3]
    with pytest.raises(ValueError, match="unknown export format"):
        Exporter(model, {"format": "not_a_format", "project": str(tmp_path)})()
    for fmt in ("saved_model", "tflite", "onnx"):  # gated as JAX's; with tensorflow, no torch counterpart yet
        with pytest.raises(NotImplementedError if rows[fmt]["available"] else ModuleNotFoundError,
                           match="item 9" if rows[fmt]["available"] else "availability matrix"):
            Exporter(model, {"format": fmt, "project": str(tmp_path)})()
    with pytest.raises(ValueError, match="cannot be exported"):
        YOLO(exported("detect"), device="cpu").export(format="ckpt")
    for kind in ("best.tflite", "best.onnx", "best_saved_model"):
        with pytest.raises(FileNotFoundError, match=kind):
            AutoBackend(tmp_path / kind, device="cpu")


def test_metadata_sidecar_and_output_order(models, tmp_path):
    """The TensorFlow rows' metadata YAML: the port's Exporter._write_metadata and JAX's each read back through
    both packages' _load_metadata as the same dict; the port's _order_outs orders outputs as JAX's."""
    _, jm, v, tm = models["pose"]
    writers = {"port": Exporter(tm, {"imgsz": S, "nms": True})._write_metadata,
               "jax": JaxExporter(jm, v, {"imgsz": S, "nms": True})._write_metadata}
    want = {"task": "pose", "nc": 3, "names": {i: f"class{i}" for i in range(3)}, "stride": [8.0], "imgsz": S,
            "nms": True, "kpt_shape": [5, 3]}
    for who, write in writers.items():
        (tmp_path / who / "m_saved_model").mkdir(parents=True)
        for artifact in (tmp_path / who / "m.tflite", tmp_path / who / "m_saved_model"):
            write(artifact)
            assert autobackend._load_metadata(artifact) == jax_autobackend._load_metadata(artifact) == want, who
    assert autobackend._load_metadata(tmp_path / "none.onnx") == jax_autobackend._load_metadata(tmp_path / "none.onnx")
    rng = np.random.default_rng(0)
    proto, preds, nv = (rng.random(s, np.float32) for s in ((1, 16, 16, 8), (1, 84, 14), (1,)))  # JAX keeps f32
    for outs in ([proto, preds], [preds, proto], [nv, preds, proto], [preds]):
        got, ref = _tuple(autobackend._order_outs(outs)), _tuple(jax_autobackend._order_outs(outs))
        assert [g.shape for g in got] == [r.shape for r in ref]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


class _Runtime:
    """A stand-in TensorFlow and onnxruntime: each kind's artifact gives the outputs of `outputs(x)`, in the order
    a converter may leave them (the prototypes first)."""

    def __init__(self, outputs):
        self.tensorflow = NS(saved_model=NS(load=lambda path: NS(f=lambda x: tuple(outputs(x)))),
                             lite=NS(Interpreter=lambda model_path: _Interpreter(outputs)))
        self.onnxruntime = NS(InferenceSession=lambda path: NS(
            get_inputs=lambda: [NS(name="images")], run=lambda names, feed: list(outputs(feed["images"]))))


class _Interpreter:
    def __init__(self, outputs):
        self.outputs, self.x = outputs, None

    def allocate_tensors(self):
        pass

    def get_input_details(self):
        return [{"index": 0}]

    def set_tensor(self, index, x):
        self.x = x

    def invoke(self):
        pass

    def get_output_details(self):
        return [{"index": i} for i in range(len(self.outputs(self.x)))]

    def get_tensor(self, index):
        return self.outputs(self.x)[index]


@pytest.mark.parametrize("kind", ["m_saved_model", "m.tflite", "m.onnx"])
def test_runtime_kinds_as_jax_reads_them(models, tmp_path, monkeypatch, kind):
    """A TensorFlow or ONNX artifact, with the sidecar JAX's Exporter writes, run through stand-in runtimes: the
    port's AutoBackend gives JAX's AutoBackend's outputs, in its order, and its task, names, stride and nc."""
    _, jm, v, _ = models["segment"]
    art = tmp_path / kind
    art.mkdir() if kind.endswith("_saved_model") else art.touch()
    JaxExporter(jm, v, {"imgsz": S})._write_metadata(art)

    def outputs(x):  # the prototypes first, the rank-3 predictions second
        x = np.asarray(x, np.float32)
        return [np.full((len(x), 16, 16, 8), x.mean(), np.float32), np.full((len(x), 64, 11), x.std(), np.float32)]

    rt = _Runtime(outputs)
    monkeypatch.setitem(sys.modules, "tensorflow", rt.tensorflow)
    monkeypatch.setitem(sys.modules, "onnxruntime", rt.onnxruntime)
    port, ref = AutoBackend(art, device="cpu"), JaxAutoBackend(str(art))
    assert (port.task, port.names, port.nc) == (ref.task, ref.names, ref.nc) == ("segment", jm.names, 3)
    np.testing.assert_array_equal(port.stride, ref.stride)
    x = _frames()
    got, want = _tuple(port(x)), _tuple(ref.forward(jnp.asarray(x)))
    assert [g.shape for g in got] == [w.shape for w in want] == [(2, 64, 11), (2, 16, 16, 8)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the .ckpt row: read by JAX ---------------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_ckpt_loads_in_jax_autobackend(models, exported, name):
    path = exported(name, "ckpt")
    assert path.endswith("model.ckpt")
    backend = JaxAutoBackend(path)
    assert backend.task == models[name][3].task
    x = _frames()
    ref = _jax(models, name, x, conf=0.25, max_det=300)  # the graph AutoBackend runs: nms=False at the defaults
    _close_all(_tuple(backend.forward(jnp.asarray(x))), ref, f"{name} ckpt")


# -- the graph artifact: the .pt2 program -----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_program_matches_jax(models, exported, programs, name):
    """The reloaded program at nms=False against JAX's graph at the example's batch and size, and at B = 3,
    96 x 128 px; its sidecars beside it."""
    path = exported(name)
    assert path.endswith("model.pt2")
    for suffix in (".ckpt", ".weights.bin", ".weights.json"):
        assert Path(path).with_suffix(suffix).exists()
    backend = programs(name)
    assert backend.kind == "pt2" and not backend.nms and backend.task == models[name][3].task
    assert backend.names == {i: f"class{i}" for i in range(models[name][3].nc)}
    for x in (_frames(), _frames(3, 96, 128, seed=1)):
        _close_all(_tuple(backend(x)), _jax(models, name, x), f"{name} program at {x.shape}")


@pytest.mark.parametrize("name", NMS_TASKS)
def test_program_nms_matches_jax(models, programs, name):
    backend = programs(name, nms=True)
    assert backend.nms
    for x in (_frames(), _frames(3, 96, 128, seed=1)):
        _kept_rows(_tuple(backend(x)), _jax(models, name, x, nms=True), name, f"{name} nms program at {x.shape}")


@pytest.mark.parametrize("name", list(MODELS))
def test_weights_pack_feeds_the_graph(exported, programs, name):
    """The pack's leaves, in its manifest's order, and the frames, fed to the program's graph, give the
    program's output; the manifest holds the image input last, nms, task and names."""
    path = Path(exported(name))
    manifest = json.loads(path.with_suffix(".weights.json").read_text())
    assert manifest["image_input"]["dtype"] == "uint8" and manifest["image_input"]["shape"] == [1, S, S, 3]
    assert manifest["nms"] is False and manifest["names"] == {str(i): f"class{i}" for i in range(len(manifest["names"]))}
    blob = path.with_suffix(".weights.bin").read_bytes()
    leaves = [torch.from_numpy(np.frombuffer(blob, getattr(np, a["dtype"]), count=int(np.prod(a["shape"])),
                                             offset=a["offset"]).reshape(a["shape"]).copy()) for a in manifest["args"]]
    backend = programs(name)
    ep = backend.program
    specs = list(ep.graph_signature.input_specs)
    assert [s.target for s in specs[:-1]] == [a["name"] for a in manifest["args"]]
    assert specs[-1].kind == torch.export.graph_signature.InputKind.USER_INPUT
    x = torch.from_numpy(_frames())
    with torch.inference_mode():
        flat = ep.graph_module(*leaves, x)
        ref = backend(x)
    for g, r in zip(flat, ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(g, r)


# -- JAX's artifact read by the port ----------------------------------------------------------------------------

def test_jax_stablehlo_artifact_reads_in_port(models, tmp_path):
    _, jm, v, _ = models["detect"]
    path = JaxExporter(jm, v, {"format": "stablehlo", "imgsz": S, "batch": 1, "project": str(tmp_path)})()
    assert path.endswith(".stablehlo")
    backend = AutoBackend(path, device="cpu")
    assert backend.kind == "stablehlo" and backend.task == "detect"
    x = _frames()
    _close_all(_tuple(backend(x)), _jax(models, "detect", x), "JAX's stablehlo through its sidecar")
    img = _frames(1, 96, 128, seed=2)[0]
    kw = dict(imgsz=S, conf=0.0, max_det=8, verbose=False)
    got = YOLO(path, device="cpu").predict(img, save=False, **kw)[0].boxes.data
    ref = np.asarray(JaxYOLO(path).predict(img, **kw)[0].boxes.data)
    assert got.shape == ref.shape == (8, 6)
    np.testing.assert_array_equal(got[:, 5], ref[:, 5])
    np.testing.assert_allclose(got[:, :4], ref[:, :4], atol=PX_TOL)
    Path(path).with_suffix(".ckpt").unlink()
    with pytest.raises(FileNotFoundError, match="sidecar"):
        AutoBackend(path, device="cpu")


# -- the facade, the command line, serving ----------------------------------------------------------------------

def test_facade_predict_and_val_of_the_program(models, exported, programs, tmp_path):
    """YOLO(.pt2) predicts and validates as YOLO(its .ckpt); a program exported with nms=True refuses both, a
    `half` other than the export's raises, and YOLO(.pt2) is inference-only."""
    path = exported("detect")
    art, ckpt = YOLO(path, device="cpu"), YOLO(str(Path(path).with_suffix(".ckpt")), device="cpu")
    assert art.task == "detect" and art.names == ckpt.names
    imgs = list(_frames(3, 96, 128, seed=3))
    kw = dict(imgsz=S, conf=0.0, max_det=MAX_DET, save=False, verbose=False)
    for a, c in zip(art.predict(imgs, **kw), ckpt.predict(imgs, **kw)):
        np.testing.assert_array_equal(a.boxes.data, c.boxes.data)
    data = {"path": str(tmp_path / "synth"), "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
            "n_train": 0, "n_val": 2, "gen_imgsz": S, "seed": 0, "names": {i: f"class{i}" for i in range(3)}}
    check_det_dataset(data)
    got, ref = (m.val(data=data, imgsz=S, batch=2, plots=False, conf=0.0) for m in (art, ckpt))
    assert got.keys() == ref.keys() and all(abs(got[k] - ref[k]) <= 1e-6 for k in ref)
    rows = YOLO(exported("detect", nms=True), device="cpu")
    for mode in (lambda: rows.predict(imgs, **kw), lambda: rows.val(data=data, imgsz=S)):
        with pytest.raises(ValueError, match="nms=True"):
            mode()
    with pytest.raises(ValueError, match="half=False"):
        AutoBackend(path, half=True, device="cpu")
    assert programs("detect").half is False
    with pytest.raises(ValueError, match="inference-only"):
        art.train(data=data)


def test_yolo_export_command_line(models, tmp_path):
    ckpt = tmp_path / "tiny.ckpt"
    Exporter(models["pose"][3], {"format": "ckpt", "project": str(tmp_path / "src")})()
    (tmp_path / "src" / "export" / "model.ckpt").rename(ckpt)
    path = entrypoint(f"yolo export model={ckpt} format=ckpt project={tmp_path / 'out'}")
    assert path == str(tmp_path / "out" / "export" / "model.ckpt")
    assert YOLO(path, device="cpu").task == "pose"


def test_serving_the_program(exported, programs):
    """A CPU server of the .pt2 (the dispatcher's power-of-two buckets on the one dynamic-batch program)
    answers as a local AutoBackend of it; its metadata carries the task."""
    path = exported("segment")
    srv = serve({"exported": path}, port=0, block=False, device="cpu")
    try:
        remote = RemoteModel(srv.url)
        assert remote.metadata["task"] == "segment"
        local = programs("segment")
        x = _frames(3, seed=4)
        for got, ref in zip(remote(x), _tuple(local(x))):  # served at the bucket's B = 4: its convs round apart
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
        with pytest.raises(ValueError, match="cannot be exported"):
            YOLO(srv.url, device="cpu").export(format="ckpt")
    finally:
        srv.shutdown()
    with pytest.raises(ValueError, match="nms=True"):  # its rows are not what the server's clients decode
        serve({"rows": programs("detect", nms=True)}, port=0, block=False, device="cpu")


def test_program_device_and_meta(exported, programs):
    """The program records its export arguments, and AutoBackend keeps them; its leaves are on the CPU it was
    exported on, and build_inference_fn of the sidecar's model equals the program bit for bit (the same graph)."""
    from spectrogram_yolov11_torch.engine.pipeline import load_model

    path = exported("segment", nms=True)
    backend = programs("segment", nms=True)
    ep, meta = backend.program, backend.export_args
    assert meta == {"nms": True, "conf": CONF, "iou": 0.7, "max_det": MAX_DET, "half": False, "imgsz": S, "batch": 1,
                    "task": "segment", "device": "cpu"}
    assert all(t.device.type == "cpu" for t in ep.state_dict.values())
    assert programs("pose").kpt_shape == (5, 3)
    model = load_model(Path(path).with_suffix(".ckpt"))[0]
    x = torch.from_numpy(_frames())
    for g, r in zip(backend(x), build_inference_fn(model, nms=True, conf=CONF, max_det=MAX_DET)(x)):
        assert torch.equal(g, r)
