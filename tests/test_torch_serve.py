"""Serving on the port (spectrogram_yolov11_torch/serve.py) against the JAX package's, on the CPU.

Module-scoped servers on port 0: the port's InferenceServer with the trained
checkpoint on the CPU, and JAX's. The frames are 64 px (the metadata probe's
size), so the JAX server, its probe and the reference forward share one
compile; the JAX bf16 backend is the second.

Tolerances:
- The port's decoded predictions against JAX's AutoBackend(ckpt).forward:
  boxes within 1e-2 px and scores within 1e-4, the port's forward tolerance
  (tests/test_torch_pipeline.py), whichever side serves and whichever client
  asks. JAX's client reading JAX's server is JAX's forward exactly.
- Paths that run the same batch through the same network (BYTES against the
  raw tensor on the decoded pixels, gray upload against its 3-channel repeat,
  PNG wire encoding against raw) are equal exactly; JPEG wire bytes equal
  JAX's encode_images on the same frames.
- A request served in a group against the same request served alone (other
  batch sizes, so other oneDNN blockings): boxes within 1e-3 px, scores
  within 1e-5.
- Remote predict against local predict on a colour image at conf=0: classes
  equal, boxes within 1e-3 px; remote val against local val within 1e-6 per
  key.
- half=True: the port's bf16 server within 2 * d_jax of JAX's bf16 backend,
  for boxes and scores apart, where d_jax is JAX's own bf16-to-f32 distance
  (tests/test_torch_half.py's tolerance).

Run as a script (`PYTHONPATH=. python tests/test_torch_serve.py`), it prints
how long bursts of 64 concurrent connections wait on a stdlib HTTP server
with socketserver's listen backlog of 5 (the JAX server's) and with the
port's (serve.py:_HTTPServer), a 2 ms handler each.
"""

import json
import shutil
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_torch.serve as serve_module
import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.cfg import entrypoint
from spectrogram_yolov11_torch.engine.exporter import build_inference_fn
from spectrogram_yolov11_torch.nn.autobackend import AutoBackend
from spectrogram_yolov11_torch.ops.nms import non_max_suppression
from spectrogram_yolov11_torch.serve import InferenceServer, RemoteModel, _ModelRunner, encode_images, serve
from spectrogram_yolov11_torch.utils import kernels
from spectrogram_yolov11_tpu.nn.autobackend import AutoBackend as JaxAutoBackend
from spectrogram_yolov11_tpu.serve import InferenceServer as JaxInferenceServer
from spectrogram_yolov11_tpu.serve import RemoteModel as JaxRemoteModel
from spectrogram_yolov11_tpu.serve import encode_images as jax_encode_images

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "runs_artifacts" / "spectrogram_yolo11n.ckpt")
JPEG_SPLIT = {"path": str(ROOT / "tests" / "torch_data" / "jpeg" / "spectrogram"), "val": "images/val",
              "names": {0: "LTE", 1: "RF"}}
S = 64  # frame size: the metadata probe's


def _frames(n: int, seed: int, c: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (n, S, S, c), np.uint8)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _post(url, head: dict, blob: bytes = b""):
    """POST a KServe v2 infer request -> (HTTP status, JSON document)."""
    h = json.dumps(head).encode()
    headers = {"Content-Type": "application/json"}
    if blob:
        headers["Inference-Header-Content-Length"] = str(len(h))
    req = urllib.request.Request(url, data=h + blob, method="POST", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            payload, jlen = r.read(), r.headers.get("Inference-Header-Content-Length")
            return r.status, json.loads(payload[: int(jlen)] if jlen else payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def assert_forward_close(got: np.ndarray, ref: np.ndarray, px: float = 1e-2, score: float = 1e-4) -> None:
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got[..., :4], ref[..., :4], atol=px, rtol=0)
    np.testing.assert_allclose(got[..., 4:], ref[..., 4:], atol=score, rtol=0)


@pytest.fixture(scope="module")
def port_srv():
    srv = InferenceServer({"spec": CKPT}, port=0, device="cpu").start()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def jax_srv():
    # the JAX facade's logging integrations (TensorBoard through tensorflow) take ten seconds or more to import
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        srv = JaxInferenceServer({"spec": CKPT}, port=0).start()
    yield srv
    srv.shutdown()


def test_health_and_metadata_match_jax(port_srv, jax_srv):
    base, jbase = (f"http://127.0.0.1:{s.port}" for s in (port_srv, jax_srv))
    for path in ("/v2/health/live", "/v2/health/ready", "/v2/models/spec/ready"):
        assert _get(base + path) == {}
    assert _get(base + "/v2") == {"name": "spectrogram_yolov11_torch", "extensions": ["binary_tensor_data"]}
    assert _get(jbase + "/v2")["extensions"] == ["binary_tensor_data"]
    md, jmd = _get(base + "/v2/models/spec"), _get(jbase + "/v2/models/spec")
    assert (md.pop("platform"), jmd.pop("platform")) == ("pytorch", "jax_xla")
    meta, jmeta = (json.loads(d["parameters"].pop("metadata")) for d in (md, jmd))
    assert meta == jmeta == {"task": "detect", "names": {"0": "LTE", "1": "RF"}, "stride": [8.0, 16.0, 32.0], "nc": 2}
    assert md == jmd and md["outputs"] == [{"name": "output0", "datatype": "FP32", "shape": [-1, -1, -1]}]


def test_protocol_both_ways(port_srv, jax_srv):
    """JAX's client on the port's server and the port's client on JAX's
    server, against JAX's AutoBackend(ckpt).forward (the JAX server's own)."""
    x = _frames(1, 0)
    ref = np.asarray(jax_srv.models["spec"].backend.forward(x))
    assert_forward_close(JaxRemoteModel(port_srv.url)(x)[0], ref)
    np.testing.assert_array_equal(RemoteModel(jax_srv.url)(x)[0], ref)
    assert_forward_close(RemoteModel(port_srv.url)(x)[0], ref)


def test_batch_bucketing_pads_and_slices(port_srv, monkeypatch):
    runner = port_srv.models["spec"]
    batches, inner = [], runner.backend.forward
    monkeypatch.setattr(runner.backend, "forward", lambda x: batches.append(x.shape[0]) or inner(x))
    x = _frames(3, 1)
    out = RemoteModel(port_srv.url)(x)[0]
    assert batches == [4] and out.shape[0] == 3
    assert_forward_close(out, AutoBackend(CKPT, device="cpu").forward(x).numpy(), px=1e-3, score=1e-5)


def test_json_tensor_path(port_srv):
    """A request and a reply in JSON data lists, as the base v2 protocol has them."""
    x = _frames(1, 2)
    code, doc = _post(f"http://127.0.0.1:{port_srv.port}/v2/models/spec/infer",
                      {"inputs": [{"name": "images", "shape": list(x.shape), "datatype": "UINT8",
                                   "data": x.reshape(-1).tolist()}]})
    out = doc["outputs"][0]
    assert code == 200 and out["datatype"] == "FP32" and out["shape"] == [1, 84, 6]
    np.testing.assert_array_equal(np.asarray(out["data"], np.float32).reshape(out["shape"]),
                                  RemoteModel(port_srv.url)(x)[0])


def test_bytes_ingest_equals_raw_on_the_decoded_pixels(port_srv):
    """PNG from the port's encoder and from cv2, JPEG from cv2 (the port's
    encode_images gives its bytes) in 3 and 1 channels: each equal to the raw
    tensor of the pixels cv2.imdecode gives."""
    cli = RemoteModel(port_srv.url)
    x, gray = _frames(2, 3), _frames(2, 4, c=1)
    raw = cli(x)[0]
    np.testing.assert_array_equal(cli(encode_images(x, fmt=".png"))[0], raw)
    np.testing.assert_array_equal(cli([cv2.imencode(".png", im)[1].tobytes() for im in x])[0], raw)
    for batch in (x, gray):
        blobs = [cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes() for im in batch]
        assert encode_images(batch) == blobs == jax_encode_images(batch)  # .jpg at quality 90 by default, as JAX's
        decoded = np.stack([cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_UNCHANGED) for b in blobs])
        decoded = decoded.reshape(batch.shape)  # gray decodes (H, W): its channel axis back
        assert not np.array_equal(decoded, batch)  # lossy: the server must see the decoded pixels
        np.testing.assert_array_equal(cli(blobs)[0], cli(decoded)[0])


def test_gray_upload_equals_three_channel_repeat(port_srv):
    cli = RemoteModel(port_srv.url)
    g = _frames(2, 5, c=1)
    np.testing.assert_array_equal(cli(g)[0], cli(np.repeat(g, 3, -1))[0])


def test_bad_bytes_payloads_get_400_and_the_server_goes_on(port_srv, jax_srv):
    """A BYTES element that runs past its tensor, a count other than the
    shape's, a partial length field, binary data past the body: 400 each;
    then a good request is served. JAX's server answers the miscount and the
    partial field with 200 and fewer rows than declared (ROADMAP.md §3.8)."""
    url = f"http://127.0.0.1:{port_srv.port}/v2/models/spec/infer"
    pngs = encode_images(_frames(3, 6), fmt=".png")
    blob = b"".join(len(b).to_bytes(4, "little") + b for b in pngs)

    def head(shape, size):
        return {"inputs": [{"name": "images", "shape": shape, "datatype": "BYTES",
                            "parameters": {"binary_data_size": size}}]}

    for shape, payload, size in (([3], blob[:-10], len(blob) - 10),  # the last element cut short
                                 ([4], blob, len(blob)),  # 3 elements, shape says 4
                                 ([3], blob + b"\x07\x00", len(blob) + 2),  # a partial length field at the end
                                 ([3], blob, len(blob) + 100)):  # binary_data_size past the body
        code, doc = _post(url, head(shape, size), payload)
        assert code == 400 and "ValueError" in doc["error"], (shape, size, doc)
    out = RemoteModel(port_srv.url)(pngs)[0]
    assert out.shape == (3, 84, 6)
    jurl = f"http://127.0.0.1:{jax_srv.port}/v2/models/spec/infer"
    for shape, payload in (([4], blob), ([3], blob + b"\x07\x00")):
        code, doc = _post(jurl, head(shape, len(payload)), payload)
        assert code == 200 and doc["outputs"][0]["shape"] == [3, 84, 6]


def test_a_failed_dispatch_reaches_each_request_of_its_group(port_srv, monkeypatch):
    """A forward that raises on a group's batch: every request of that group
    gets a 400; the request dispatched before and the one after are served."""
    runner = port_srv.models["spec"]
    inner, first = runner.backend.forward, threading.Event()

    def slow_or_failing(x):
        if not first.is_set():  # hold the first dispatch until the other three requests have queued
            first.set()
            deadline = time.monotonic() + 30
            while runner._q.qsize() < 3 and time.monotonic() < deadline:
                time.sleep(0.01)
        if bool((x == 7).all(-1).all(-1).all(-1).any()):
            raise RuntimeError("poisoned frame")
        return inner(x)

    monkeypatch.setattr(runner.backend, "forward", slow_or_failing)
    cli = RemoteModel(port_srv.url)
    inputs = [_frames(1, 7)] + [np.full((1, S, S, 3), v, np.uint8) for v in (1, 7, 2)]
    codes = [None] * 4

    def req(i):
        try:
            cli(inputs[i])
            codes[i] = 200
        except urllib.error.HTTPError as e:
            codes[i] = e.code

    threads = [threading.Thread(target=req, args=(i,)) for i in range(4)]
    threads[0].start()
    assert first.wait(30)  # the first request dispatches alone; the rest queue behind its forward
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert codes == [200, 400, 400, 400], codes
    assert cli(inputs[0])[0].shape == (1, 84, 6)


def test_dynamic_batching_aggregates_concurrent_requests():
    runner = _ModelRunner(CKPT, name="dyn", device="cpu")
    try:
        calls, inner = [], runner.backend.forward

        def slow_forward(x):
            calls.append(x.shape[0])
            time.sleep(0.2)
            return inner(x)

        runner.backend.forward = slow_forward
        xs = [_frames(1, 10 + i) for i in range(6)]
        alone = [runner._run_batch(x) for x in xs]
        calls.clear()
        got = [None] * 6
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(i, runner.infer([xs[i]]))) for i in range(6)]
        for t in threads:
            t.start()
            time.sleep(0.01)
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(calls) < 6 and sum(calls) >= 6, calls
        for g, a in zip(got, alone):
            assert_forward_close(g[0], a[0], px=1e-3, score=1e-5)
    finally:
        runner.close()
    assert runner._dispatcher is None
    with pytest.raises(RuntimeError, match="closed"):
        runner.infer([xs[0]])


def test_remote_predict_matches_local_predict(port_srv):
    """The client flips BGR -> RGB on the host and the server does not; local
    predict flips on the device. conf=0 keeps max_det rows whatever their
    scores, so a channel swap on a colour image shows."""
    img = np.random.default_rng(2).integers(0, 255, (96, 128, 3), np.uint8)
    gray = np.repeat(np.random.default_rng(3).integers(0, 255, (80, 64, 1), np.uint8), 3, -1)
    kw = dict(imgsz=S, conf=0.0, max_det=8, save=False)
    remote_yolo = YOLO(port_srv.url, device="cpu")
    assert remote_yolo.names == {0: "LTE", 1: "RF"} and remote_yolo.stride == (8.0, 16.0, 32.0)
    assert remote_yolo.device == "cpu" and remote_yolo.model is None
    for src, batch in ((img, 1), ([img, gray], 2)):
        local = YOLO(CKPT, device="cpu").predict(src, batch=batch, **kw)
        remote = remote_yolo.predict(src, batch=batch, **kw)
        assert len(local) == len(remote)
        for r, lo in zip(remote, local):
            assert len(r) == len(lo) == 8
            np.testing.assert_array_equal(r.boxes.cls, lo.boxes.cls)
            np.testing.assert_allclose(r.boxes.xyxy, lo.boxes.xyxy, atol=1e-3, rtol=0)
    swapped = remote_yolo.predict(img[..., ::-1].copy(), **kw)[0].boxes.data
    assert np.abs(swapped - local[0].boxes.data).max() > 1e-2  # the check would see a missing or a double flip


def test_remote_val_matches_local_val(port_srv, tmp_path):
    # a copy of the fixture split: the dataset writes its label cache beside the images
    shutil.copytree(JPEG_SPLIT["path"], tmp_path / "split")
    split = {**JPEG_SPLIT, "path": str(tmp_path / "split")}
    remote = YOLO(port_srv.url, device="cpu").val(data=split, batch=4, imgsz=320, plots=False)
    local = YOLO(CKPT, device="cpu").val(data=split, batch=4, imgsz=320, plots=False)
    assert list(remote) == list(local) and local["metrics/mAP50(B)"] > 0.5
    assert all(abs(remote[k] - local[k]) <= 1e-6 for k in local), (remote, local)


def test_served_models_are_inference_only(port_srv):
    with pytest.raises(ValueError, match="inference-only"):
        YOLO(port_srv.url, device="cpu").train(data=JPEG_SPLIT, epochs=1)


def test_entrypoint_serve_verb():
    srv = entrypoint(f"yolo serve model={CKPT} port=0 block=False device=cpu")
    try:
        assert _get(f"http://127.0.0.1:{srv.port}/v2/health/live") == {}
        assert RemoteModel(srv.url)(_frames(1, 0))[0].shape == (1, 84, 6)
    finally:
        srv.shutdown()
    # train, val and predict run now (tests/test_torch_cfg.py, tests/test_torch_scratch.py); these still raise
    for line in (f"yolo track model={CKPT}", f"yolo benchmark model={CKPT}", "yolo settings"):
        with pytest.raises(NotImplementedError, match="item 12"):
            entrypoint(line)
    with pytest.raises(SyntaxError, match="key=value"):
        entrypoint(f"yolo serve train model={CKPT}")


def test_wire_encoding(port_srv, monkeypatch):
    """SYT_WIRE_ENCODE=png predicts as the raw wire; =jpg[:q] sends the bytes
    JAX's encode_images gives for the same frames (quality 90 unless given)
    and is answered; a batch that is not uint8 channels-last goes raw, with
    a warning."""
    img = np.random.default_rng(8).integers(0, 255, (96, 128, 3), np.uint8)
    kw = dict(imgsz=S, conf=0.0, max_det=8, save=False)
    raw = YOLO(port_srv.url, device="cpu").predict(img, **kw)[0].boxes.data
    monkeypatch.setenv("SYT_WIRE_ENCODE", "png")
    np.testing.assert_array_equal(YOLO(port_srv.url, device="cpu").predict(img, **kw)[0].boxes.data, raw)
    chw = np.ascontiguousarray(_frames(1, 9).transpose(0, 3, 1, 2))
    with pytest.warns(UserWarning, match="sending it raw"), pytest.raises(urllib.error.HTTPError) as e:
        AutoBackend(port_srv.url).forward(chw)
    assert e.value.code == 400
    # JAX's client encodes whatever it gets (ROADMAP.md §3.9): a float batch in [0, 1] as 8-bit images of 0s and
    # 1s, answered without an error; a CHW batch fails in cv2
    jax_backend = JaxAutoBackend(port_srv.url)
    assert np.asarray(jax_backend.forward(_frames(1, 9).astype(np.float32) / 255)).shape == (1, 84, 6)
    with pytest.raises(cv2.error):
        jax_backend.forward(chw)
    sent = []
    real = serve_module.encode_images
    monkeypatch.setattr(serve_module, "encode_images", lambda a, **k: sent.append((a.copy(), k)) or real(a, **k))
    for wire, fmt, q in (("jpg", ".jpg", 90), ("jpg:75", ".jpg", 75), ("jpeg:30", ".jpeg", 30)):
        monkeypatch.setenv("SYT_WIRE_ENCODE", wire)
        got = YOLO(port_srv.url, device="cpu").predict(img, **kw)[0].boxes.data
        frames, k = sent[-1]
        assert k == {"fmt": fmt, "quality": q} and frames.shape == (1, S, S, 3)
        assert real(frames, **k) == jax_encode_images(frames, fmt=fmt, quality=q)
        assert got.shape == raw.shape and np.isfinite(got).all()


def test_half_server_answers_fp32_within_bf16_tolerance(jax_srv):
    x = _frames(1, 11)
    srv = InferenceServer({"half": CKPT}, port=0, device="cpu", half=True).start()
    try:
        cli = RemoteModel(srv.url)
        got = cli(x)[0]
        assert _get(cli.base)["outputs"][0]["datatype"] == "FP32"
    finally:
        srv.shutdown()
    assert srv.models["half"].backend.model.dtype == torch.bfloat16 and got.dtype == np.float32
    ref_f32 = np.asarray(jax_srv.models["spec"].backend.forward(x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        jax_half = JaxAutoBackend(CKPT, half=True)
    ref_bf16 = np.asarray(jax_half.forward(x))
    for part in (np.s_[..., :4], np.s_[..., 4:]):
        d_jax = float(np.abs(ref_bf16[part] - ref_f32[part]).max())
        d_port = float(np.abs(got[part] - ref_bf16[part]).max())
        assert 0 < d_jax and d_port <= 2 * d_jax, (d_port, d_jax)


def test_data_parallel_on_one_device_warns_and_serves(port_srv):
    x = _frames(2, 12)
    with pytest.warns(UserWarning, match="one device is visible"):
        srv = InferenceServer({"dp": CKPT}, port=0, device="cpu", data_parallel=True).start()
    try:
        np.testing.assert_array_equal(RemoteModel(srv.url)(x)[0], RemoteModel(port_srv.url)(x)[0])
    finally:
        srv.shutdown()


def test_client_without_a_card_raises_for_the_default_device(port_srv, monkeypatch):
    """The client's NMS runs on its device, the card by default: without one,
    predict and val raise unless device="cpu"; the server needs one too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frame = np.zeros((32, 32, 3), np.uint8)
    yolo = YOLO(port_srv.url)
    assert yolo.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        yolo.predict(frame, imgsz=S, save=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        yolo.val(data=JPEG_SPLIT, imgsz=S)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve(CKPT, port=0, block=False)
    assert len(yolo.predict(frame, imgsz=S, device="cpu", save=False)) == 1


def test_launch_counts_survive_concurrent_launchers():
    """kernels.count from more threads than cores, with the interpreter
    switching threads as often as it can: no launch is lost."""
    def wrapper():
        pass

    wrapper.launches = 0
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels.count(wrapper) for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 2000


def test_inference_fn_with_nms_is_the_port_nms_of_its_predictions():
    backend = AutoBackend(CKPT, device="cpu")
    assert backend.warmup((1, S, S, 3)) is backend
    x = torch.from_numpy(_frames(2, 13))
    preds = build_inference_fn(backend.model)(x)
    out, n = build_inference_fn(backend.model, nms=True, conf=0.01)(x)
    ref_out, ref_n = non_max_suppression(preds, conf_thres=0.01, iou_thres=0.7, nc=2, max_det=300)
    assert out.shape == (2, 300, 6) and int(n.sum()) > 0
    assert torch.equal(out, ref_out) and torch.equal(n, ref_n)


@pytest.mark.parametrize("source,item", [("yolo11n-seg.yaml", "item 10"), ("best.pt", "item 11"), ("best.onnx", "item 9"),
                                         ("best.tflite", "item 9"), ("best.stablehlo", "item 9")])
def test_sources_not_ported_raise(source, item):
    if source == "yolo11n-seg.yaml":  # item 10's serving of the other tasks is done: the segment graph is served
        backend = AutoBackend(source, device="cpu")
        assert backend.task == "segment" and len(backend.forward(np.zeros((1, S, S, 3), np.uint8))) == 2
        return
    if item == "item 9":  # the artifact kinds load now (tests/test_torch_export.py): a missing one, or a
        # .stablehlo without its sidecar .ckpt, raises FileNotFoundError
        with pytest.raises(FileNotFoundError, match="best"):
            AutoBackend(source, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=item):
        AutoBackend(source, device="cpu")


def test_a_served_model_is_not_served_again(port_srv):
    with pytest.raises(NotImplementedError, match="item 9"):
        InferenceServer({"proxy": AutoBackend(port_srv.url)}, port=0)


def _burst_latencies(server_cls, clients: int = 64, bursts: int = 3) -> list:
    """Seconds per request of `bursts` bursts of `clients` connections released together."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def do_GET(self):
            time.sleep(0.002)
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

    srv = server_cls(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    lat, lock = [], threading.Lock()
    try:
        for _ in range(bursts):
            barrier = threading.Barrier(clients)

            def get():
                barrier.wait()
                t0 = time.perf_counter()
                with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/", timeout=60) as r:
                    r.read()
                with lock:
                    lat.append(time.perf_counter() - t0)

            threads = [threading.Thread(target=get) for _ in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        srv.shutdown()
        srv.server_close()
    return lat


if __name__ == "__main__":  # the listen backlog under bursts of connections
    from http.server import ThreadingHTTPServer

    from spectrogram_yolov11_torch.serve import _HTTPServer

    for name, cls in (("backlog 5 (socketserver's default)", ThreadingHTTPServer),
                      (f"backlog {_HTTPServer.request_queue_size} (the port's)", _HTTPServer)):
        lat = _burst_latencies(cls)
        print(f"{name}: {sum(x >= 1.0 for x in lat)} of {len(lat)} requests took 1 s or more, "
              f"the longest {max(lat):.3f} s", flush=True)
