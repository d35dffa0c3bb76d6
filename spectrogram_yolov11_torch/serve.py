"""KServe-v2 HTTP inference serving on the card: the model server and the remote-model client.

Counterpart of spectrogram_yolov11_tpu/serve.py. The server runs the serving
graph of engine/exporter.py:build_inference_fn (uint8 RGB frames -> decoded
predictions, no NMS) behind the KServe v2 predict protocol (JSON tensors and
the binary-tensor extension) on a stdlib ThreadingHTTPServer, and
`YOLO("http://host:8000/name")` predicts and validates through it
(nn/autobackend.py, kind "remote"; the NMS runs on the client's device).

    serve("runs_artifacts/spectrogram_yolo11n.ckpt", port=8000)    # on the card
    serve({"spec": ckpt}, port=0, block=False, device="cpu", half=False)

- Each request's batch is padded with zero frames to the next power of two
  before its dispatch and the outputs are cut back: the card sees a handful
  of batch shapes, whatever the clients send.
- Continuous dynamic batching: requests that arrive while a dispatch runs
  queue up, and the dispatcher thread runs the queued requests of one frame
  shape as one concatenated dispatch (dynamic_batch=False runs each request
  in its handler thread, one at a time behind a lock). An exception in a
  dispatch reaches every request of its group as an HTTP 400, and the server
  goes on serving.
- Ingest: a raw UINT8 (N, H, W, 3) tensor; a gray (N, H, W, 1) one, uploaded
  as one channel and broadcast to three on the card; or BYTES, one JPEG or
  PNG per frame, decoded on the host as cv2.imdecode(IMREAD_UNCHANGED) does
  (data/imageio.py:imdecode). A BYTES payload whose elements run past its
  size, or whose count differs from its shape, gets a 400.
- The server answers FP32 whatever the network's dtype: half=True runs its
  bf16 copy, whose decoded predictions are f32.
- One card per server: data_parallel or model_parallel > 1 with one device
  visible warns and serves on it; with two cards or more it raises
  (ROADMAP.md §1 item 12).

A launching thread keeps its own set-up: each dispatch runs under
torch.inference_mode and the server's device (both are per thread), and the
network's forward holds the f32 policy itself (utils.full_f32).
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import queue
import threading
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional, Union
from urllib.parse import urlsplit

import numpy as np
import torch

from .data.imageio import imdecode, imencode_png
from .engine.predictor import BasePredictor
from .nn.autobackend import AutoBackend
from .ops.nms import non_max_suppression
from .utils import not_ported

LOGGER = logging.getLogger(__name__)

# KServe v2 datatype names <-> numpy (the v2 protocol's "Tensor Data Types")
_DT2NP = {
    "BOOL": np.bool_, "UINT8": np.uint8, "UINT16": np.uint16, "UINT32": np.uint32,
    "UINT64": np.uint64, "INT8": np.int8, "INT16": np.int16, "INT32": np.int32,
    "INT64": np.int64, "FP16": np.float16, "FP32": np.float32, "FP64": np.float64,
}
_NP2DT = {np.dtype(v): k for k, v in _DT2NP.items()}


def _np_datatype(arr: np.ndarray) -> str:
    try:
        return _NP2DT[arr.dtype]
    except KeyError:
        raise ValueError(f"dtype {arr.dtype} has no KServe v2 datatype") from None


def encode_images(imgs: np.ndarray, fmt: str = ".png") -> List[bytes]:
    """A (N, H, W, C) uint8 batch as one encoded image per frame, for the BYTES
    wire format: ".png" (lossless, data/imageio.py:imencode_png). ".jpg" raises:
    the port has no JPEG encoder."""
    if fmt in (".jpg", ".jpeg"):
        raise not_ported("JPEG encoder", "item 5 (image encode)")
    if fmt != ".png":
        raise ValueError(f"encode_images: unsupported format {fmt!r} (.png)")
    return [imencode_png(im) for im in np.asarray(imgs)]


def _decode_images(blobs: List[bytes]) -> np.ndarray:
    """One encoded image per frame -> (N, H, W, C) uint8 (the server side of
    the BYTES ingest). Gray frames come back (H, W) and get a channel axis;
    all frames of a request must decode to one shape."""
    ims = []
    for b in blobs:
        im = imdecode(b)
        ims.append(im[..., None] if im.ndim == 2 else im)
    if len({im.shape for im in ims}) > 1:
        raise ValueError(f"the request's images decode to different shapes {sorted({im.shape for im in ims})}")
    return np.stack(ims)


class _BatchItem:
    """One queued request: its frames, result slot, and completion event."""

    __slots__ = ("imgs", "out", "err", "done")

    def __init__(self, imgs: np.ndarray):
        self.imgs, self.out, self.err = imgs, None, None
        self.done = threading.Event()


def _bucket(n: int) -> int:
    """The next power of two: the batch a dispatch of n frames runs at."""
    b = 1
    while b < n:
        b *= 2
    return b


class _ModelRunner:
    """One served checkpoint: its AutoBackend on the server's device, batch
    bucketing, and the dynamic-batching dispatcher thread."""

    def __init__(self, source, name: Optional[str] = None, data_parallel: bool = False, half: bool = False,
                 model_parallel: int = 1, dynamic_batch: bool = True, max_batch: int = 256,
                 device: str | torch.device = "cuda"):
        self.backend = source if isinstance(source, AutoBackend) else AutoBackend(str(source), half=half, device=device)
        if self.backend.kind != "ckpt":
            raise not_ported(f"serving the {self.backend.kind} source {self.backend.weights!r}",
                             "item 9 (the Exporter and the artifact kinds)")
        self.device = self.backend.device
        if data_parallel or model_parallel > 1:
            n_dev = torch.cuda.device_count() if self.device.type == "cuda" else 1
            if n_dev > 1:
                raise not_ported(f"serving over {n_dev} cards (data_parallel={data_parallel}, "
                                 f"model_parallel={model_parallel})", "item 12 (data parallelism)")
            warnings.warn(f"serve: data_parallel={data_parallel}, model_parallel={model_parallel} requested but one "
                          f"device is visible ({self.device}); serving single-device")
        self.name = name or Path(self.backend.weights).stem or "model"
        self.lock = threading.Lock()
        self._out_specs: Optional[List[dict]] = None
        self.max_batch = int(max_batch)
        self._dyn = bool(dynamic_batch)
        self._q: "queue.Queue[Optional[_BatchItem]]" = queue.Queue()
        self._dispatcher: Optional[threading.Thread] = None
        if self._dyn:
            self._dispatcher = threading.Thread(target=self._dispatch_loop, name=f"serve-{self.name}", daemon=True)
            self._dispatcher.start()

    def metadata(self, probe_imgsz: int = 64) -> dict:
        """The KServe v2 model-metadata document. The output specs come from
        one forward at probe_imgsz on the first call (-1 for the batch and
        anchor dimensions, which follow the input)."""
        if self._out_specs is None:
            out = self.infer([np.zeros((1, probe_imgsz, probe_imgsz, 3), np.uint8)])
            specs = [{"name": f"output{i}", "datatype": _np_datatype(a), "shape": list(a.shape)}
                     for i, a in enumerate(out)]
            for s in specs:
                s["shape"] = [-1] + [-1 if d > 4 else d for d in s["shape"][1:]]
            self._out_specs = specs
        b = self.backend
        meta = {
            "task": b.task,
            "names": {int(k): str(v) for k, v in b.names.items()},
            "stride": [float(s) for s in np.asarray(b.stride).tolist()],
            "nc": len(b.names) or None,
        }
        return {
            "name": self.name,
            "versions": ["1"],
            "platform": "pytorch",
            "inputs": [{"name": "images", "datatype": "UINT8", "shape": [-1, -1, -1, 3]}],
            "outputs": self._out_specs,
            "parameters": {"metadata": json.dumps(meta)},
        }

    def _prep(self, inputs: List) -> np.ndarray:
        """Request inputs -> (N, H, W, 1|3) uint8 frames (BYTES decoded)."""
        imgs = inputs[0]
        if isinstance(imgs, (list, tuple)):
            imgs = _decode_images(list(imgs))
        if imgs.dtype != np.uint8 or imgs.ndim != 4 or imgs.shape[-1] not in (1, 3):
            raise ValueError(f"expected uint8 frames (N, H, W, 1|3), got {imgs.dtype} {imgs.shape}")
        return imgs

    def _run_batch(self, imgs: np.ndarray) -> List[np.ndarray]:
        """One device dispatch: pad to a power-of-two bucket, upload (a gray
        batch as one channel, broadcast on the device), forward, copy back
        the real rows."""
        n = imgs.shape[0]
        nb = _bucket(n)
        if nb != n:
            imgs = np.concatenate([imgs, np.zeros((nb - n,) + imgs.shape[1:], imgs.dtype)], axis=0)
        on_card = torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()
        with self.lock, on_card, torch.inference_mode():
            x = torch.from_numpy(imgs).to(self.device)
            out = self.backend.forward(x.expand(-1, -1, -1, 3))
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            return [o[:n].cpu().numpy() for o in outs]

    def infer(self, inputs: List) -> List[np.ndarray]:
        imgs = self._prep(inputs)
        if not self._dyn:
            return self._run_batch(imgs)
        if self._dispatcher is None:
            raise RuntimeError(f"model {self.name!r} is closed")
        item = _BatchItem(imgs)
        self._q.put(item)
        item.done.wait()
        if item.err is not None:
            raise item.err
        return item.out

    def _dispatch_loop(self):
        """Continuous batching: block for one request, then take everything
        that queued while the previous dispatch ran, group it by frame shape,
        and run each group as one concatenated dispatch. None stops the loop."""
        while True:
            first = self._q.get()
            if first is None:
                return
            items, n, stop = [first], first.imgs.shape[0], False
            while n < self.max_batch:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                items.append(nxt)
                n += nxt.imgs.shape[0]
            groups: Dict[tuple, List[_BatchItem]] = {}
            for it in items:
                groups.setdefault(it.imgs.shape[1:], []).append(it)
            for group in groups.values():
                try:
                    batch = group[0].imgs if len(group) == 1 else np.concatenate([it.imgs for it in group], axis=0)
                    outs = self._run_batch(batch)
                    off = 0
                    for it in group:
                        ni = it.imgs.shape[0]
                        it.out = [o[off : off + ni] for o in outs]
                        off += ni
                except Exception as e:  # reaches each request of the group as a 400; the loop keeps serving
                    for it in group:
                        it.err = e
                finally:
                    for it in group:
                        it.done.set()
            if stop:
                return

    def close(self, timeout: float = 30.0) -> None:
        """Stop the dispatcher thread after the requests queued before this call."""
        if self._dispatcher is not None:
            self._q.put(None)
            self._dispatcher.join(timeout)
            self._dispatcher = None


def _parse_infer_request(headers, body: bytearray):
    """A KServe v2 infer request (JSON, with binary tensors after its header)
    -> (document, input arrays, whether the reply is binary). Binary tensors
    are views of `body`; a BYTES tensor is a list of its elements. A tensor
    past the body's end, a BYTES element past its tensor's size, or a BYTES
    count other than its shape's raises ValueError."""
    jlen = headers.get("Inference-Header-Content-Length")
    view = memoryview(body)
    if jlen is not None:
        jlen = int(jlen)
        doc, raw = json.loads(bytes(view[:jlen])), view[jlen:]
    else:
        doc, raw = json.loads(bytes(view)), view[:0]
    arrays, off = [], 0
    for spec in doc.get("inputs", []):
        shape = [int(d) for d in spec["shape"]]
        bsize = (spec.get("parameters") or {}).get("binary_data_size")
        if bsize is not None:
            bsize = int(bsize)
            if bsize < 0 or off + bsize > len(raw):
                raise ValueError(f"input {spec.get('name')!r}: {bsize} binary bytes at offset {off}, "
                                 f"but the body holds {len(raw)}")
        if spec["datatype"] == "BYTES":
            # the binary layout of BYTES: per element a 4-byte little-endian length, then the bytes
            if bsize is None:
                raise ValueError("BYTES inputs require the binary tensor extension")
            blob, items, p = raw[off : off + bsize], [], 0
            while p < bsize:
                ln = int.from_bytes(blob[p : p + 4], "little") if p + 4 <= bsize else -1
                if ln < 0 or p + 4 + ln > bsize:
                    raise ValueError(f"input {spec.get('name')!r}: BYTES element {len(items)} runs past the "
                                     f"tensor's {bsize} bytes")
                items.append(bytes(blob[p + 4 : p + 4 + ln]))
                p += 4 + ln
            if len(items) != math.prod(shape):
                raise ValueError(f"input {spec.get('name')!r}: shape {shape} but {len(items)} BYTES elements")
            off += bsize
            arrays.append(items)
            continue
        dt = _DT2NP[spec["datatype"]]
        if bsize is not None:
            a = np.frombuffer(raw[off : off + bsize], dtype=dt).reshape(shape)
            off += bsize
        else:
            a = np.asarray(spec["data"], dtype=dt).reshape(shape)
        arrays.append(a)
    wants_binary = any((o.get("parameters") or {}).get("binary_data") for o in doc.get("outputs", [])) or bool(jlen)
    return doc, arrays, wants_binary


def _encode_infer_response(model_name: str, arrays: List[np.ndarray], binary: bool):
    outs, blobs = [], []
    for i, a in enumerate(arrays):
        spec = {"name": f"output{i}", "datatype": _np_datatype(a), "shape": list(a.shape)}
        if binary:
            blob = np.ascontiguousarray(a).tobytes()
            spec["parameters"] = {"binary_data_size": len(blob)}
            blobs.append(blob)
        else:
            spec["data"] = a.reshape(-1).tolist()
        outs.append(spec)
    head = json.dumps({"model_name": model_name, "outputs": outs}).encode()
    return head, b"".join(blobs) if binary else b""


def _read_body(rfile, n: int) -> bytearray:
    """n bytes of a request body into a writable buffer (so the binary tensors
    parsed from it are writable views, uploaded without a copy)."""
    body = bytearray(n)
    view, got = memoryview(body), 0
    while got < n:
        k = rfile.readinto(view[got:])
        if not k:
            raise ValueError(f"request body ended after {got} of {n} bytes")
        got += k
    return body


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's 5 drops the connections of a burst of
    # concurrent clients beyond it, and each dropped one waits a second for the
    # client's SYN to be sent again
    request_queue_size = 128


class InferenceServer:
    """Serve one or more checkpoints over the KServe v2 HTTP protocol.

    >>> srv = InferenceServer({"spec": "runs_artifacts/spectrogram_yolo11n.ckpt"}, port=0).start()
    >>> YOLO(srv.url).predict(frames)
    >>> srv.shutdown()
    """

    def __init__(self, models: Union[str, Path, Dict[str, object]], host: str = "127.0.0.1", port: int = 8000,
                 data_parallel: bool = False, half: bool = False, model_parallel: int = 1,
                 dynamic_batch: bool = True, max_batch: int = 256, device: str | torch.device = "cuda"):
        if not isinstance(models, dict):
            models = {None: models}
        self.models: Dict[str, _ModelRunner] = {}
        try:
            for name, src in models.items():
                r = _ModelRunner(src, name=name, data_parallel=data_parallel, half=half, model_parallel=model_parallel,
                                 dynamic_batch=dynamic_batch, max_batch=max_batch, device=device)
                self.models[r.name] = r
        except BaseException:
            for r in self.models.values():
                r.close()
            raise
        self.host, self.port = host, int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # no line per request on stderr
                pass

            def _send(self, code: int, head: bytes, blob: bytes = b""):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                if blob:
                    self.send_header("Inference-Header-Content-Length", str(len(head)))
                self.send_header("Content-Length", str(len(head) + len(blob)))
                self.end_headers()
                self.wfile.write(head + blob)

            def _error(self, code: int, msg: str):
                self._send(code, json.dumps({"error": msg}).encode())

            def _model(self, parts):
                runner = server.models.get(parts[2] if len(parts) > 2 else "")
                if runner is None and len(server.models) == 1:
                    runner = next(iter(server.models.values()))
                return runner

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                if self.path in ("/v2/health/live", "/v2/health/ready"):
                    return self._send(200, b"{}")
                if self.path == "/v2":
                    return self._send(200, json.dumps({"name": "spectrogram_yolov11_torch",
                                                       "extensions": ["binary_tensor_data"]}).encode())
                if len(parts) >= 2 and parts[0] == "v2" and parts[1] == "models":
                    runner = self._model(parts)
                    if runner is None:
                        return self._error(404, f"unknown model {self.path}")
                    if parts[-1] == "ready":
                        return self._send(200, b"{}")
                    try:
                        return self._send(200, json.dumps(runner.metadata()).encode())
                    except Exception as e:  # the probe forward failed: report it, keep serving
                        return self._error(500, repr(e))
                return self._error(404, f"no route {self.path}")

            def do_POST(self):
                parts = self.path.strip("/").split("/")
                if not (parts and parts[0] == "v2" and parts[-1] == "infer"):
                    return self._error(404, f"no route {self.path}")
                runner = self._model(parts)
                if runner is None:
                    return self._error(404, f"unknown model {self.path}")
                try:
                    body = _read_body(self.rfile, int(self.headers.get("Content-Length", 0)))
                    _, arrays, binary = _parse_infer_request(self.headers, body)
                    head, blob = _encode_infer_response(runner.name, runner.infer(arrays), binary)
                except Exception as e:  # a bad request or a failed dispatch: a 400, and the server goes on
                    LOGGER.warning(f"serve: infer failed: {e!r}")
                    return self._error(400, repr(e))
                return self._send(200, head, blob)

        return Handler

    def start(self) -> "InferenceServer":
        """Bind and serve on a background thread; returns self (port=0 resolved)."""
        self._httpd = _HTTPServer((self.host, self.port), self._handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="serve-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.start()
        try:
            self._thread.join()
        except KeyboardInterrupt:
            self.shutdown()

    def shutdown(self):
        """Stop accepting requests, then stop each model's dispatcher."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for r in self.models.values():
            r.close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/{next(iter(self.models))}"


class RemoteModel:
    """KServe v2 HTTP client: parses http://<host:port>/<model>, reads the
    model's metadata, and __call__ sends numpy arrays (binary tensor
    extension; a list of bytes as a BYTES tensor) and returns numpy arrays."""

    def __init__(self, url: str, endpoint: str = "", scheme: str = ""):
        if not endpoint and not scheme:
            s = urlsplit(url)
            endpoint, scheme, url = s.path.strip("/").split("/")[0], s.scheme, s.netloc
        if scheme == "grpc":
            raise NotImplementedError("grpc scheme: use http (KServe v2 HTTP protocol)")
        self.url, self.endpoint = url, endpoint
        self.base = f"http://{url}/v2/models/{endpoint}"
        cfg = self._get_json(self.base)
        outs = sorted(cfg.get("outputs") or [], key=lambda x: x.get("name", ""))
        self.input_names = [x["name"] for x in cfg.get("inputs") or []] or ["images"]
        self.input_formats = [x["datatype"] for x in cfg.get("inputs") or []] or ["UINT8"]
        self.np_input_formats = [_DT2NP[f] for f in self.input_formats]
        self.output_names = [x["name"] for x in outs]
        md = (cfg.get("parameters") or {}).get("metadata")
        try:
            self.metadata = json.loads(md) if isinstance(md, str) else (md or {})
        except ValueError:
            self.metadata = {}

    def _get_json(self, url: str) -> dict:
        import urllib.request

        # the first metadata read runs the server's probe forward (kernel builds on a fresh card machine)
        with urllib.request.urlopen(url, timeout=600) as r:
            return json.loads(r.read())

    def __call__(self, *inputs) -> List[np.ndarray]:
        import urllib.request

        specs, blobs = [], []
        for i, a in enumerate(inputs):
            name = self.input_names[i] if i < len(self.input_names) else f"input{i}"
            if isinstance(a, (list, tuple)) and a and isinstance(a[0], (bytes, bytearray)):
                blob = b"".join(len(b).to_bytes(4, "little") + bytes(b) for b in a)
                specs.append({"name": name, "shape": [len(a)], "datatype": "BYTES",
                              "parameters": {"binary_data_size": len(blob)}})
                blobs.append(blob)
                continue
            x = np.asarray(a)
            if i < len(self.np_input_formats) and x.dtype != self.np_input_formats[i]:
                x = x.astype(self.np_input_formats[i])
            blob = np.ascontiguousarray(x).tobytes()
            specs.append({"name": name, "shape": list(x.shape), "datatype": _np_datatype(x),
                          "parameters": {"binary_data_size": len(blob)}})
            blobs.append(blob)
        outputs = [{"name": n, "parameters": {"binary_data": True}} for n in self.output_names]
        head = json.dumps({"inputs": specs, "outputs": outputs}).encode()
        req = urllib.request.Request(f"{self.base}/infer", data=head + b"".join(blobs), method="POST",
                                     headers={"Content-Type": "application/json",
                                              "Inference-Header-Content-Length": str(len(head))})
        with urllib.request.urlopen(req, timeout=600) as r:
            jlen = r.headers.get("Inference-Header-Content-Length")
            payload = r.read()
        if jlen is None:
            doc, raw = json.loads(payload), b""
        else:
            doc, raw = json.loads(payload[: int(jlen)]), payload[int(jlen):]
        if "error" in doc:
            raise RuntimeError(f"remote inference failed: {doc['error']}")
        outs, off = {}, 0
        for spec in doc["outputs"]:
            dt = _DT2NP[spec["datatype"]]
            shape = [int(d) for d in spec["shape"]]
            bsize = (spec.get("parameters") or {}).get("binary_data_size")
            if bsize is not None:
                outs[spec["name"]] = np.frombuffer(raw[off : off + int(bsize)], dtype=dt).reshape(shape)
                off += int(bsize)
            else:
                outs[spec["name"]] = np.asarray(spec["data"], dtype=dt).reshape(shape)
        return [outs[n] for n in (self.output_names or sorted(outs))]


def _remote_forward(backend):
    """The predictor hands BGR frames (on its device); the serving graph takes
    RGB with no flip on the server (engine/exporter.py), so the client flips on
    the host. A gray (1-channel) batch passes as it is (the flip is the
    identity) and the server broadcasts it to 3."""

    def fwd(imgs_u8):
        arr = imgs_u8.cpu().numpy() if torch.is_tensor(imgs_u8) else np.asarray(imgs_u8)
        return backend.forward(np.ascontiguousarray(arr[..., ::-1]))

    return fwd


class RemotePredictor(BasePredictor):
    """Detect predictions through a served model: the predictor's letterbox
    on the client's device, the frames flipped to RGB on the host and sent,
    the server's decoded predictions back, then the port's NMS on the
    client's device at predict's settings (best class per anchor,
    pre_nms_topk 1024 unless set). Other tasks raise."""

    def __init__(self, backend: AutoBackend, overrides: Optional[dict] = None):
        if backend.task != "detect":
            raise not_ported(f"remote predict for the {backend.task} task", "item 10 (other heads)")
        self.backend = backend
        names = dict(backend.names) or {i: f"{i}" for i in range(80)}
        super().__init__(None, overrides=overrides, names=names)
        self.nc = len(names)

    def _build_device_fn(self):
        a, fwd, dev, nc = self.args, _remote_forward(self.backend), self.device, self.nc
        classes = None if a.classes is None else [a.classes] if isinstance(a.classes, int) else list(a.classes)

        def fn(frames: torch.Tensor):
            out = fwd(frames)
            preds = torch.tensor(out[0] if isinstance(out, tuple) else out, device=dev)
            with torch.inference_mode():
                return non_max_suppression(preds, conf_thres=float(a.conf), iou_thres=float(a.iou), nc=nc,
                                           multi_label=False, agnostic=bool(a.agnostic_nms), max_det=int(a.max_det),
                                           pre_nms_topk=int(a.pre_nms_topk or 0) or 1024, classes=classes)

        return fn


def serve(models, host: str = "127.0.0.1", port: int = 8000, block: bool = True, data_parallel: bool = False,
          half: bool = False, model_parallel: int = 1, dynamic_batch: bool = True, max_batch: int = 256,
          device: str | torch.device = "cuda") -> InferenceServer:
    """Serve `models` (a checkpoint path, or {name: path}) on `device`, the
    card unless the caller passes "cpu" (raises without one). block=False
    returns the started server; `yolo serve` (cfg/__init__.py) calls this."""
    srv = InferenceServer(models, host=host, port=port, data_parallel=data_parallel, half=half,
                          model_parallel=model_parallel, dynamic_batch=dynamic_batch, max_batch=max_batch,
                          device=device)
    if block:
        srv.serve_forever()
    else:
        srv.start()
    return srv
