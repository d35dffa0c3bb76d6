"""YOLO(ckpt).predict on the port against the JAX package's, on the CPU at 96 px.

The same .npy IQ capture and the same lists of mixed-size uint8 arrays go
through `spectrogram_yolov11_torch.YOLO(ckpt).predict(..., device="cpu")` and
`spectrogram_yolov11_tpu.YOLO(ckpt).predict(..., save=False)`. The inputs are
picked so that no best-class score lies within 1e-4 of conf and no pair of
boxes that pass conf has an IoU within 1e-5 of iou; then the counts and
classes are equal, conf agrees to 1e-4 and the boxes to 1e-2 px of the
letterboxed frame (1e-2 / gain in original pixels). An IQ capture's frame
differs from the JAX loader's by a grey level at some pixels, so its end to
end comparison is looser (test_predict_capture_matches_jax). The JAX side
compiles twice per file: one predictor at the defaults, one at batch 2 with
classes and conf set.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_tpu import YOLO as JaxYOLO
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.data.augment import letterbox_batch
from spectrogram_yolov11_torch.data.loaders import load_inference_source
from spectrogram_yolov11_torch.data.synth import synth_frames, synth_iq
from spectrogram_yolov11_torch.ops.decode import decode_detections
from spectrogram_yolov11_torch.ops.iou import box_iou

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
IMGSZ = 96
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    return YOLO(CKPT, device="cpu"), JaxYOLO(str(CKPT))


def _margins_ok(model, frames, conf: float, score_margin: float, iou_margin: float, iou: float = 0.7) -> bool:
    """No class score within score_margin of conf, and no pair of boxes that
    could pass conf with an IoU within iou_margin of iou."""
    x = letterbox_batch(frames, IMGSZ, CPU)
    with torch.inference_mode():
        rgb = x.expand(-1, -1, -1, 3).flip(-1).float() / 255.0
        preds = decode_detections(model(rgb.permute(0, 3, 1, 2)), model.nc, model.stride)
    if (preds[..., 4:] - conf).abs().min() <= score_margin:
        return False
    for p in preds:
        p = p[p[:, 4:].max(-1).values > conf - score_margin]
        xyxy = torch.cat([p[:, :2] - p[:, 2:4] / 2, p[:, :2] + p[:, 2:4] / 2], -1)
        if len(p) and (box_iou(xyxy, xyxy) - iou).abs().min() <= iou_margin:
            return False
    return True


@pytest.fixture(scope="module")
def capture(models, tmp_path_factory):
    """A 640-frame IQ capture with a detection at 96 px. Its frame differs from
    the JAX loader's by 1 grey level at some pixels (the STFT's f32 rounding,
    tests/test_torch_stft.py), which moves scores by ~1e-3: so the margins
    here are 1e-2."""
    port, _ = models
    for seed in range(100):
        iq, _ = synth_iq(np.random.default_rng(seed), 256 + 128 * 639)
        path = tmp_path_factory.mktemp("iq") / f"capture{seed}.npy"
        np.save(path, iq)
        [(_, frame, _)] = list(load_inference_source(str(path), device="cpu"))
        if _margins_ok(port.model, [frame], 0.25, 1e-2, 1e-2) and len(port.predict(str(path), imgsz=IMGSZ)[0]):
            return str(path)
    raise AssertionError("no seed in 0..99 gives a capture with a detection and clear margins")


@pytest.fixture(scope="module")
def arrays(models):
    """Three uint8 BGR arrays of mixed sizes (two gray, one tinted), with
    detections and clear margins at both conf settings used below."""
    port, _ = models
    for seed in range(100):
        frames = [np.repeat(synth_frames(1, h, w, seed=seed * 3 + i)[0], 3, -1) for i, (h, w) in
                  enumerate([(360, 640), (720, 1280), (500, 333)])]
        frames[2] = (frames[2] * np.array([1.0, 0.9, 0.8])).astype(np.uint8)
        if all(_margins_ok(port.model, frames, c, 1e-4, 1e-5) for c in (0.25, 0.35)) and \
                sum(map(len, port.predict(frames, imgsz=IMGSZ))) >= 2:
            return frames
    raise AssertionError("no seed in 0..99 gives arrays with detections and clear margins")


def _assert_same(got, ref, conf_tol: float = 1e-4, px_tol: float = 1e-2):
    """Equal counts and classes; conf to conf_tol, boxes to px_tol of the letterboxed frame."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.path == r.path and g.orig_shape == r.orig_shape and g.names == r.names
        assert len(g) == len(r)
        np.testing.assert_array_equal(g.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(g.boxes.conf, r.boxes.conf, atol=conf_tol, rtol=0)
        gain = min(IMGSZ / g.orig_shape[0], IMGSZ / g.orig_shape[1])
        np.testing.assert_allclose(g.boxes.xyxy, r.boxes.xyxy, atol=px_tol / gain, rtol=0)
        gs, rs = g.summary(), r.summary()
        assert [sorted(d) for d in gs] == [sorted(d) for d in rs]
        assert [(d["name"], d["class"]) for d in gs] == [(d["name"], d["class"]) for d in rs]


def _txt_rows(result, path):
    result.save_txt(path, save_conf=True)
    return [[float(v) for v in line.split()] for line in Path(path).read_text().splitlines()]


def test_predict_capture_matches_jax(models, capture, tmp_path):
    """The capture end to end (frames within 1 grey level, so conf to 1e-3 and
    boxes to 5e-2 px), then the JAX loader's own frame through the port's
    predict at the tight tolerances."""
    port, jax_model = models
    got = port.predict(capture, imgsz=IMGSZ)
    ref = jax_model.predict(capture, imgsz=IMGSZ, save=False)
    assert len(got[0]) > 0
    _assert_same(got, ref, conf_tol=1e-3, px_tol=5e-2)
    diff = np.abs(got[0].orig_img.astype(np.int16) - ref[0].orig_img)
    assert got[0].orig_img.dtype == np.uint8 and got[0].orig_img.shape == (640, 640, 3) and diff.max() <= 1

    frame = ref[0].orig_img
    got, ref = port.predict(frame, imgsz=IMGSZ), jax_model.predict(frame, imgsz=IMGSZ, save=False)
    _assert_same(got, ref)
    rows, rows_ref = _txt_rows(got[0], tmp_path / "port.txt"), _txt_rows(ref[0], tmp_path / "jax.txt")
    assert len(rows) == len(got[0]) and [r[0] for r in rows] == [r[0] for r in rows_ref]
    np.testing.assert_allclose(np.array(rows)[:, 1:], np.array(rows_ref)[:, 1:], atol=1e-4, rtol=0)


@pytest.mark.parametrize("kw", [dict(batch=1), dict(batch=2, classes=[1], conf=0.35)], ids=["batch1", "batch2-classes-conf"])
def test_predict_arrays_match_jax(models, arrays, kw):
    """batch 2 over 3 arrays pads the last batch with a copy of its last frame."""
    port, jax_model = models
    extra = {} if kw["batch"] == 1 else kw  # batch 1 shares the JAX predictor of the capture test
    got = port.predict(arrays, imgsz=IMGSZ, **kw)
    ref = jax_model.predict(arrays, imgsz=IMGSZ, save=False, **extra)
    _assert_same(got, ref)
    assert [r.path for r in got] == ["image0", "image1", "image2"]
    if "classes" in kw:
        assert all(set(r.boxes.cls.tolist()) <= {1.0} and (r.boxes.conf > 0.35).all() for r in got)


def test_predict_batches_stream_and_callbacks(models, arrays, tmp_path):
    """Batch size does not change the results; stream=True yields them lazily;
    callbacks fire in stream_inference's order; save_txt writes one label file
    per image under project/name."""
    port, _ = models
    one = port.predict(arrays, imgsz=IMGSZ)
    events = []
    for e in ("on_predict_start", "on_predict_batch_start", "on_predict_postprocess_end", "on_predict_batch_end",
              "on_predict_end"):
        port.add_callback(e, lambda p, e=e: events.append(e))
    gen = port.predict(arrays, imgsz=IMGSZ, batch=2, stream=True, save_txt=True, project=str(tmp_path), name="run")
    assert not isinstance(gen, list)
    two = list(gen)
    port.reset_callbacks()
    batch_events = ["on_predict_batch_start", "on_predict_postprocess_end", "on_predict_batch_end"]
    assert events == ["on_predict_start"] + batch_events * 2 + ["on_predict_end"]
    _assert_same(two, one)  # the CPU convolutions round by batch size
    assert all(set(r.speed) == {"preprocess", "inference", "postprocess"} for r in two)
    assert not (tmp_path / "run").exists()  # stream=True leaves saving to the caller, as in the JAX predictor
    port.predict(arrays, imgsz=IMGSZ, save_txt=True, project=str(tmp_path), name="run")
    assert sorted(p.name for p in (tmp_path / "run" / "labels").iterdir()) == ["image0.txt", "image1.txt", "image2.txt"]


def test_predict_refuses_what_the_port_does_not_do(models, tmp_path):
    port, _ = models
    frame = np.zeros((32, 32, 3), np.uint8)
    # half=True runs the network in bf16 now (held to JAX's bf16 model in tests/test_torch_half.py)
    half = port.predict(frame, imgsz=IMGSZ, half=True)
    assert len(half) == 1 and half[0].boxes.data.dtype == np.float32 and port.model.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="save=True"):
        port.predict(frame, imgsz=IMGSZ, save=True)
    # image files, directories and globs run now (held to JAX's predictor in tests/test_torch_sources.py);
    # videos, streams and screens raise, and a missing file raises FileNotFoundError as in the JAX loader
    (tmp_path / "clip.mp4").write_bytes(b"")
    for source in (str(tmp_path / "clip.mp4"), str(tmp_path), "rtsp://camera/stream", 0, "screen 0"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port.predict(source, imgsz=IMGSZ)
    with pytest.raises(FileNotFoundError):
        port.predict(str(tmp_path / "frame.jpg"), imgsz=IMGSZ)
    with pytest.raises(SyntaxError, match="not a valid argument"):
        port.predict(frame, imgsz=IMGSZ, confidence=0.3)
    for model in ("yolo11n.yaml", "yolo11n.pt", "best.onnx"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            YOLO(model)
    # an http(s):// URL is a served model now (tests/test_torch_serve.py); grpc:// raises before any connection,
    # as the JAX client does
    with pytest.raises(NotImplementedError, match="grpc"):
        YOLO("grpc://127.0.0.1:8001/model")
    for mode in (port.track, port.export):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mode()
    # train runs now, at the default amp=True too (tests/test_torch_train_amp.py); without data it raises a
    # TypeError, as the JAX facade's dict(None) does
    with pytest.raises(TypeError, match="data="):
        port.train()
    # val runs now (held to JAX's validator in tests/test_torch_validator.py): without data it raises as the
    # JAX facade does; a split of JPEG images runs (held to JAX's in tests/test_torch_sources.py), and one of
    # BMP images raises, naming the ROADMAP item that ports the decoder
    jax_model = models[1]
    for model in (port, jax_model):
        with pytest.raises(TypeError):
            model.val()
    (tmp_path / "images" / "val").mkdir(parents=True)
    assert cv2.imwrite(str(tmp_path / "images" / "val" / "frame.jpg"), frame)
    res = port.val(data={"path": str(tmp_path), "val": "images/val", "names": ["LTE", "RF"]}, imgsz=IMGSZ)
    assert "metrics/mAP50-95(B)" in res and all(np.isfinite(v) for v in res.values())
    (tmp_path / "images" / "val" / "frame.jpg").unlink()
    assert cv2.imwrite(str(tmp_path / "images" / "val" / "frame.bmp"), frame)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.val(data={"path": str(tmp_path), "val": "images/val", "names": ["LTE", "RF"]}, imgsz=IMGSZ)
    assert port.names == {0: "LTE", 1: "RF"} and port.stride == (8.0, 16.0, 32.0) and port.device == "cpu"
