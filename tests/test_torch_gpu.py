"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `gpu` and decides inside itself whether a card is
present; without one it skips. The file imports torch and the port only (no
JAX), so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: the bottleneck 1e-4 abs/rel (3xTF32 on the tensor cores summed in
another order than cuDNN's f32); its bf16 form within max|ref| * 2^-7 (two
bf16 steps of the largest magnitude) with at most 1 % of elements unequal,
since a sum in another order flips the rounding of a few intermediates; the
keep mask and the pipeline's counts exactly; a whole network 1e-3 abs/rel, as
the CPU model tests; val on the card against val on the CPU, results_dict
within 1e-4 and the detections above a score margin equal. The tests leave
torch's TF32 settings as torch sets them (on for cuDNN): the port's forward and
plain bottleneck hold TF32 off themselves (utils.full_f32), and one test turns
TF32 on for cuDNN and matmul before it runs predict, and one before val.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from spectrogram_yolov11_torch.ops.fused_conv import (
    bottleneck_reference,
    bottleneck_reference_bf16,
    fused_bottleneck,
    fused_bottleneck_bf16,
    pack_bottleneck_weights,
    pack_bottleneck_weights_bf16,
)
from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep, greedy_keep_reference

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def assert_bf16_close(got: torch.Tensor, ref: torch.Tensor, max_unequal: float = 0.01) -> None:
    """The bf16 bottleneck's tolerance: every element within max|ref| * 2^-7
    of the reference, and at most `max_unequal` of the elements unequal."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    tol = float(ref.abs().max()) * 2.0**-7
    unequal = float((err > 0).double().mean())
    assert float(err.max()) <= tol, f"max abs err {float(err.max())} > {tol}"
    assert unequal <= max_unequal, f"{unequal:.4%} of elements unequal"


def nms_edge_case(name: str, b: int, k: int, seed: int = 0):
    """Score-sorted (b, k, 4) boxes with the 7680-px class offset and a (b, k)
    valid mask for the keep-mask edge cases; numpy f32 / bool."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 2, (b, k, 1)) * 7680.0
    if name == "no_overlap":  # disjoint 10-px boxes on a grid: every valid box kept
        i = np.arange(k)
        xy = np.stack([(i % 64) * 20.0, (i // 64) * 20.0], -1)[None].repeat(b, 0)
        boxes = np.concatenate([xy, xy + 10.0], -1) + cls
    elif name == "chain":  # IoU 0.79 with a neighbour, 0.61 two apart: A removes B, so C survives
        x0 = np.arange(k) * 1.2
        boxes = np.stack([x0, np.zeros(k), x0 + 10.0, np.full(k, 10.0)], -1)[None].repeat(b, 0)
    else:  # clustered boxes, many overlaps
        centers = rng.uniform(50, 600, (b, 16, 2))
        cxy = np.take_along_axis(centers, rng.integers(0, 16, (b, k))[..., None], 1) + rng.normal(0, 4, (b, k, 2))
        wh = rng.uniform(40, 60, (b, k, 2))
        boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1) + cls
    if name == "all_invalid":
        valid = np.zeros((b, k), bool)
    elif name in ("no_overlap", "chain"):
        valid = np.ones((b, k), bool)
    elif name == "prefix":
        valid = np.arange(k)[None] < rng.integers(0, k + 1, (b, 1))
    else:  # random holes: `valid` is not a prefix
        valid = rng.uniform(size=(b, k)) > 0.3
    return boxes.astype(np.float32), valid


NMS_CASES = ("all_invalid", "no_overlap", "chain", "prefix", "holes")


BOTTLENECK_SHAPES = [
    (32, 40, 40, 4), (32, 11, 13, 2), (32, 1, 1, 1), (32, 40, 40, 32),
    (64, 20, 20, 4), (64, 7, 9, 3), (64, 1, 1, 1), (64, 20, 20, 40),
    (128, 40, 40, 2), (128, 11, 13, 2), (128, 1, 1, 1), (128, 20, 20, 40),
]


@pytest.mark.gpu
@pytest.mark.parametrize("c,h,w,b", BOTTLENECK_SHAPES)
def test_fused_bottleneck_kernel(c, h, w, b):
    """Ragged tiles, 1x1, and batches whose tiles outnumber the resident CTAs
    (the persistent grid wraps), through the HWIO form and the fold pack."""
    dev = _card()
    rng = np.random.default_rng(c + h + w + b)
    x, w1, b1, w2, b2 = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.normal(0, 1, (b, h, w, c)), rng.normal(0, 0.05, (3, 3, c, c)), rng.normal(0, 0.1, c),
        rng.normal(0, 0.05, (3, 3, c, c)), rng.normal(0, 0.1, c))]
    ref = bottleneck_reference(x, w1, b1, w2, b2)
    n0 = fused_bottleneck.launches
    got_hwio = fused_bottleneck(x, w1, b1, w2, b2)
    got_pack = fused_bottleneck(x, pack_bottleneck_weights(w1), b1, pack_bottleneck_weights(w2), b2)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches == n0 + 2
    torch.testing.assert_close(got_hwio, ref, atol=1e-4, rtol=1e-4)
    assert torch.equal(got_pack, got_hwio)


@pytest.mark.gpu
@pytest.mark.parametrize("c,h,w,b", BOTTLENECK_SHAPES)
def test_fused_bottleneck_bf16_kernel(c, h, w, b):
    """The bf16 form on the same cases, through the dtype dispatch with HWIO
    weights and through its own wrapper with the fold's pack."""
    dev = _card()
    rng = np.random.default_rng(c + h + w + b)
    x = torch.from_numpy(rng.normal(0, 1, (b, h, w, c)).astype(np.float32)).to(dev, torch.bfloat16)
    w1, b1, w2, b2 = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.normal(0, 0.05, (3, 3, c, c)), rng.normal(0, 0.1, c), rng.normal(0, 0.05, (3, 3, c, c)), rng.normal(0, 0.1, c))]
    ref = bottleneck_reference_bf16(x, w1, b1, w2, b2)
    n0, f0 = fused_bottleneck_bf16.launches, fused_bottleneck.launches
    got_hwio = fused_bottleneck(x, w1, b1, w2, b2)
    got_pack = fused_bottleneck_bf16(x, pack_bottleneck_weights_bf16(w1), b1, pack_bottleneck_weights_bf16(w2), b2)
    torch.cuda.synchronize()
    assert (fused_bottleneck_bf16.launches, fused_bottleneck.launches) == (n0 + 2, f0)
    assert got_hwio.dtype == torch.bfloat16 and got_hwio.shape == x.shape
    assert_bf16_close(got_hwio, ref)
    assert torch.equal(got_pack, got_hwio)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 63, 64, 65, 512, 2048])
@pytest.mark.parametrize("case", NMS_CASES)
def test_greedy_keep_kernel(case, k):
    dev = _card()
    boxes, valid = nms_edge_case(case, 64, k, seed=k)
    bt, vt = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
    n0 = greedy_keep.launches
    got = greedy_keep(bt, vt, 0.7)
    torch.cuda.synchronize()
    assert greedy_keep.launches == n0 + 1
    ref = greedy_keep_reference(bt, vt, 0.7)
    assert torch.equal(got, ref)
    if case in ("all_invalid", "no_overlap"):
        assert torch.equal(got, vt)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 100, 512, 1024, 2048])
def test_greedy_keep_kernel_stress(k):
    dev = _card()
    rng = np.random.default_rng(k)
    b = 3
    cxy = rng.uniform(50, 600, (b, 16, 2))[:, rng.integers(0, 16, k)] + rng.normal(0, 4, (b, k, 2))
    wh = rng.uniform(40, 60, (b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1) + rng.integers(0, 2, (b, k, 1)) * 7680.0
    bt = torch.from_numpy(boxes.astype(np.float32)).to(dev)
    vt = torch.from_numpy(rng.uniform(size=(b, k)) > 0.1).to(dev)
    n0 = greedy_keep.launches
    got = greedy_keep(bt, vt, 0.7)
    torch.cuda.synchronize()
    assert greedy_keep.launches == n0 + 1
    assert torch.equal(got, greedy_keep_reference(bt, vt, 0.7))


@pytest.mark.gpu
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    with pytest.raises(ValueError):
        greedy_keep(torch.zeros(1, 2049, 4, device=dev), torch.zeros(1, 2049, dtype=torch.bool, device=dev), 0.7)
    with pytest.raises(ValueError):
        greedy_keep(torch.zeros(1, 8, 4, device=dev, dtype=torch.float64), torch.zeros(1, 8, dtype=torch.bool, device=dev), 0.7)
    for c in (48, 96, 192):  # the scale-x widths
        w, bias = torch.zeros(3, 3, c, c, device=dev), torch.zeros(c, device=dev)
        with pytest.raises(ValueError, match=f"C={c}"):
            fused_bottleneck(torch.zeros(1, 4, 4, c, device=dev), w, bias, w, bias)
    x = torch.zeros(1, 4, 4, 32, device=dev).permute(0, 2, 1, 3)  # not contiguous
    w, bias = torch.zeros(3, 3, 32, 32, device=dev), torch.zeros(32, device=dev)
    with pytest.raises(ValueError):
        fused_bottleneck(x, w, bias, w, bias)
    # the bf16 form: scale-x widths, layouts, packs, biases and dtypes it does not take
    for c in (48, 96, 192):
        w, bias = torch.zeros(3, 3, c, c, device=dev), torch.zeros(c, device=dev)
        with pytest.raises(ValueError, match=f"C={c}"):
            fused_bottleneck(torch.zeros(1, 4, 4, c, device=dev, dtype=torch.bfloat16), w, bias, w, bias)
    xb, w, bias = torch.zeros(1, 4, 4, 32, device=dev, dtype=torch.bfloat16), torch.zeros(3, 3, 32, 32, device=dev), \
        torch.zeros(32, device=dev)
    pack = pack_bottleneck_weights_bf16(w)
    for args in ((xb.permute(0, 2, 1, 3), pack, bias, pack, bias),  # not contiguous
                 (xb, pack_bottleneck_weights(w), bias, pack, bias),  # the f32 pack
                 (xb, pack.float(), bias, pack, bias),  # an f32 tensor of the bf16 pack's shape
                 (xb, pack, bias.bfloat16(), pack, bias)):  # a bf16 bias
        with pytest.raises(ValueError, match="fused_bottleneck_bf16"):
            fused_bottleneck_bf16(*args)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fused_bottleneck(xb.to(dtype), w, bias, w, bias)


@pytest.mark.gpu
def test_pipeline_on_card_matches_cpu():
    dev = _card()
    from spectrogram_yolov11_torch.data.synth import synth_frames
    from spectrogram_yolov11_torch.engine.pipeline import build_pipeline

    fn_g, _, nh, nw = build_pipeline(CKPT, device=dev, imgsz=320, src_hw=(180, 320))
    fn_c, _, _, _ = build_pipeline(CKPT, device="cpu", imgsz=320, src_hw=(180, 320))
    frames = synth_frames(4, nh, nw, seed=5)
    fb, gk = fused_bottleneck.launches, greedy_keep.launches
    out_g, n_g = fn_g(torch.from_numpy(frames).to(dev))
    torch.cuda.synchronize()
    assert (fused_bottleneck.launches - fb, greedy_keep.launches - gk) == (6, 1)
    out_c, n_c = fn_c(frames)
    assert torch.equal(n_g.cpu(), n_c) and int(n_c.sum()) > 0
    assert torch.equal(out_g[..., 5].cpu(), out_c[..., 5])
    torch.testing.assert_close(out_g[..., :5].cpu(), out_c[..., :5], atol=1e-2, rtol=0)


@pytest.mark.gpu
def test_scale_s_forward_on_card_matches_cpu():
    """The trained checkpoint's model dict at scale s (C3k widths 64 and 128),
    default init, folded: the card's forward runs the kernel 6 times and
    matches the CPU forward."""
    dev = _card()
    from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint
    from spectrogram_yolov11_torch.nn.tasks import build_model

    _, meta = load_checkpoint(CKPT)
    torch.manual_seed(0)
    model = build_model(dict(meta["model_yaml"], scale="s"), nc=meta["nc"])
    widths = sorted({m.b1.numel() for m in model.modules() if getattr(m, "fusable", False)})
    assert widths == [64, 128]
    model_g = copy.deepcopy(model).to(dev, memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (2, 3, 320, 320)).astype(np.float32))
    n0 = fused_bottleneck.launches
    with torch.inference_mode():
        got = model_g(x.to(dev).contiguous(memory_format=torch.channels_last))
        torch.cuda.synchronize()
        ref = model(x)
    assert fused_bottleneck.launches - n0 == 6
    for (gb, gc), (rb, rc) in zip(got, ref):
        torch.testing.assert_close(gb.cpu(), rb, atol=1e-3, rtol=1e-3)
        torch.testing.assert_close(gc.cpu(), rc, atol=1e-3, rtol=1e-3)


def _seeded_captures(n: int, seed: int) -> np.ndarray:
    from spectrogram_yolov11_torch.data.synth import synth_iq

    rng = np.random.default_rng(seed)
    return np.stack([synth_iq(rng, 256 + 128 * 639)[0] for _ in range(n)])


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [4.0, 1e-10], ids=["eps4", "eps1e-10"])
def test_stft_on_card_matches_cpu(eps):
    """The predict configuration (n_fft 256, hop 128, 640 frames -> 640 x 640)
    and a downsampling, colormapped one, at the default eps and a floored one:
    the DFT runs in float64 on both, so they agree to 1e-5."""
    dev = _card()
    from spectrogram_yolov11_torch.ops.stft import iq_to_spectrogram

    iq = _seeded_captures(4, seed=3)
    for n_fft, hop, out_hw, cmap in ((256, 128, (640, 640), False), (256, 128, (200, 300), True)):
        got = iq_to_spectrogram(iq, n_fft, hop, out_hw, cmap, eps=eps, device=dev)
        ref = iq_to_spectrogram(iq, n_fft, hop, out_hw, cmap, eps=eps, device="cpu")
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), ref, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_letterbox_on_card_equals_cpu():
    dev = _card()
    from spectrogram_yolov11_torch.data.augment import letterbox_batch

    rng = np.random.default_rng(0)
    sizes = [(360, 640, 1), (720, 1280, 3), (720, 1280, 3), (500, 333, 3), (37, 53, 3), (640, 640, 3), (2000, 17, 3)]
    frames = [rng.integers(0, 256, s, dtype=np.uint8) for s in sizes]
    for imgsz in (96, 640):
        got = letterbox_batch(frames, imgsz, dev)
        assert got.device.type == "cuda" and got.shape == (len(frames), imgsz, imgsz, 3)
        assert torch.equal(got.cpu(), letterbox_batch(frames, imgsz, torch.device("cpu")))
    gray = [np.repeat(f[..., :1], 3, -1) for f in frames]
    got = letterbox_batch(gray, 640, dev)
    assert got.shape[-1] == 1 and torch.equal(got.cpu(), letterbox_batch(gray, 640, torch.device("cpu")))


def _decoded(model, frames, imgsz: int) -> torch.Tensor:
    """The CPU model's decoded predictions (B, A, 4 + nc) on the letterboxed frames."""
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.ops.decode import decode_detections

    x = letterbox_batch(frames, imgsz, torch.device("cpu"))
    with torch.inference_mode():
        return decode_detections(model(x.expand(-1, -1, -1, 3).flip(-1).float().div(255).permute(0, 3, 1, 2)),
                                 model.nc, model.stride)


def _clear_of_thresholds(model, frames, imgsz: int, conf: float = 0.25, margin: float = 1e-3) -> bool:
    """No class score within `margin` of conf and no IoU within `margin` of 0.7
    among boxes that could pass conf, on the CPU model."""
    from spectrogram_yolov11_torch.ops.iou import box_iou

    preds = _decoded(model, frames, imgsz)
    if (preds[..., 4:] - conf).abs().min() <= margin:
        return False
    for p in preds:
        p = p[p[:, 4:].max(-1).values > conf - margin]
        xyxy = torch.cat([p[:, :2] - p[:, 2:4] / 2, p[:, :2] + p[:, 2:4] / 2], -1)
        if len(p) and (box_iou(xyxy, xyxy) - 0.7).abs().min() <= margin:
            return False
    return True


@pytest.mark.gpu
def test_predict_on_card_matches_cpu(tmp_path):
    """YOLO(ckpt).predict on a .npy capture and on mixed-size arrays at 320 px:
    the card runs 6 bottleneck and 1 NMS launches per batch and agrees with the
    CPU run in counts and classes, conf to 1e-4 and boxes to 1e-2 px of the
    letterboxed frame, on inputs with no score or IoU within 1e-3 of its
    threshold (the card and the CPU give the same uint8 capture frames)."""
    _card()
    _predict_on_card_against_cpu(tmp_path)


def _with_tf32_on(fn) -> None:
    """fn() with TF32 on for cuDNN and matmul in the process; the settings are
    as the caller set them after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fn()
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
def test_predict_runs_f32_with_tf32_turned_on(tmp_path):
    """TF32 on for cuDNN and matmul in the process: predict still runs the
    network in f32 and agrees with the CPU as above, and the process's
    settings are as the caller set them after."""
    _card()
    _with_tf32_on(lambda: _predict_on_card_against_cpu(tmp_path))


@pytest.mark.gpu
def test_predict_half_runs_with_tf32_turned_on(tmp_path):
    """The same for half=True: the bf16 network's f32 products (attention's
    QK^T and AV, the DFL projection) stay in full f32, and the card agrees
    with the CPU as in test_predict_half_on_card_matches_cpu."""
    _card()
    _with_tf32_on(lambda: _predict_on_card_against_cpu(tmp_path, half=True))


@pytest.mark.gpu
def test_predict_half_on_card_matches_cpu(tmp_path):
    """predict(half=True) at 96 px: the card runs the bf16 kernel 6 times and
    NMS once per batch, and agrees with the CPU's half=True run in counts and
    classes on inputs whose bf16 scores and IoUs stay 3e-2 from conf and 0.7;
    conf and boxes within twice the port's own bf16-to-f32 distance on the same
    frames (the CPU's bf16 and the card's round in other places: oneDNN against
    cuDNN convolutions, the plain bottleneck against the kernel)."""
    _card()
    _predict_on_card_against_cpu(tmp_path, half=True)


def _predict_on_card_against_cpu(tmp_path, half: bool = False):
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.loaders import load_inference_source
    from spectrogram_yolov11_torch.data.synth import synth_frames

    # bf16 at 96 px, as the CPU tests hold it to JAX: at 320 px some score of 4 frames always lies within 3e-2 of conf
    imgsz = 96 if half else 320
    gpu, cpu = YOLO(CKPT), YOLO(CKPT, device="cpu")
    model = cpu.model.set_dtype(torch.bfloat16 if half else torch.float32)
    margin = 3e-2 if half else 1e-3
    for seed in range(50):
        np.save(tmp_path / "capture.npy", _seeded_captures(1, seed)[0])
        [(_, frame, _)] = list(load_inference_source(str(tmp_path / "capture.npy"), device="cpu"))
        if _clear_of_thresholds(model, [frame], imgsz, margin=margin):
            break
    else:
        raise AssertionError("no capture seed in 0..49 is clear of the thresholds")
    for seed in range(50):
        arrays = [np.repeat(synth_frames(1, h, w, seed=4 * seed + i)[0], 3, -1) for i, (h, w) in
                  enumerate([(360, 640), (720, 1280), (500, 333), (360, 640)])]
        if _clear_of_thresholds(model, arrays, imgsz, margin=margin):
            break
    else:
        raise AssertionError("no array seed in 0..49 is clear of the thresholds")
    for source, frames, batch in ((str(tmp_path / "capture.npy"), [frame], 1), (arrays, arrays, 4)):
        counts = (fused_bottleneck.launches, fused_bottleneck_bf16.launches, greedy_keep.launches)
        got = gpu.predict(source, imgsz=imgsz, batch=batch, half=half)
        moved = tuple(n - n0 for n, n0 in zip((fused_bottleneck.launches, fused_bottleneck_bf16.launches,
                                               greedy_keep.launches), counts))
        assert moved == ((0, 6, 1) if half else (6, 0, 1))
        ref = cpu.predict(source, imgsz=imgsz, batch=batch, half=half)
        assert next(gpu.predictor.model.parameters()).device.type == "cuda" and len(got) == len(ref)
        if half:  # the port's own bf16-to-f32 distance over every anchor of these frames
            d = (_decoded(model, frames, imgsz) - _decoded(cpu.model, frames, imgsz)).abs()
            conf_tol, px_tol = 2 * float(d[..., 4:].max()), 2 * float(d[..., :4].max())
        else:
            conf_tol, px_tol = 1e-4, 1e-2
        for g, r in zip(got, ref):
            assert len(g) == len(r)
            np.testing.assert_array_equal(g.boxes.cls, r.boxes.cls)
            np.testing.assert_allclose(g.boxes.conf, r.boxes.conf, atol=conf_tol, rtol=0)
            gain = min(imgsz / g.orig_shape[0], imgsz / g.orig_shape[1])
            np.testing.assert_allclose(g.boxes.xyxy, r.boxes.xyxy, atol=px_tol / gain, rtol=0)
            np.testing.assert_array_equal(g.orig_img, r.orig_img)
    assert sum(len(r) for r in got) > 0


@pytest.fixture(scope="module")
def val_split(tmp_path_factory):
    """A 4-image PNG split of the synthetic spectrogram dataset at 640 px (val
    seed 10000) and the CPU validator's results on it: results_dict and each
    image's detections in its own pixels."""
    _card()
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset

    root = tmp_path_factory.mktemp("synth4")
    data = {"path": str(root), "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
            "n_train": 0, "n_val": 4, "gen_imgsz": 640, "seed": 0, "names": {0: "LTE", 1: "RF"}}
    check_det_dataset(data)
    return data, _val_recording(YOLO(CKPT, device="cpu"), data)


def _val_recording(model, data, **kw):
    """model.val(data, batch=4, **kw) -> (results_dict, each image's detections in its own pixels)."""
    import spectrogram_yolov11_torch.engine.validator as V

    dets, inner = [], V._unletterbox_boxes
    mp = pytest.MonkeyPatch()
    mp.setattr(V, "_unletterbox_boxes", lambda *a: dets.append(inner(*a).copy()) or dets[-1])
    try:
        return model.val(data=data, batch=4, **kw), dets
    finally:
        mp.undo()


def _assert_val_matches(got, ref, tol: float = 1e-4) -> None:
    """results_dict within tol; per image, the detections above a score
    threshold (the first of 0.1, 0.15, ... with no reference score within 1e-3
    of it) equal in count and class, boxes within 1e-2 px."""
    (res, dets), (res_ref, dets_ref) = got, ref
    assert list(res) == list(res_ref) and all(abs(res[k] - res_ref[k]) <= tol for k in res), (res, res_ref)
    assert len(dets) == len(dets_ref)
    for a, b in zip(dets, dets_ref):
        t = next(t for t in np.arange(0.1, 0.9, 0.05) if np.abs(b[:, 4] - t).min(initial=1.0) > 1e-3)
        a, b = a[a[:, 4] >= t], b[b[:, 4] >= t]
        assert len(a) == len(b) and np.array_equal(a[:, 5], b[:, 5])
        assert float(np.abs(a[:, :4] - b[:, :4]).max(initial=0.0)) <= 1e-2


@pytest.mark.gpu
def test_val_on_card_matches_cpu(val_split):
    """YOLO(ckpt).val on the card (the default device) against the CPU's on the
    same 4 PNG images at 640 px, batch 4: 6 bottleneck and 1 NMS launches per
    batch; results_dict within 1e-4 and the detections as _assert_val_matches."""
    from spectrogram_yolov11_torch import YOLO

    data, cpu = val_split
    counts = (fused_bottleneck.launches, fused_bottleneck_bf16.launches, greedy_keep.launches)
    got = _val_recording(YOLO(CKPT), data)
    moved = tuple(n - n0 for n, n0 in zip((fused_bottleneck.launches, fused_bottleneck_bf16.launches,
                                           greedy_keep.launches), counts))
    assert moved == (6, 0, 1)
    _assert_val_matches(got, cpu)


@pytest.mark.gpu
def test_val_runs_f32_with_tf32_turned_on(val_split):
    """TF32 on for cuDNN and matmul in the process: val still matches the CPU."""
    from spectrogram_yolov11_torch import YOLO

    data, cpu = val_split
    _with_tf32_on(lambda: _assert_val_matches(_val_recording(YOLO(CKPT), data), cpu))


@pytest.mark.gpu
def test_val_half_launches_the_bf16_kernel():
    """val(half=True) at batch 2 on 4 images: 6 bf16 bottleneck and 1 NMS
    launches per batch, no f32 bottleneck launch; finite results."""
    import tempfile

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset

    _card()
    with tempfile.TemporaryDirectory() as tmp:
        data = check_det_dataset({"path": tmp, "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
                                  "n_train": 0, "n_val": 4, "gen_imgsz": 640, "names": ["LTE", "RF"]})
        counts = (fused_bottleneck.launches, fused_bottleneck_bf16.launches, greedy_keep.launches)
        yolo = YOLO(CKPT)
        res = yolo.val(data=data, batch=2, half=True)
        moved = tuple(n - n0 for n, n0 in zip((fused_bottleneck.launches, fused_bottleneck_bf16.launches,
                                               greedy_keep.launches), counts))
    assert moved == (0, 12, 2) and all(np.isfinite(v) for v in res.values())
    assert yolo.model.dtype == torch.float32 and yolo.validator.model.dtype == torch.bfloat16


@pytest.mark.gpu
def test_greedy_keep_kernel_on_val_candidates(val_split):
    """The keep kernel against its plain version on the val split's
    multi-label candidates at k = 2048, conf 0.001 (the validator's NMS)."""
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset
    from spectrogram_yolov11_torch.engine.pipeline import load_model
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates

    dev = _card()
    data, _ = val_split
    ds = YOLODataset(check_det_dataset(data)["val"], imgsz=640)
    model = load_model(CKPT)[0].to(dev, memory_format=torch.channels_last)
    frames = letterbox_batch([ds.load_image(i) for i in range(len(ds))], 640, dev, scaleup=False)
    with torch.inference_mode():
        rgb = frames.expand(-1, -1, -1, 3).flip(-1).float() / 255.0
        preds = decode_detections(model(rgb.permute(0, 3, 1, 2)), model.nc, model.stride)
        _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, model.nc, multi_label=True, pre_nms_topk=2048)
        assert valid.shape == (4, 2048) and int(valid.sum()) > 0
        got, ref = greedy_keep(offset_boxes, valid, 0.7), greedy_keep_reference(offset_boxes, valid, 0.7)
    assert torch.equal(got, ref)
