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
within 1e-4 and the detections above a score margin equal; the training step
on the card against the CPU's with the tolerances tests/test_torch_train_step.py
holds the CPU to JAX with (assert_train_step_close); the bf16 (amp) step on
the card against the CPU's bf16 step, per quantity within 3 times the card's
own bf16-to-f32 distance (assert_amp_step_close; tests/test_torch_train_amp.py
says why 3); predict from the JPEG fixture files and val on the fixture split
against the CPU, as predict and val on arrays and PNG; the KServe-v2 server
on the card against one on the CPU (the forward tolerance above: boxes 1e-2
px, scores 1e-4), and YOLO(url) predict and val against local ones on the card
(boxes 1e-3 px, val 1e-6 per key); predict at its defaults (save=True) on
the card writing each image's plot, the file equal to the port's JPEG of the
returned Results' plot; a fork config's forward on the card against the
CPU's, f32 (1e-3 abs/rel) and bf16 (within twice the CPU's own bf16-to-f32
distance), its kernel launches equal to its fused bottlenecks, the gated
widths launching nothing; predict(augment=True) launching 18 bottlenecks
(three passes) and 1 NMS, in f32 and bf16, each input it hands the kernel
(the 640, 544 and 448 px passes' maps) against the plain version; a weight
ensemble's 12 + 1 launches and its detections against the CPU's; yolo11n-seg's
forward (feats, coefficients, prototypes) against the CPU's (1e-3 abs/rel)
and its predict's masks (at most 1e-4 of the pixels unequal), and both
kernels at the segment validator's inputs against their plain versions;
yolo11n-pose's forward (feats, raw keypoints) at (17, 3) and (5, 3) against
the CPU's (1e-3 abs/rel) and its predict's boxes and keypoints (1e-2 px),
both kernels at the pose validator's inputs, and the port's circles equal
to cv2's committed digests (tests/torch_data/pose/); yolo11n-obb's forward
(feats, raw angles) against the CPU's (1e-3 abs/rel) and its predict's
rotated boxes (1e-2 px, 1e-4 rad), the bottleneck at the obb validator's
inputs with no keep launch, and the port's polylines equal to cv2's
committed digests (tests/torch_data/obb/); yolo11n-cls's logits against the
CPU's (1e-3 abs/rel) with its 4 launches, its predict's probs (1e-5, the
top-5 equal, f32 and bf16 launches), the bottleneck at the classify
validator's 14 x 14 and 7 x 7 inputs and its top-1/top-5 equal to the CPU's;
a server on the card holding a segment, pose, OBB and classify model,
YOLO(url).predict of each against local predict on the card (boxes and
keypoints 1e-3 px, masks at most 1e-3 unequal, probs 1e-5), counted; yolov8n's
and yolov10n's forward (a legacy head; a v10 head's both branches) against
the CPU's (1e-3 abs/rel) with 5 bottleneck launches, and v10's NMS-free
top-k on the card giving the CPU's rows exactly on scores with many ties
(a stable sort on both). The tests leave
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


FORK_CASES = [("yolo11_fusion_sand3_new_GC.yaml", "n"), ("yolo11_p2_WCC_BiFPN_AKCBam_head.yaml", "n"),
              ("yolo11_p6_fusion.yaml", "n"), ("yolo11_SMSC.yaml", "l")]


@pytest.mark.gpu
@pytest.mark.parametrize("name,scale", FORK_CASES)
def test_fork_config_on_card_matches_cpu(name, scale):
    """A fork config from its YAML with init(seed) and seeded BN statistics
    (variances 0.15-0.25, chip_smoke.py:scaled_bn): the card's f32 forward
    launches the kernel once per fused bottleneck (the gated ones, C = 16 or
    48, run their convs) and matches the CPU's forward (1e-3 abs/rel); the
    card's bf16 copy launches the bf16 kernel as often and lies within twice
    the CPU's own bf16-to-f32 distance of the CPU's bf16 copy."""
    dev = _card()
    from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load

    d = yaml_model_load(name)
    d["scale"] = scale
    model = build_model(d).init(0)
    # seeded BN statistics with variances of 0.15-0.25, so the activations keep a scale of 0.05-0.9
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(torch.empty(m.running_var.shape).uniform_(0.15, 0.25, generator=g))
    model.eval()
    fused = len(model.bottlenecks()["fused"])
    assert fused and (name not in ("yolo11_fusion_sand3_new_GC.yaml", "yolo11_p6_fusion.yaml")
                      or model.bottlenecks()["gated"])
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 3, 128, 128)).astype(np.float32))
    model_g = copy.deepcopy(model).to(dev, memory_format=torch.channels_last)
    xg = x.to(dev).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        n0, b0 = fused_bottleneck.launches, fused_bottleneck_bf16.launches
        got = model_g(xg)
        torch.cuda.synchronize()
        assert (fused_bottleneck.launches - n0, fused_bottleneck_bf16.launches - b0) == (fused, 0)
        ref = model(x)
        for g, r in zip([t for p in got for t in p], [t for p in ref for t in p]):
            torch.testing.assert_close(g.cpu(), r, atol=1e-3, rtol=1e-3)
        n0, b0 = fused_bottleneck.launches, fused_bottleneck_bf16.launches
        got16 = model_g.set_dtype(torch.bfloat16)(xg)
        torch.cuda.synchronize()
        assert (fused_bottleneck.launches - n0, fused_bottleneck_bf16.launches - b0) == (0, fused)
        ref16 = model.set_dtype(torch.bfloat16)(x)
        for g, r16, r in zip(*([t for p in o for t in p] for o in (got16, ref16, ref))):
            d_cpu = float((r16.float() - r).abs().max())
            assert float((g.float().cpu() - r16.float()).abs().max()) <= 2 * d_cpu


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
        got = gpu.predict(source, imgsz=imgsz, batch=batch, half=half, save=False)
        moved = tuple(n - n0 for n, n0 in zip((fused_bottleneck.launches, fused_bottleneck_bf16.launches,
                                               greedy_keep.launches), counts))
        assert moved == ((0, 6, 1) if half else (6, 0, 1))
        ref = cpu.predict(source, imgsz=imgsz, batch=batch, half=half, save=False)
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
        return model.val(data=data, batch=4, **{"plots": False, **kw}), dets
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


JPEG_FIXTURES = Path(__file__).resolve().parent / "torch_data" / "jpeg"


@pytest.mark.gpu
def test_predict_from_jpeg_files_on_card_matches_cpu():
    """YOLO(ckpt).predict on the JPEG fixture directory (the JAX generator's 8
    Spectrogram.yaml val frames) at batch 8 and on a glob of the small encodes
    of the four colour samplings, at 320 px: 6 bottleneck and 1 NMS
    launches per batch, the decoded frames equal, and counts and classes
    equal to the CPU's, conf to 1e-4 and boxes to 1e-2 px of the letterboxed
    frame (the directory's frames are clear of conf and iou by 4e-4 or more
    at 320 px)."""
    _card()
    from spectrogram_yolov11_torch import YOLO

    gpu, cpu = YOLO(CKPT), YOLO(CKPT, device="cpu")
    detections = []
    for source, batch in ((JPEG_FIXTURES / "spectrogram" / "images" / "val", 8), (JPEG_FIXTURES / "s4*.jpg", 1)):
        n = len(list(source.glob("*.jpg")) if source.is_dir() else list(JPEG_FIXTURES.glob(source.name)))
        counts = (fused_bottleneck.launches, greedy_keep.launches)
        got = gpu.predict(str(source), imgsz=320, batch=batch, save=False)
        torch.cuda.synchronize()
        batches = -(-n // batch)
        assert (fused_bottleneck.launches - counts[0], greedy_keep.launches - counts[1]) == (6 * batches, batches)
        ref = cpu.predict(str(source), imgsz=320, batch=batch, save=False)
        assert len(got) == len(ref) == n and [g.path for g in got] == [r.path for r in ref]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.orig_img, r.orig_img)
            assert len(g) == len(r)
            np.testing.assert_array_equal(g.boxes.cls, r.boxes.cls)
            np.testing.assert_allclose(g.boxes.conf, r.boxes.conf, atol=1e-4, rtol=0)
            gain = min(320 / g.orig_shape[0], 320 / g.orig_shape[1])
            np.testing.assert_allclose(g.boxes.xyxy, r.boxes.xyxy, atol=1e-2 / gain, rtol=0)
        detections.append(sum(len(r) for r in got))
    assert detections[0] > 0


def _jpeg_split(tmp_path) -> dict:
    """A copy of the JPEG fixture split (its dataset writes the label cache beside the images)."""
    import shutil

    shutil.copytree(JPEG_FIXTURES / "spectrogram", tmp_path / "spectrogram")
    return {"path": str(tmp_path / "spectrogram"), "val": "images/val", "names": {0: "LTE", 1: "RF"}}


@pytest.mark.gpu
def test_val_on_jpeg_fixtures_on_card_matches_cpu(tmp_path):
    """YOLO(ckpt).val on the JPEG fixture split on the card against the CPU's:
    results_dict within 1e-4, the detections above a score margin equal."""
    _card()
    from spectrogram_yolov11_torch import YOLO

    data = _jpeg_split(tmp_path)
    _assert_val_matches(_val_recording(YOLO(CKPT), data), _val_recording(YOLO(CKPT, device="cpu"), data))


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
        res = yolo.val(data=data, batch=2, half=True, plots=False)
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


# -- the detect training step -------------------------------------------------------------------------------

TRAIN_STEPS = ((3, False), (4, True))  # an accumulation step, then an optimizer step with lr != 0 in the warmup


@pytest.fixture(scope="module")
def train_split(tmp_path_factory):
    """A 4-image PNG val split of the synthetic spectrogram dataset at 128 px, for the trainer's data and val."""
    _card()
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset

    root = tmp_path_factory.mktemp("synth128")
    return check_det_dataset({"path": str(root), "train": "images/train", "val": "images/val",
                              "synthetic": "spectrogram", "n_train": 0, "n_val": 4, "gen_imgsz": 128,
                              "names": {0: "LTE", 1: "RF"}})


def _train_batch(seed: int = 2, b: int = 2, imgsz: int = 64, g: int = 6) -> dict:
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 2, (b, g)).astype(np.int32)
    xy, wh = rng.uniform(0.2, 0.8, (b, g, 2)), rng.uniform(0.05, 0.4, (b, g, 2))
    bboxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.arange(g)[None] < rng.integers(1, g, (b, 1))
    bboxes[~mask], cls[~mask] = 0, 0
    return {"img": rng.integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8), "cls": cls, "bboxes": bboxes,
            "mask_gt": mask}


def _trained_steps(device: str, data: dict, batch: dict, amp: bool = False):
    """The trained model through TRAIN_STEPS on `device` (optimizer auto -> AdamW), in f32 or
    with amp in bf16: (trainer, per-step loss items, the grad buffer after the accumulation
    step, the initial params)."""
    from spectrogram_yolov11_torch.engine.pipeline import load_model
    from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer

    t = DetectionTrainer(load_model(CKPT)[0], {"data": data, "imgsz": int(batch["img"].shape[1]),
                                               "batch": len(batch["img"]), "amp": amp, "device": device,
                                               "workers": 2})
    t.setup_model()
    t.setup_optimizer(nb=50)
    init = [p.detach().cpu().clone() for p in t.params]
    items, grads = [], None
    for ni, do_step in TRAIN_STEPS:
        items.append(t.train_step(batch, ni, do_step)[1].cpu())
        if not do_step:
            grads = [g.cpu().clone() for g in t.state["grad_buf"]]
    return t, items, grads, init


def assert_train_step_close(card, cpu) -> None:
    """The card's step against the CPU's, the tolerances of tests/test_torch_train_step.py
    (which holds the CPU to JAX): items 1e-4 relative; grads and first moments within 5e-4
    of each leaf's max (1e-6 of the largest leaf's for leaves that cancel analytically);
    params and their EMA within 1e-3 of the leaf's change plus four f32 steps, else within
    2 lr (AdamW's first step on a noise-level grad) for at most 1 % of elements; BN
    statistics and their EMA within 1e-5 of the leaf's max."""
    (tc, items_c, grads_c, init), (tp, items_p, grads_p, _) = card, cpu
    for a, b in zip(items_c, items_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=0)

    def leafwise(got, ref, frac):
        top = max(float(r.abs().max()) for r in ref)
        for g, r in zip(got, ref):
            scale = float(r.abs().max())
            assert float((g.cpu() - r).abs().max()) <= (frac * scale if scale >= 1e-6 * top else 1e-6 * top)

    leafwise(grads_c, grads_p, 5e-4)
    leafwise(tc.state["opt"]["mu"], tp.state["opt"]["mu"], 5e-4)
    from spectrogram_yolov11_torch.engine.optim import lr_at

    lr_main, lr_bias, _ = lr_at(tp.opt, TRAIN_STEPS[-1][0])
    loose = total = 0
    for got, ref in ((tc.params, tp.params), (tc.state["ema"]["params"], tp.state["ema"]["params"])):
        for name, g, r, p0 in zip(tp.param_names, got, ref, init):
            r = r.detach()
            err = (g.detach().cpu() - r).abs()
            tight = 1e-3 * float((r - p0).abs().max()) + 4 * float(np.spacing(np.float32(r.abs().max())))
            lr = lr_bias if name.endswith("bias") else lr_main
            assert float(err.max()) <= 2 * lr + 4 * float(np.spacing(np.float32(r.abs().max()))), name
            loose += int((err > tight).sum())
            total += r.numel()
    assert loose <= 0.01 * total, f"{loose} of {total} elements past the tight bound"
    for got, ref in ((tc.stats, tp.stats), (tc.state["ema"]["batch_stats"], tp.state["ema"]["batch_stats"])):
        for g, r in zip(got, ref):
            assert float((g.cpu() - r).abs().max()) <= 1e-5 * float(r.abs().max())
    assert tc.state["ema_updates"] == tp.state["ema_updates"] == 1
    assert all(float(b.abs().max()) == 0.0 for b in tc.state["grad_buf"])


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(train_split):
    """The trained spectrogram_yolo11n at 64 px, B = 2: an accumulation step and
    an AdamW step on the card against the same on the CPU; no kernel launches
    (training runs the bottlenecks unfused)."""
    batch = _train_batch()
    counts = (fused_bottleneck.launches, fused_bottleneck_bf16.launches, greedy_keep.launches)
    card = _trained_steps("cuda", train_split, batch)
    assert (fused_bottleneck.launches, fused_bottleneck_bf16.launches, greedy_keep.launches) == counts
    assert_train_step_close(card, _trained_steps("cpu", train_split, batch))


@pytest.mark.gpu
def test_train_step_runs_f32_with_tf32_turned_on(train_split):
    """TF32 on for cuDNN and matmul in the process: the step, backward and
    update included, still runs in f32 and matches the CPU."""
    batch = _train_batch(seed=5)
    _with_tf32_on(lambda: assert_train_step_close(_trained_steps("cuda", train_split, batch),
                                                  _trained_steps("cpu", train_split, batch)))


@pytest.mark.gpu
def test_ema_validate_launches_the_kernels_and_refolds(train_split):
    """After the steps the EMA's eval model runs its fused bottlenecks on
    weights folded from the EMA (the kernel within 1e-4 of the plain
    bottleneck on the EMA's own weights, which moved), and validate() scores
    it with 6 bottleneck + 1 NMS launches per val batch, no bf16 launch."""
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck

    t = _trained_steps("cuda", train_split, _train_batch(imgsz=128))[0]
    model = t.ema_eval_model()
    fused = [m for m in model.modules() if isinstance(m, Bottleneck) and m.fusable]
    assert len(fused) == 6 and not model.training
    from spectrogram_yolov11_torch.engine.pipeline import load_model

    trained_fold = [m.w1 for m in load_model(CKPT)[0].modules() if getattr(m, "fusable", False)]
    moved = 0
    for m, w1_before in zip(fused, trained_fold):
        (w1, b1), (w2, b2) = m.cv1.folded(), m.cv2.folded()
        moved += int(not torch.equal(m.w1.cpu(), w1_before))
        x = torch.randn(2, w1.shape[0], 20, 20, device="cuda").contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            got = m(x)
            ref = bottleneck_reference(x.permute(0, 2, 3, 1), w1.permute(2, 3, 1, 0), b1, w2.permute(2, 3, 1, 0), b2)
        torch.testing.assert_close(got.permute(0, 2, 3, 1), ref, atol=1e-4, rtol=1e-4)
    assert moved == len(fused)  # the EMA moved every bottleneck's weights, and eval() folded them again
    counts = (fused_bottleneck.launches, fused_bottleneck_bf16.launches, greedy_keep.launches)
    res = t.validate()
    moved = tuple(n - n0 for n, n0 in zip((fused_bottleneck.launches, fused_bottleneck_bf16.launches,
                                           greedy_keep.launches), counts))
    assert moved == (12, 0, 2) and all(np.isfinite(v) for v in res.values())  # 4 images at batch 2


def amp_step_distances(card_bf16, cpu_bf16, card_f32) -> dict:
    """Per quantity (loss items, the grad buffer after the accumulation step, params, both
    moments, BN statistics, their EMA), over all its leaves: (||card bf16 - CPU bf16||,
    ||card bf16 - card f32||), each relative to the CPU bf16's norm."""
    def parts(run):
        t, items, grads, _ = run
        st = t.state
        return {"items": items, "grads": grads, "params": t.params, "mu": st["opt"]["mu"], "nu": st["opt"]["nu"],
                "batch_stats": t.stats, "ema_params": st["ema"]["params"],
                "ema_batch_stats": st["ema"]["batch_stats"]}

    vec = lambda ts: torch.cat([t.detach().float().cpu().flatten() for t in ts])  # noqa: E731
    a, b, f = (parts(r) for r in (card_bf16, cpu_bf16, card_f32))
    out = {}
    for k in a:
        va, vb, vf = vec(a[k]), vec(b[k]), vec(f[k])
        n = float(vb.norm())
        out[k] = (float((va - vb).norm()) / n, float((va - vf).norm()) / n)
    return out


def assert_amp_step_close(card_bf16, cpu_bf16, card_f32, multiple: float = 3.0) -> None:
    """The card's bf16 step against the CPU's: per quantity within `multiple` times the
    card's own bf16-to-f32 distance (tests/test_torch_train_amp.py says why 3: two bf16
    evaluations of this step lie about as far apart as either lies from f32), plus 1e-6;
    every state tensor f32."""
    t = card_bf16[0]
    assert t.model.compute_dtype == torch.bfloat16
    assert all(x.dtype == torch.float32 for x in (*t.params, *t.stats, *t.state["grad_buf"], *t.state["opt"]["mu"],
                                                   *t.state["opt"]["nu"], *t.state["ema"]["params"]))
    for k, (err, yard) in amp_step_distances(card_bf16, cpu_bf16, card_f32).items():
        assert err <= multiple * yard + 1e-6, (k, err, yard)


@pytest.mark.gpu
def test_amp_train_step_on_card_matches_cpu(train_split):
    """amp=True: the trained model's bf16 step at 64 px, B = 2 on the card
    against the CPU's bf16 step, by the card's own bf16-to-f32 distance; no
    kernel launches in the steps."""
    batch = _train_batch()
    counts = (fused_bottleneck.launches, fused_bottleneck_bf16.launches, greedy_keep.launches)
    card = _trained_steps("cuda", train_split, batch, amp=True)
    assert (fused_bottleneck.launches, fused_bottleneck_bf16.launches, greedy_keep.launches) == counts
    assert_amp_step_close(card, _trained_steps("cpu", train_split, batch, amp=True),
                          _trained_steps("cuda", train_split, batch))


@pytest.mark.gpu
def test_amp_train_step_runs_with_tf32_turned_on(train_split):
    """TF32 on for cuDNN and matmul in the process: the bf16 step's f32 parts
    (BN, loss, assigner, optimizer) stay f32 and the step matches the CPU's as
    above."""
    batch = _train_batch(seed=5)
    _with_tf32_on(lambda: assert_amp_step_close(_trained_steps("cuda", train_split, batch, amp=True),
                                                _trained_steps("cpu", train_split, batch, amp=True),
                                                _trained_steps("cuda", train_split, batch)))


# -- the training loop: the augmenting loader's images and an epoch ---------------------------------------

class _ColourDS:
    """An in-memory dataset of colour images of ragged sizes, for TrainTransform's parameters."""

    def __init__(self, n: int = 4, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            h, w = int(rng.integers(90, 200)), int(rng.integers(90, 200))
            box = np.array([[0.2 * w, 0.3 * h, 0.7 * w, 0.8 * h]], np.float32)
            self.items.append((rng.integers(0, 256, (h, w, 3), dtype=np.uint8), box, np.zeros(1, np.int32)))

    def __len__(self):
        return len(self.items)

    def load_sample(self, i, square_to=None):
        img, b, c = self.items[i]
        h0, w0 = img.shape[:2]
        r = square_to / max(h0, w0)
        h, w = min(int(h0 * r), square_to), min(int(w0 * r), square_to)
        img = img[(np.arange(h) * h0 // h)[:, None], np.arange(w) * w0 // w]
        return {"img": img, "cls": c.copy(), "bboxes": b * np.float32(r)}


@pytest.mark.gpu
@pytest.mark.parametrize("hyp", [{}, {"device_augment": True, "degrees": 10.0, "shear": 3.0, "perspective": 5e-4,
                                      "flipud": 0.5}], ids=["separable", "general"])
def test_augment_batch_on_card_equals_cpu(hyp):
    """The train images assembled on the card equal the CPU's, value for value,
    on TrainTransform's parameters for 4 seeded samples at 160 px (mosaic on for
    the first two, off after)."""
    from spectrogram_yolov11_torch.cfg import DEFAULT_CFG_DICT, get_cfg
    from spectrogram_yolov11_torch.data.augment import TrainTransform
    from spectrogram_yolov11_torch.ops.device_augment import augment_batch

    dev = _card()
    t = TrainTransform(_ColourDS(), 160, get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **hyp}), max_gt=32)
    samples = []
    for seed in range(4):
        if seed == 2:
            t.close_mosaic()
        samples.append(t(seed, np.random.default_rng(seed)))
    args = [torch.from_numpy(np.stack([s[k] for s in samples]))
            for k in ("aug_src", "aug_regions", "aug_pads", "aug_inv", "aug_hsv")]
    cpu = augment_batch(*args)
    card = augment_batch(*(a.to(dev) for a in args))
    assert card.device.type == "cuda" and torch.equal(card.cpu(), cpu)


@pytest.fixture(scope="module")
def loop_split(tmp_path_factory):
    """8 train and 4 val PNGs of the synthetic spectrogram dataset at 64 px."""
    _card()
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset

    root = tmp_path_factory.mktemp("synth_loop")
    return check_det_dataset({"path": str(root), "train": "images/train", "val": "images/val",
                              "synthetic": "spectrogram", "n_train": 8, "n_val": 4, "gen_imgsz": 64,
                              "names": {0: "LTE", 1: "RF"}})


@pytest.mark.gpu
def test_train_epoch_on_card_matches_cpu(loop_split, tmp_path):
    """YOLO(ckpt).train for one epoch of the trained model at 64 px, B = 2 (4
    steps, SGD, mosaic on) on the card against the same on the CPU: the epoch's
    loss items within 1e-4 relative, the final weights (the EMA) within 1e-3 of
    each leaf's change plus four f32 steps, BN statistics within 1e-5 of the
    leaf's max, the val metrics within 1e-4; the steps launch no kernel and the
    EMA's val 6 + 1 per val batch."""
    import csv

    from spectrogram_yolov11_torch import YOLO

    init = {k: v.clone() for k, v in YOLO(CKPT, device="cpu").model.state_dict().items()}
    runs = {}
    for dev in ("cuda", "cpu"):
        yolo = YOLO(CKPT, device=dev)
        counts = []
        yolo.add_callback("on_train_start", lambda t: counts.append((fused_bottleneck.launches, greedy_keep.launches)))
        yolo.add_callback("on_train_batch_end",
                          lambda t: counts.append((fused_bottleneck.launches, greedy_keep.launches)))
        yolo.add_callback("on_fit_epoch_end", lambda t: counts.append((fused_bottleneck.launches, greedy_keep.launches)))
        metrics = yolo.train(data=loop_split, epochs=1, batch=2, imgsz=64, amp=False, optimizer="SGD", workers=2,
                             project=str(tmp_path), name=dev, plots=False)
        with open(tmp_path / dev / "results.csv") as f:
            row = {k: float(v) for k, v in next(csv.DictReader(f)).items()}
        runs[dev] = (yolo, metrics, row, counts)
    (card, m_card, row_card, counts), (cpu, m_cpu, row_cpu, _) = runs["cuda"], runs["cpu"]
    assert len(counts) == 6 and len(set(counts[:5])) == 1  # no launch in the 4 steps
    assert (counts[5][0] - counts[4][0], counts[5][1] - counts[4][1]) == (12, 2)  # 4 val images at batch 2
    for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss"):
        assert abs(row_card[k] - row_cpu[k]) <= 1e-4 * abs(row_cpu[k]), k
    assert all(abs(m_card[k] - m_cpu[k]) <= 1e-4 for k in m_cpu)
    got, ref = card.model.state_dict(), cpu.model.state_dict()
    for k, r in ref.items():
        if not r.is_floating_point():
            continue
        err = float((got[k].cpu() - r).abs().max())
        if k.endswith(("running_mean", "running_var")):
            assert err <= 1e-5 * float(r.abs().max()), k
        else:
            assert err <= 1e-3 * float((r - init[k]).abs().max()) + 4 * float(np.spacing(np.float32(r.abs().max()))), k


@pytest.mark.gpu
def test_amp_train_epoch_launches_the_bf16_kernels(loop_split, tmp_path):
    """YOLO(ckpt).train at its default amp=True for one epoch at 64 px, B = 2 on
    the card: no kernel in the 4 steps; the EMA's val runs its bf16 copy, 6
    bf16 bottlenecks + 1 NMS per val batch (4 images at batch 2), no f32
    bottleneck; the facade's model computes in bf16 after it."""
    from spectrogram_yolov11_torch import YOLO

    yolo, counts = YOLO(CKPT, device="cuda"), []
    read = lambda t: counts.append((fused_bottleneck.launches, fused_bottleneck_bf16.launches,  # noqa: E731
                                    greedy_keep.launches))
    for event in ("on_train_start", "on_train_batch_end", "on_fit_epoch_end"):
        yolo.add_callback(event, read)
    metrics = yolo.train(data=loop_split, epochs=1, batch=2, imgsz=64, workers=2, project=str(tmp_path), name="amp",
                         plots=False)
    assert yolo.trainer.args.amp is True and yolo.model.compute_dtype == torch.bfloat16
    assert len(counts) == 6 and len(set(counts[:5])) == 1
    assert tuple(b - a for a, b in zip(counts[4], counts[5])) == (0, 12, 2)
    assert yolo.trainer.validator.model.dtype == torch.bfloat16 and all(np.isfinite(v) for v in metrics.values())


@pytest.mark.gpu
def test_yaml_model_trains_and_its_ema_val_runs_the_kernels(loop_split, tmp_path):
    """YOLO("yolo11n.yaml") (nc 80, fresh weights from seed 0) trains one epoch
    at its defaults (amp) at 64 px, B = 2 on the card: the head rebuilt for the
    data's nc = 2, no kernel in the 4 steps, the EMA's val 6 bf16 bottlenecks +
    1 NMS per val batch and no f32 bottleneck; each bf16 bottleneck of the
    first val against its plain version on the inputs it was handed (global
    module hooks, which launch nothing), and the keep kernel on that val's
    candidates exactly. Then YOLO("spectrogram_yolo11n.yaml").load(ckpt)
    validates on the card equal to YOLO(ckpt), with 6 f32 bottleneck + 1 NMS
    launches per val batch."""
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.engine.validator import VAL_PRE_NMS_TOPK
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
    from spectrogram_yolov11_torch.nn.modules.head import Detect
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.fused_conv import unpack_bottleneck_weights_bf16
    from spectrogram_yolov11_torch.ops.nms import nms_candidates

    cap, counts = {}, []
    yolo = YOLO("yolo11n.yaml", device="cuda")

    def pre(mod, args):  # returns None: the input stays as it is
        if isinstance(mod, Bottleneck) and mod.fusable and not mod.training and args[0].dtype == torch.bfloat16:
            cap.setdefault(mod, args[0].permute(0, 2, 3, 1).contiguous())

    def post(mod, args, out):  # returns None: the output stays as it is
        if isinstance(mod, Detect) and not mod.training and out[0][0].dtype == torch.bfloat16:
            cap.setdefault("feats", out)

    for event in ("on_train_start", "on_train_batch_end", "on_fit_epoch_end"):
        yolo.add_callback(event, lambda t: counts.append(_counts()))
    hooks = [torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_forward_hook(post)]
    try:
        metrics = yolo.train(data=loop_split, epochs=1, batch=2, imgsz=64, workers=2, project=str(tmp_path),
                             name="scratch", plots=False)
    finally:
        for h in hooks:
            h.remove()
    assert yolo.trainer.rebuilt["nc"] == (80, 2) and yolo.model.nc == 2 and yolo.trainer.args.amp is True
    assert len(counts) == 6 and len(set(counts[:5])) == 1
    assert tuple(b - a for a, b in zip(counts[4], counts[5])) == (0, 12, 2)
    assert all(np.isfinite(v) for v in metrics.values())
    fused = [m for m in cap if m != "feats"]
    assert len(fused) == 6
    with torch.inference_mode():
        for m in fused:
            x = cap[m]
            got = fused_bottleneck(x, m.w1, m.b1, m.w2, m.b2)
            ref = bottleneck_reference_bf16(x, unpack_bottleneck_weights_bf16(m.w1), m.b1,
                                            unpack_bottleneck_weights_bf16(m.w2), m.b2)
            assert got.dtype == torch.bfloat16
            assert_bf16_close(got, ref)
        preds = decode_detections(cap["feats"], 2, yolo.model.stride)
        _, _, _, valid, boxes = nms_candidates(preds, 0.001, 2, multi_label=True, pre_nms_topk=VAL_PRE_NMS_TOPK)
        assert torch.equal(greedy_keep(boxes, valid, 0.7), greedy_keep_reference(boxes, valid, 0.7))

    kw = dict(data=loop_split, imgsz=64, batch=2, plots=False)
    ref = YOLO(CKPT, device="cuda").val(**kw)
    moved = YOLO("spectrogram_yolo11n.yaml", device="cuda").load(CKPT)
    before = _counts()
    assert moved.val(**kw) == ref and _moved(before) == (12, 0, 2)


# -- serving ------------------------------------------------------------------------------------------------


def _counts() -> tuple:
    return fused_bottleneck.launches, fused_bottleneck_bf16.launches, greedy_keep.launches


def _moved(before: tuple) -> tuple:
    torch.cuda.synchronize()
    return tuple(b - a for a, b in zip(before, _counts()))


@pytest.fixture(scope="module")
def servers():
    """The KServe-v2 server of the checkpoint on the card in f32 and in bf16
    (half=True), and on the CPU, each on port 0 of 127.0.0.1."""
    _card()
    from spectrogram_yolov11_torch.serve import InferenceServer

    card = InferenceServer({"spec": CKPT}, port=0).start()
    half = InferenceServer({"spec": CKPT}, port=0, half=True).start()
    cpu = InferenceServer({"spec": CKPT}, port=0, device="cpu").start()
    yield card, half, cpu
    for srv in (card, half, cpu):
        srv.shutdown()


@pytest.mark.gpu
def test_server_on_card_matches_cpu_server(servers):
    """The same colour frames (B = 3, run in the 4-bucket, 320 px) and their
    gray planes through the card's server and the CPU's: boxes within 1e-2 px
    and scores within 1e-4 (the CPU tests' forward tolerance); 6 bottleneck
    and 0 NMS launches per dispatch, bf16 ones on the half=True server, which
    answers FP32."""
    from spectrogram_yolov11_torch.serve import RemoteModel

    card, half, cpu = servers
    x = np.random.default_rng(0).integers(0, 255, (3, 320, 320, 3), np.uint8)
    cli_card, cli_half, cli_cpu = RemoteModel(card.url), RemoteModel(half.url), RemoteModel(cpu.url)
    for batch in (x, np.ascontiguousarray(x[..., :1])):
        before = _counts()
        got = cli_card(batch)[0]
        assert _moved(before) == (6, 0, 0)
        ref = cli_cpu(batch)[0]
        assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (3, 2100, 6)
        np.testing.assert_allclose(got[..., :4], ref[..., :4], atol=1e-2, rtol=0)
        np.testing.assert_allclose(got[..., 4:], ref[..., 4:], atol=1e-4, rtol=0)
        before = _counts()
        got_half = cli_half(batch)[0]
        assert _moved(before) == (0, 6, 0) and got_half.dtype == np.float32 and np.isfinite(got_half).all()


@pytest.mark.gpu
def test_remote_predict_and_val_on_card_match_local_on_card(servers, tmp_path):
    """YOLO(url).predict and .val with the client on the card against
    YOLO(ckpt) on the card: each client batch launches 1 NMS in the client and
    6 bottlenecks in the server (none through the CPU's server); at conf=0 on
    a colour image classes equal and boxes within 1e-3 px; val on the JPEG
    fixture split within 1e-6 per key (the same pixels through the same
    network)."""
    from spectrogram_yolov11_torch import YOLO

    card, _, cpu = servers
    remote, local = YOLO(card.url), YOLO(CKPT)
    img = np.random.default_rng(2).integers(0, 255, (96, 128, 3), np.uint8)
    kw = dict(imgsz=320, conf=0.0, max_det=8, save=False)
    before = _counts()
    got = remote.predict(img, **kw)[0]
    assert _moved(before) == (6, 0, 1)
    before = _counts()
    via_cpu = YOLO(cpu.url).predict(img, **kw)[0]
    assert _moved(before) == (0, 0, 1)
    ref = local.predict(img, **kw)[0]
    for g in (got, via_cpu):
        assert len(g) == len(ref) == 8
        np.testing.assert_array_equal(g.boxes.cls, ref.boxes.cls)
    np.testing.assert_allclose(got.boxes.xyxy, ref.boxes.xyxy, atol=1e-3, rtol=0)
    data = _jpeg_split(tmp_path)
    before = _counts()
    rv = remote.val(data=data, batch=8, plots=False)
    assert _moved(before) == (6, 0, 1)
    lv = local.val(data=data, batch=8, plots=False)
    assert list(rv) == list(lv) and all(abs(rv[k] - lv[k]) <= 1e-6 for k in lv), (rv, lv)


@pytest.mark.gpu
def test_predict_saves_on_the_card(tmp_path):
    """YOLO(ckpt).predict at its defaults on the card (save=True, as JAX's):
    6 bottleneck and 1 NMS launches per batch, one <stem>.jpg per image, each
    the port's JPEG of the returned Results' plot and decoding to what the
    port's decoder gives for those bytes; with half=True the same with the
    bf16 kernel."""
    _card()
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.imageio import imdecode, imencode, imread
    from spectrogram_yolov11_torch.data.synth import synth_frames

    arrays = [np.repeat(synth_frames(1, h, w, seed=30 + i)[0], 3, -1) for i, (h, w) in
              enumerate([(360, 640), (720, 1280), (500, 333)])]
    yolo = YOLO(CKPT)
    for half, name in ((False, "f32"), (True, "bf16")):
        counts = (fused_bottleneck.launches, fused_bottleneck_bf16.launches, greedy_keep.launches)
        got = yolo.predict(arrays, batch=3, half=half, project=str(tmp_path), name=name)
        torch.cuda.synchronize()
        moved = tuple(n - n0 for n, n0 in zip((fused_bottleneck.launches, fused_bottleneck_bf16.launches,
                                               greedy_keep.launches), counts))
        assert moved == ((0, 6, 1) if half else (6, 0, 1))
        assert sorted(p.name for p in (tmp_path / name).iterdir()) == ["image0.jpg", "image1.jpg", "image2.jpg"]
        for r in got:
            data = (tmp_path / name / f"{r.path}.jpg").read_bytes()
            assert data == imencode(".jpg", r.plot())
            np.testing.assert_array_equal(imread(tmp_path / name / f"{r.path}.jpg"), imdecode(data))


@pytest.mark.gpu
def test_plot_images_on_card_equals_cpu(tmp_path):
    """A train batch's mosaic from images assembled on the card (as the trainer
    draws train_batch*.jpg) has the bytes of the one from the CPU's images:
    4 seeded samples at 160 px."""
    from spectrogram_yolov11_torch.cfg import DEFAULT_CFG_DICT, get_cfg
    from spectrogram_yolov11_torch.data.augment import TrainTransform
    from spectrogram_yolov11_torch.ops.device_augment import augment_batch
    from spectrogram_yolov11_torch.utils.plotting import plot_images

    dev = _card()
    t = TrainTransform(_ColourDS(), 160, get_cfg(DEFAULT_CFG_DICT, {"mode": "train"}), max_gt=32)
    samples = [t(seed, np.random.default_rng(seed)) for seed in range(4)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    args = [torch.from_numpy(batch[k]) for k in ("aug_src", "aug_regions", "aug_pads", "aug_inv", "aug_hsv")]
    names = {0: "LTE", 1: "RF"}
    cpu = plot_images({**batch, "img": augment_batch(*args).to(torch.uint8).numpy()}, names, tmp_path / "cpu.jpg")
    card_img = augment_batch(*(a.to(dev) for a in args)).to(torch.uint8).cpu().numpy()
    card = plot_images({**batch, "img": card_img}, names, tmp_path / "card.jpg")
    assert card.read_bytes() == cpu.read_bytes()


@pytest.mark.gpu
def test_val_at_its_defaults_writes_its_artifacts_on_the_card(val_split, tmp_path):
    """YOLO(ckpt).val at its defaults (plots=True) with save_json=True on the
    card: 6 + 1 launches, the six charts at JAX's sizes and the two JSON
    files, the confusion matrix and COCO keys equal to the CPU's val."""
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.imageio import imread

    data, _ = val_split
    counts = (fused_bottleneck.launches, fused_bottleneck_bf16.launches, greedy_keep.launches)
    card = YOLO(CKPT)
    res = card.val(data=data, batch=4, save_json=True, project=str(tmp_path))
    moved = tuple(n - n0 for n, n0 in zip((fused_bottleneck.launches, fused_bottleneck_bf16.launches,
                                           greedy_keep.launches), counts))
    assert moved == (6, 0, 1)
    out = card.validator.save_dir  # <project>/val*, as JAX's validator names it whatever `name` says
    sizes = {p.name: imread(p).shape for p in out.glob("*.png")}
    assert sizes == {**dict.fromkeys(("PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png"), (900, 1050, 3)),
                     **dict.fromkeys(("confusion_matrix.png", "confusion_matrix_normalized.png"), (1050, 1200, 3))}
    assert (out / "predictions.json").exists() and (out / "annotations.json").exists()
    cpu = YOLO(CKPT, device="cpu")
    ref = cpu.val(data=data, batch=4, save_json=True, project=str(tmp_path))
    assert list(res) == list(ref) and any(k.startswith("metrics/coco_") for k in res)
    assert all(abs(res[k] - ref[k]) <= 1e-4 for k in res), (res, ref)
    np.testing.assert_array_equal(card.validator.confusion_matrix.matrix, cpu.validator.confusion_matrix.matrix)


@pytest.mark.gpu
@pytest.mark.parametrize("half", [False, True], ids=["f32", "bf16"])
def test_tta_kernel_shapes_and_launches(half):
    """predict(augment=True) at 640 px on two seeded arrays (batch 2): 18
    bottleneck launches (6 per pass, in the dtype) and 1 NMS launch; every
    bottleneck input it hands the kernel, at 40x40 / 34x34 / 28x28 (C = 32)
    and 20x20 / 17x17 / 14x14 (C = 64), against the plain version."""
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.synth import synth_frames
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck

    _card()
    seen = {}

    def pre(mod, args):  # returns None: the input stays as it is
        if isinstance(mod, Bottleneck) and mod.fusable and not mod.training:
            seen.setdefault((mod, tuple(args[0].shape)), args[0].permute(0, 2, 3, 1).contiguous())

    frames = [np.repeat(synth_frames(1, 360, 640, seed=i)[0], 3, -1) for i in range(2)]
    yolo = YOLO(CKPT)
    hook = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    try:
        before = _counts()
        res = yolo.predict(frames, batch=2, augment=True, half=half, save=False)
        moved = _moved(before)
    finally:
        hook.remove()
    assert moved == ((0, 18, 1) if half else (18, 0, 1)) and len(res) == 2
    sizes = sorted({(k[1][1], k[1][2]) for k in seen})
    assert sizes == [(32, 28), (32, 34), (32, 40), (64, 14), (64, 17), (64, 20)]
    for (mod, _), x in seen.items():
        c = x.shape[-1]
        if half:
            ref = bottleneck_reference_bf16(x, *_unpacked(mod, c, True))
            assert_bf16_close(fused_bottleneck_bf16(x, mod.w1, mod.b1, mod.w2, mod.b2), ref)
        else:
            w1, w2 = mod.w1.view(2, 9, c, c), mod.w2.view(2, 9, c, c)
            got = fused_bottleneck(x, w1, mod.b1, w2, mod.b2)
            torch.testing.assert_close(got, bottleneck_reference(x, *_unpacked(mod, c, False)), atol=1e-4, rtol=1e-4)


def _unpacked(mod, c: int, half: bool) -> tuple:
    """(w1, b1, w2, b2) of a folded bottleneck in the plain version's HWIO form."""
    from spectrogram_yolov11_torch.ops.fused_conv import unpack_bottleneck_weights, unpack_bottleneck_weights_bf16

    if half:
        return unpack_bottleneck_weights_bf16(mod.w1), mod.b1, unpack_bottleneck_weights_bf16(mod.w2), mod.b2
    return (unpack_bottleneck_weights(mod.w1.view(2, 9, c, c)), mod.b1,
            unpack_bottleneck_weights(mod.w2.view(2, 9, c, c)), mod.b2)


@pytest.mark.gpu
def test_ensemble_on_card_matches_cpu():
    """YOLO([ckpt, ckpt with its weights moved]) on two seeded arrays: 12
    bottleneck launches (6 per member) and 1 NMS launch on the card; counts
    and classes equal to the CPU's, boxes within 1e-2 px."""
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.synth import synth_frames

    _card()
    frames = [np.repeat(synth_frames(1, 360, 640, seed=10 + i)[0], 3, -1) for i in range(2)]
    card, cpu = YOLO([CKPT, CKPT]), YOLO([CKPT, CKPT], device="cpu")
    with torch.no_grad():
        for y in (card, cpu):  # a second member that differs from the lead: its weights scaled by 1.01
            for p in y._ensemble[1].model.parameters():
                p.mul_(1.01)
            y._ensemble[1].model.fold()
    before = _counts()
    got = card.predict(frames, batch=2, save=False)
    assert _moved(before) == (12, 0, 1)
    ref = cpu.predict(frames, batch=2, save=False)
    for g, r in zip(got, ref):
        assert len(g) == len(r) and np.array_equal(g.boxes.cls, r.boxes.cls)
        assert float(np.abs(g.boxes.xyxy - r.boxes.xyxy).max(initial=0.0)) <= 1e-2


def _seg_model():
    """yolo11n-seg at scale n, init(0), BN statistics seeded as the fork
    configs' (variances 0.15-0.25), the class branches' last biases 0 (scores
    near 0.5, so predict keeps detections)."""
    from spectrogram_yolov11_torch.nn.tasks import build_model

    model = build_model("yolo11n-seg.yaml", nc=2).init(0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(torch.empty(m.running_var.shape).uniform_(0.15, 0.25, generator=g))
        for branch in model.model[-1].detect.cv3:
            branch[-1].bias.zero_()
    return model.eval()


@pytest.mark.gpu
def test_segment_forward_and_predict_on_card_match_cpu(tmp_path):
    """yolo11n-seg: the card's f32 forward (feats, coefficients, prototypes)
    against the CPU's (1e-3 abs/rel), 6 bottleneck launches; its predict on 3
    arrays at conf 0.01, max_det 30 (SegmentationPredictor, 6 + 1 launches per batch)
    against the CPU's: counts and classes equal, boxes within 1e-2 px, the
    masks' unequal pixels at most 1e-4 of all."""
    dev = _card()
    from spectrogram_yolov11_torch.engine.predictor import SegmentationPredictor

    model = _seg_model()
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 3, 256, 256)).astype(np.float32))
    model_g = copy.deepcopy(model).to(dev, memory_format=torch.channels_last)
    with torch.inference_mode():
        n0 = fused_bottleneck.launches
        got = model_g(x.to(dev).contiguous(memory_format=torch.channels_last))
        torch.cuda.synchronize()
        assert fused_bottleneck.launches - n0 == 6
        ref = model(x)
    flat = lambda o: [t for p in o[0] for t in p] + [o[1], o[2]]  # noqa: E731
    for g, r in zip(flat(got), flat(ref)):
        torch.testing.assert_close(g.cpu(), r, atol=1e-3, rtol=1e-3)
    rng = np.random.default_rng(4)
    arrays = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((360, 640, 3), (500, 333, 3), (640, 640, 3))]
    kw = dict(conf=0.01, max_det=30, save=False)
    n0, k0 = fused_bottleneck.launches, greedy_keep.launches
    card = SegmentationPredictor(model, overrides=dict(kw, device="cuda"))(arrays, batch_size=3)
    assert (fused_bottleneck.launches - n0, greedy_keep.launches - k0) == (6, 1)
    cpu = SegmentationPredictor(model, overrides=dict(kw, device="cpu"))(arrays, batch_size=3)
    unequal = total = 0
    for a, b in zip(card, cpu):
        assert len(a) == len(b) and np.array_equal(a.boxes.cls, b.boxes.cls)
        if len(a):
            np.testing.assert_allclose(a.boxes.xyxy, b.boxes.xyxy, atol=1e-2, rtol=0)
            unequal += int((a.masks.data != b.masks.data).sum())
            total += a.masks.data.size
    assert total and unequal <= 1e-4 * total


@pytest.mark.gpu
def test_kernels_at_segment_val_inputs():
    """The segment validator's device function on the card (yolo11n-seg, B = 4
    at 640 px): 6 bottleneck and 1 keep launches; each bottleneck input it
    hands the kernel against the plain version (1e-4 abs/rel), and the keep
    kernel at its single-label (4, 2048) candidates equal to the plain
    version."""
    dev = _card()
    from spectrogram_yolov11_torch.engine.pipeline import build_segment_fn
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates

    model = _seg_model().to(dev, memory_format=torch.channels_last)
    fn = build_segment_fn(model, conf=0.001, iou=0.7, pre_nms_topk=2048, binary=True)
    cap, heads = {}, []

    def keep(mod, args):  # returns None: the input stays as it is
        cap.setdefault(mod, args[0].permute(0, 2, 3, 1).contiguous())

    hooks = [m.register_forward_pre_hook(keep) for m in model.modules() if isinstance(m, Bottleneck) and m.fusable]
    hooks.append(model.model[-1].detect.register_forward_hook(lambda m, a, o: heads.append(o)))
    frames = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (4, 640, 640, 3), dtype=np.uint8)).to(dev)
    n0, k0 = fused_bottleneck.launches, greedy_keep.launches
    out, nv, masks = fn(frames)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    assert (fused_bottleneck.launches - n0, greedy_keep.launches - k0) == (6, 1) and len(cap) == 6
    assert masks.dtype == torch.bool and masks.shape == (4, 300, 160, 160)
    with torch.inference_mode():
        for mod, x in cap.items():
            c = x.shape[-1]
            got = fused_bottleneck(x, mod.w1.view(2, 9, c, c), mod.b1, mod.w2.view(2, 9, c, c), mod.b2)
            torch.testing.assert_close(got, bottleneck_reference(x, *_unpacked(mod, c, False)), atol=1e-4, rtol=1e-4)
        preds = decode_detections(heads[0], model.nc, model.stride)
        _, _, _, valid, boxes = nms_candidates(preds, 0.001, model.nc, pre_nms_topk=2048)
        assert valid.shape == (4, 2048)
        assert torch.equal(greedy_keep(boxes, valid, 0.7), greedy_keep_reference(boxes, valid, 0.7))


def _pose_model(kpt=(17, 3)):
    """yolo11n-pose at scale n with `kpt` keypoints, init(0), BN statistics
    seeded as _seg_model's, the class branches' last biases 0."""
    from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load

    model = build_model({**yaml_model_load("yolo11n-pose.yaml"), "kpt_shape": list(kpt)}).init(0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(torch.empty(m.running_var.shape).uniform_(0.15, 0.25, generator=g))
        for branch in model.model[-1].detect.cv3:
            branch[-1].bias.zero_()
    return model.eval()


@pytest.mark.gpu
@pytest.mark.parametrize("kpt", [(17, 3), (5, 3)])
def test_pose_forward_and_predict_on_card_match_cpu(kpt):
    """yolo11n-pose: the card's f32 forward (feats and raw keypoints) against
    the CPU's (1e-3 abs/rel), 6 bottleneck launches; its predict on 3 arrays
    at conf 0.01, max_det 30 (PosePredictor, 6 + 1 launches per batch)
    against the CPU's: counts and classes equal, boxes and keypoints within
    1e-2 px, the keypoints' scores within 1e-4."""
    dev = _card()
    from spectrogram_yolov11_torch.engine.predictor import PosePredictor

    model = _pose_model(kpt)
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 3, 256, 256)).astype(np.float32))
    model_g = copy.deepcopy(model).to(dev, memory_format=torch.channels_last)
    with torch.inference_mode():
        n0 = fused_bottleneck.launches
        got = model_g(x.to(dev).contiguous(memory_format=torch.channels_last))
        torch.cuda.synchronize()
        assert fused_bottleneck.launches - n0 == 6
        ref = model(x)
    assert got[1].shape == (2, 1344, kpt[0] * kpt[1])
    for g, r in zip([t for p in got[0] for t in p] + [got[1]], [t for p in ref[0] for t in p] + [ref[1]]):
        torch.testing.assert_close(g.cpu(), r, atol=1e-3, rtol=1e-3)
    rng = np.random.default_rng(4)
    arrays = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((360, 640, 3), (500, 333, 3), (640, 640, 3))]
    kw = dict(conf=0.01, max_det=30, save=False)
    n0, k0 = fused_bottleneck.launches, greedy_keep.launches
    card = PosePredictor(model, overrides=dict(kw, device="cuda"))(arrays, batch_size=3)
    assert (fused_bottleneck.launches - n0, greedy_keep.launches - k0) == (6, 1)
    cpu = PosePredictor(model, overrides=dict(kw, device="cpu"))(arrays, batch_size=3)
    for a, b in zip(card, cpu):
        assert len(a) == len(b) > 0 and np.array_equal(a.boxes.cls, b.boxes.cls)
        np.testing.assert_allclose(a.boxes.xyxy, b.boxes.xyxy, atol=1e-2, rtol=0)
        np.testing.assert_allclose(a.keypoints.xy, b.keypoints.xy, atol=1e-2, rtol=0)
        np.testing.assert_allclose(a.keypoints.conf, b.keypoints.conf, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_kernels_at_pose_val_inputs():
    """The pose validator's device function on the card (yolo11n-pose at
    (17, 3), B = 4 at 640 px): 6 bottleneck and 1 keep launches; each
    bottleneck input it hands the kernel against the plain version (1e-4
    abs/rel), and the keep kernel at its single-label (4, 2048) candidates
    equal to the plain version. The circles of tests/test_torch_pose_engine.py's
    committed cases, drawn on this machine (no cv2 here), equal cv2's digests."""
    import hashlib
    import json

    dev = _card()
    from spectrogram_yolov11_torch.engine.pipeline import build_pose_fn
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.utils.plotting import circle

    model = _pose_model().to(dev, memory_format=torch.channels_last)
    fn = build_pose_fn(model, conf=0.001, iou=0.7, pre_nms_topk=2048)
    cap, heads = {}, []

    def keep(mod, args):  # returns None: the input stays as it is
        cap.setdefault(mod, args[0].permute(0, 2, 3, 1).contiguous())

    hooks = [m.register_forward_pre_hook(keep) for m in model.modules() if isinstance(m, Bottleneck) and m.fusable]
    hooks.append(model.model[-1].detect.register_forward_hook(lambda m, a, o: heads.append(o)))
    frames = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (4, 640, 640, 3), dtype=np.uint8)).to(dev)
    n0, k0 = fused_bottleneck.launches, greedy_keep.launches
    out, nv = fn(frames)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    assert (fused_bottleneck.launches - n0, greedy_keep.launches - k0) == (6, 1) and len(cap) == 6
    assert out.shape == (4, 300, 6 + 51) and int(nv.min()) > 0
    with torch.inference_mode():
        for mod, x in cap.items():
            c = x.shape[-1]
            got = fused_bottleneck(x, mod.w1.view(2, 9, c, c), mod.b1, mod.w2.view(2, 9, c, c), mod.b2)
            torch.testing.assert_close(got, bottleneck_reference(x, *_unpacked(mod, c, False)), atol=1e-4, rtol=1e-4)
        preds = decode_detections(heads[0], model.nc, model.stride)
        _, _, _, valid, boxes = nms_candidates(preds, 0.001, model.nc, pre_nms_topk=2048)
        assert valid.shape == (4, 2048)
        assert torch.equal(greedy_keep(boxes, valid, 0.7), greedy_keep_reference(boxes, valid, 0.7))
    blob = json.loads((Path(__file__).resolve().parent / "torch_data" / "pose" / "circle_digests.json").read_text())
    for c in blob["cases"]:
        img = np.random.default_rng(c["seed"]).integers(0, 256, (c["size"], c["size"], 3), dtype=np.uint8)
        drawn = circle(img, tuple(c["center"]), c["radius"], tuple(c["color"]))
        assert hashlib.sha256(np.ascontiguousarray(drawn).tobytes()).hexdigest() == blob["sha256"][c["name"]]


def _obb_model():
    """yolo11n-obb at scale n (nc 15), init(0), BN statistics seeded as _seg_model's, the class branches' last
    biases 0."""
    from spectrogram_yolov11_torch.nn.tasks import build_model

    model = build_model("yolo11n-obb.yaml").init(0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(torch.empty(m.running_var.shape).uniform_(0.15, 0.25, generator=g))
        for branch in model.model[-1].detect.cv3:
            branch[-1].bias.zero_()
    return model.eval()


@pytest.mark.gpu
def test_obb_forward_and_predict_on_card_match_cpu():
    """yolo11n-obb: the card's f32 forward (feats and raw angles) against the
    CPU's (1e-3 abs/rel), 6 bottleneck launches; its predict on 3 arrays at
    conf 0.01, max_det 30 (OBBPredictor: 6 bottleneck launches per batch and
    no keep kernel, the NMS being Fast-NMS over probiou) against the CPU's:
    counts and classes equal, xywhr within 1e-2 px and 1e-4 rad."""
    dev = _card()
    from spectrogram_yolov11_torch.engine.predictor import OBBPredictor

    model = _obb_model()
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 3, 256, 256)).astype(np.float32))
    model_g = copy.deepcopy(model).to(dev, memory_format=torch.channels_last)
    with torch.inference_mode():
        n0 = fused_bottleneck.launches
        got = model_g(x.to(dev).contiguous(memory_format=torch.channels_last))
        torch.cuda.synchronize()
        assert fused_bottleneck.launches - n0 == 6
        ref = model(x)
    assert got[1].shape == (2, 1344, 1)
    for g, r in zip([t for p in got[0] for t in p] + [got[1]], [t for p in ref[0] for t in p] + [ref[1]]):
        torch.testing.assert_close(g.cpu(), r, atol=1e-3, rtol=1e-3)
    rng = np.random.default_rng(4)
    arrays = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((360, 640, 3), (500, 333, 3), (640, 640, 3))]
    kw = dict(conf=0.01, max_det=30, save=False)
    n0, k0 = fused_bottleneck.launches, greedy_keep.launches
    card = OBBPredictor(model, overrides=dict(kw, device="cuda"))(arrays, batch_size=3)
    assert (fused_bottleneck.launches - n0, greedy_keep.launches - k0) == (6, 0)
    cpu = OBBPredictor(model, overrides=dict(kw, device="cpu"))(arrays, batch_size=3)
    for a, b in zip(card, cpu):
        assert len(a) == len(b) > 0 and np.array_equal(a.obb.cls, b.obb.cls)
        np.testing.assert_allclose(a.obb.xywhr[:, :4], b.obb.xywhr[:, :4], atol=1e-2, rtol=0)
        np.testing.assert_allclose(a.obb.xywhr[:, 4], b.obb.xywhr[:, 4], atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_kernels_at_obb_val_inputs():
    """The obb validator's device function on the card (yolo11n-obb, B = 4 at
    640 px): 6 bottleneck launches and no keep launch; each bottleneck input it
    hands the kernel against the plain version (1e-4 abs/rel); its rotated
    NMS (4, 300) on the card equal in counts and classes to the same function
    on the CPU from the card's decoded predictions. The polylines of
    tests/test_torch_obb_engine.py's committed cases and box_points of seeded
    boxes, drawn on this machine (no cv2 here), equal cv2's digests."""
    import hashlib
    import json

    dev = _card()
    from spectrogram_yolov11_torch.engine.pipeline import build_obb_fn
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
    from spectrogram_yolov11_torch.ops.decode import decode_obb
    from spectrogram_yolov11_torch.ops.boxes import box_points
    from spectrogram_yolov11_torch.ops.nms import nms_rotated
    from spectrogram_yolov11_torch.utils.plotting import polylines

    model = _obb_model().to(dev, memory_format=torch.channels_last)
    fn = build_obb_fn(model, conf=0.001, iou=0.7, pre_nms_topk=2048)
    cap, heads = {}, []

    def keep(mod, args):  # returns None: the input stays as it is
        cap.setdefault(mod, args[0].permute(0, 2, 3, 1).contiguous())

    hooks = [m.register_forward_pre_hook(keep) for m in model.modules() if isinstance(m, Bottleneck) and m.fusable]
    hooks.append(model.model[-1].register_forward_hook(lambda m, a, o: heads.append(o)))
    frames = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (4, 640, 640, 3), dtype=np.uint8)).to(dev)
    n0, k0 = fused_bottleneck.launches, greedy_keep.launches
    out, nv = fn(frames)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    assert (fused_bottleneck.launches - n0, greedy_keep.launches - k0) == (6, 0) and len(cap) == 6
    assert out.shape == (4, 300, 7) and int(nv.min()) > 0
    with torch.inference_mode():
        for mod, x in cap.items():
            c = x.shape[-1]
            got = fused_bottleneck(x, mod.w1.view(2, 9, c, c), mod.b1, mod.w2.view(2, 9, c, c), mod.b2)
            torch.testing.assert_close(got, bottleneck_reference(x, *_unpacked(mod, c, False)), atol=1e-4, rtol=1e-4)
        preds = decode_obb(*heads[0], model.nc, model.stride)
        ref, rn = nms_rotated(preds.cpu(), 0.001, 0.7, model.nc, 300, 2048)
    assert torch.equal(nv.cpu(), rn) and torch.equal(out[..., 6].cpu(), ref[..., 6])
    blob = json.loads((Path(__file__).resolve().parent / "torch_data" / "obb" / "polylines_digests.json").read_text())
    for c in blob["cases"]:
        img = np.random.default_rng(c["seed"]).integers(0, 256, (*c["size"], 3), dtype=np.uint8)
        drawn = polylines(img, np.asarray(c["pts"], np.int32), c["closed"], tuple(c["color"]), c["thickness"])
        assert hashlib.sha256(np.ascontiguousarray(drawn).tobytes()).hexdigest() == blob["sha256"][c["name"]]
    rng, bp = np.random.default_rng(blob["box_points"]["seed"]), blob["box_points"]
    n = bp["n"]
    pts = np.stack([box_points(((c[0], c[1]), (wh[0], wh[1]), a)) for c, wh, a in
                    zip(rng.uniform(-50, 700, (n, 2)), rng.uniform(0, 300, (n, 2)), rng.uniform(-360, 360, n))])
    for arr, key in ((pts, "sha256_f32"), (pts.astype(np.int32), "sha256_i32")):
        assert hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest() == bp[key]


# -- classify and serving every task ------------------------------------------------------------------------


def _cls_model():
    """yolo11n-cls at scale n (nc 3), init(0), BN statistics seeded as _seg_model's."""
    from spectrogram_yolov11_torch.nn.tasks import build_model

    model = build_model("yolo11n-cls.yaml", nc=3).init(0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(torch.empty(m.running_var.shape).uniform_(0.15, 0.25, generator=g))
    return model.eval()


@pytest.mark.gpu
def test_classify_forward_and_predict_on_card_match_cpu():
    """yolo11n-cls: its 4 fused bottlenecks (layers 6 and 8, C = 32 and 64) by
    bottlenecks(); the card's f32 logits at 224 px against the CPU's (1e-3
    abs/rel) with 4 launches; ClassificationPredictor on 3 arrays, one per
    call (4 launches each, no keep kernel): probs within 1e-5 of the CPU's and
    the top-5 equal; with half=True 4 bf16 launches per image."""
    dev = _card()
    from spectrogram_yolov11_torch.engine.predictor import ClassificationPredictor

    model = _cls_model()
    assert model.bottlenecks() == {"fused": [(6, 32), (6, 32), (8, 64), (8, 64)], "gated": []}
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 3, 224, 224)).astype(np.float32))
    model_g = copy.deepcopy(model).to(dev, memory_format=torch.channels_last)
    with torch.inference_mode():
        before = _counts()
        got = model_g(x.to(dev).contiguous(memory_format=torch.channels_last))
        assert _moved(before) == (4, 0, 0)
        torch.testing.assert_close(got.cpu(), model(x), atol=1e-3, rtol=1e-3)
    rng = np.random.default_rng(4)
    arrays = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((360, 640, 3), (500, 333, 3), (224, 224, 3))]
    kw = dict(imgsz=224, save=False)
    before = _counts()
    card = ClassificationPredictor(model, overrides=dict(kw, device="cuda"))(arrays)
    assert _moved(before) == (12, 0, 0)
    cpu = ClassificationPredictor(model, overrides=dict(kw, device="cpu"))(arrays)
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a.probs.data, b.probs.data, atol=1e-5, rtol=0)
        assert a.probs.top5 == b.probs.top5
    before = _counts()
    half = ClassificationPredictor(model, overrides=dict(kw, device="cuda", half=True))(arrays)
    assert _moved(before) == (0, 12, 0) and all(abs(float(r.probs.data.sum()) - 1) < 2e-2 for r in half)


@pytest.mark.gpu
def test_kernels_at_classify_val_inputs(tmp_path):
    """ClassificationValidator on the card over 6 val images at 224 px, batch 4
    (2 batches: 8 bottleneck launches, no keep launch) equal to the CPU's
    top-1 and top-5; each bottleneck input it hands the kernel (4 x 14 x 14 x
    32 and 4 x 7 x 7 x 64) against the plain version (1e-4 abs/rel)."""
    _card()
    from spectrogram_yolov11_torch.data.synth import gen_cls_shapes
    from spectrogram_yolov11_torch.engine.validator import ClassificationValidator
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck

    gen_cls_shapes(tmp_path, "val", 2, 160, seed=10_000)
    model = _cls_model()
    cap = {}

    def keep(mod, args):  # returns None: the input stays as it is
        if isinstance(mod, Bottleneck) and mod.fusable and not mod.training and args[0].is_cuda:
            cap.setdefault(mod, args[0].permute(0, 2, 3, 1).contiguous())

    hook = torch.nn.modules.module.register_module_forward_pre_hook(keep)
    try:
        before = _counts()
        got = ClassificationValidator(model, overrides=dict(imgsz=224, batch=4, device="cuda"))(data=str(tmp_path))
        assert _moved(before) == (8, 0, 0)
    finally:
        hook.remove()
    assert sorted(tuple(x.shape) for x in cap.values()) == [(4, 7, 7, 64)] * 2 + [(4, 14, 14, 32)] * 2
    with torch.inference_mode():
        for mod, x in cap.items():
            c = x.shape[-1]
            out = fused_bottleneck(x, mod.w1.view(2, 9, c, c), mod.b1, mod.w2.view(2, 9, c, c), mod.b2)
            torch.testing.assert_close(out, bottleneck_reference(x, *_unpacked(mod, c, False)), atol=1e-4, rtol=1e-4)
    # the validator moves the model it scores: the CPU's scores a copy
    ref = ClassificationValidator(copy.deepcopy(model), overrides=dict(imgsz=224, batch=4, device="cpu"))(
        data=str(tmp_path))
    assert got == ref


@pytest.mark.gpu
def test_served_tasks_on_card_match_local_on_card(tmp_path):
    """A server on the card with a segment, a pose (5, 3), an OBB and a classify
    model (seeded, saved as YOLO.save writes them): YOLO(url).predict of each
    on 2 frames at 320 px and conf 0.01 against YOLO(ckpt).predict on the card:
    the server's 6 bottleneck launches per dispatch (4 for the classifier), the
    client's keep kernel once per batch for segment and pose (none for OBB and
    the classifier); boxes and rotated boxes within 1e-3 px, keypoints within
    1e-3 px, masks at most 1e-3 of their pixels unequal, probs within 1e-5 and
    the top-5 equal. The pose metadata carries kpt_shape."""
    _card()
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.engine.checkpoint import save_checkpoint
    from spectrogram_yolov11_torch.serve import InferenceServer
    from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables

    ckpts = {}
    for task, model in (("segment", _seg_model()), ("pose", _pose_model((5, 3))), ("obb", _obb_model()),
                        ("classify", _cls_model())):
        ckpts[task] = tmp_path / f"{task}.ckpt"
        save_checkpoint(ckpts[task], variables=state_dict_to_variables(model.state_dict()), ema_variables=None,
                        opt_state=None, epoch=-1, best_fitness=0.0, updates=0,
                        model_yaml={k: v for k, v in model.yaml.items() if k != "yaml_file"}, names=model.names,
                        nc=model.nc)
    srv = InferenceServer({k: str(v) for k, v in ckpts.items()}, port=0).start()
    try:
        rng = np.random.default_rng(6)
        frames = [rng.integers(0, 256, (320, 320, 3), dtype=np.uint8), rng.integers(0, 256, (200, 300, 3), np.uint8)]
        for task, want in (("segment", (6, 0, 1)), ("pose", (6, 0, 1)), ("obb", (6, 0, 0)), ("classify", (8, 0, 0))):
            remote = YOLO(f"http://127.0.0.1:{srv.port}/{task}")
            assert remote.task == task and (task != "pose" or remote.backend.kpt_shape == (5, 3))
            kw = dict(imgsz=320, save=False) if task == "classify" else dict(imgsz=320, save=False, batch=2, conf=0.01)
            before = _counts()
            got = remote.predict(frames, **kw)
            assert _moved(before) == want, task
            ref = YOLO(ckpts[task]).predict(frames, **kw)
            for g, r in zip(got, ref):
                if task == "classify":
                    np.testing.assert_allclose(g.probs.data, r.probs.data, atol=1e-5, rtol=0)
                    assert g.probs.top5 == r.probs.top5
                    continue
                dg, dr = (x.obb.data if task == "obb" else x.boxes.data for x in (g, r))
                assert dg.shape == dr.shape and len(dr) > 0, task
                np.testing.assert_allclose(dg, dr, atol=1e-3, rtol=0)
                if task == "segment":
                    assert (g.masks.data != r.masks.data).mean() <= 1e-3
                if task == "pose":
                    np.testing.assert_allclose(g.keypoints.data, r.keypoints.data, atol=1e-3, rtol=0)
    finally:
        srv.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["yolov8n.yaml", "yolov10n.yaml"])
def test_v8_v10_forward_on_card_match_cpu(name):
    """yolov8n (the legacy Detect head) and yolov10n (both branches of
    v10Detect) from their YAMLs with init(0): the card's f32 forward against
    the CPU's (1e-3 abs/rel), 5 bottleneck launches (layer 2's C = 16 gated)."""
    dev = _card()
    from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load

    model = build_model(yaml_model_load(name)).init(0)
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 3, 256, 256)).astype(np.float32))
    model_g = copy.deepcopy(model).to(dev, memory_format=torch.channels_last)
    with torch.inference_mode():
        n0 = fused_bottleneck.launches
        got = model_g(x.to(dev).contiguous(memory_format=torch.channels_last))
        torch.cuda.synchronize()
        assert fused_bottleneck.launches - n0 == 5
        ref = model(x)
    pairs = (lambda o: [t for branch in ("one2many", "one2one") for p in o[branch] for t in p]) if model.end2end \
        else (lambda o: [t for p in o for t in p])
    assert len(pairs(got)) == (12 if model.end2end else 6)
    for g, r in zip(pairs(got), pairs(ref)):
        torch.testing.assert_close(g.cpu(), r, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_nms_free_postprocess_on_card_equals_cpu_on_ties():
    """ops/decode.py:nms_free_postprocess on scores drawn from four levels (most
    anchors tie) at A = 8400, nc = 2: the card's rows equal the CPU's exactly,
    ties kept in index order by the stable sort on both."""
    dev = _card()
    from spectrogram_yolov11_torch.ops.decode import nms_free_postprocess

    rng = np.random.default_rng(6)
    boxes = rng.uniform(0, 640, (4, 8400, 4)).astype(np.float32)
    scores = rng.choice(np.float32([0.0, 0.25, 0.5, 0.75]), (4, 8400, 2)).astype(np.float32)
    preds = torch.from_numpy(np.concatenate([boxes, scores], -1))
    for max_det in (300, 8400):
        got = nms_free_postprocess(preds.to(dev), max_det, 2).cpu()
        assert torch.equal(got, nms_free_postprocess(preds, max_det, 2))
