"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `gpu` and decides inside itself whether a card is
present; without one it skips. The file imports torch and the port only (no
JAX), so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: the bottleneck 1e-4 abs/rel (f32 FMAs summed in another order
than cuDNN's, TF32 off); the keep mask and the pipeline's counts exactly.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from spectrogram_yolov11_torch.ops.fused_conv import bottleneck_reference, fused_bottleneck
from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep, greedy_keep_reference

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("c,h,w,b", [(32, 40, 40, 4), (64, 20, 20, 4), (32, 11, 13, 2), (64, 7, 9, 3), (32, 1, 1, 1)])
def test_fused_bottleneck_kernel(c, h, w, b):
    dev = _card()
    rng = np.random.default_rng(c + h + w)
    args = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.normal(0, 1, (b, h, w, c)), rng.normal(0, 0.05, (3, 3, c, c)), rng.normal(0, 0.1, c),
        rng.normal(0, 0.05, (3, 3, c, c)), rng.normal(0, 0.1, c))]
    n0 = fused_bottleneck.launches
    got = fused_bottleneck(*args)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches == n0 + 1
    torch.testing.assert_close(got, bottleneck_reference(*args), atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 100, 512, 1024, 2048])
def test_greedy_keep_kernel(k):
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
    w, bias = torch.zeros(3, 3, 48, 48, device=dev), torch.zeros(48, device=dev)
    with pytest.raises(ValueError):
        fused_bottleneck(torch.zeros(1, 4, 4, 48, device=dev), w, bias, w, bias)
    x = torch.zeros(1, 4, 4, 32, device=dev).permute(0, 2, 1, 3)  # not contiguous
    w, bias = torch.zeros(3, 3, 32, 32, device=dev), torch.zeros(32, device=dev)
    with pytest.raises(ValueError):
        fused_bottleneck(x, w, bias, w, bias)


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
