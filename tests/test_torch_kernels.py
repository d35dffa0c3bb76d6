"""The port's two kernels' plain versions against the JAX package's kernels and
references.

CPU: bottleneck_reference vs xla_bottleneck and the Pallas fused_bottleneck in
interpret mode; greedy_keep_reference vs the Pallas pallas_greedy_keep in
interpret mode and the XLA Jacobi fixpoint ops/nms.py:_greedy_keep. The CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_yolov11_tpu.ops.nms import _greedy_keep
from spectrogram_yolov11_tpu.ops.pallas_fused_conv import fused_bottleneck as pallas_bottleneck
from spectrogram_yolov11_tpu.ops.pallas_fused_conv import xla_bottleneck
from spectrogram_yolov11_tpu.ops.pallas_nms import pallas_greedy_keep
from spectrogram_yolov11_torch.ops.fused_conv import bottleneck_reference, fused_bottleneck
from spectrogram_yolov11_torch.ops.iou import box_iou
from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep, greedy_keep_reference

# f32 sums in another order on each side; the JAX package's own Pallas test uses the same bound
ATOL = RTOL = 2e-4
THRES = 0.5


def _bottleneck_inputs(c, h, w, seed=0, b=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    w1 = rng.normal(0, 0.05, (3, 3, c, c)).astype(np.float32)
    w2 = rng.normal(0, 0.05, (3, 3, c, c)).astype(np.float32)
    b1 = rng.normal(0, 0.1, (c,)).astype(np.float32)
    b2 = rng.normal(0, 0.1, (c,)).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("c,h,w", [(32, 10, 10), (64, 10, 10), (32, 11, 13)])
def test_bottleneck_reference_matches_jax(c, h, w):
    args = _bottleneck_inputs(c, h, w)
    got = bottleneck_reference(*map(torch.from_numpy, args)).numpy()
    ref_xla = np.asarray(xla_bottleneck(*map(jnp.asarray, args)))
    ref_pallas = np.asarray(pallas_bottleneck(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(got, ref_xla, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, ref_pallas, atol=ATOL, rtol=RTOL)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(fused_bottleneck(*map(torch.from_numpy, args)).numpy(), got)


def _nms_inputs(b, k, seed):
    """Score-sorted candidates in a few clusters (many overlaps), two classes
    with the 7680-px offset applied, ~15% invalid."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(40, 600, (b, 12, 2))
    pick = rng.integers(0, 12, (b, k))
    cxy = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 12, (b, k, 2))
    wh = rng.uniform(20, 90, (b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    cls = rng.integers(0, 2, (b, k, 1)).astype(np.float64)
    boxes = (boxes + cls * 7680.0).astype(np.float32)
    valid = rng.uniform(size=(b, k)) > 0.15
    return boxes, valid


@pytest.mark.parametrize("k", [128, 512])
def test_greedy_keep_reference_matches_jax(k):
    boxes, valid = _nms_inputs(2, k, seed=k)
    iou = box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    assert np.abs(iou - THRES).min() > 1e-5, "an IoU sits on the threshold: masks could differ by rounding"
    got = greedy_keep_reference(torch.from_numpy(boxes), torch.from_numpy(valid), THRES).numpy()
    pallas = np.asarray(pallas_greedy_keep(jnp.asarray(boxes), jnp.asarray(valid), THRES, interpret=True))
    jacobi = np.stack([np.asarray(_greedy_keep(jnp.asarray(iou[i]), jnp.asarray(valid[i]), THRES)) for i in range(2)])
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, jacobi)
    assert 0 < got.sum() < valid.sum()  # some candidates kept, some suppressed
    np.testing.assert_array_equal(greedy_keep(torch.from_numpy(boxes), torch.from_numpy(valid), THRES).numpy(), got)


def test_wrappers_raise_off_cpu_and_cuda():
    with pytest.raises(ValueError, match="unsupported device"):
        greedy_keep(torch.zeros(1, 4, 4, device="meta"), torch.zeros(1, 4, dtype=torch.bool, device="meta"), 0.5)
    x = torch.zeros(1, 4, 4, 32, device="meta")
    w = torch.zeros(3, 3, 32, 32, device="meta")
    b = torch.zeros(32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bottleneck(x, w, b, w, b)
