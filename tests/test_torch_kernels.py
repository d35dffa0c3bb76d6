"""The port's two kernels' plain versions against the JAX package's kernels and
references.

CPU: bottleneck_reference vs xla_bottleneck and the Pallas fused_bottleneck in
interpret mode; the kernel's weight pack, and a plain emulation of its 3xTF32
arithmetic against xla_bottleneck; greedy_keep_reference vs the Pallas
pallas_greedy_keep in interpret mode (on random cases and on the edge cases
of tests/test_torch_gpu.py) and the XLA Jacobi fixpoint ops/nms.py:_greedy_keep.
The CUDA kernels themselves are held against these plain versions on the card
by tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)
import torch.nn.functional as F
from test_torch_gpu import NMS_CASES, nms_edge_case

from spectrogram_yolov11_tpu.ops.nms import _greedy_keep
from spectrogram_yolov11_tpu.ops.pallas_fused_conv import fused_bottleneck as pallas_bottleneck
from spectrogram_yolov11_tpu.ops.pallas_fused_conv import xla_bottleneck
from spectrogram_yolov11_tpu.ops.pallas_nms import pallas_greedy_keep
from spectrogram_yolov11_torch.ops.fused_conv import (
    bottleneck_reference,
    fused_bottleneck,
    pack_bottleneck_weights,
    tf32_round,
    unpack_bottleneck_weights,
)
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


@pytest.mark.parametrize("c,h,w", [(32, 10, 10), (64, 10, 10), (32, 11, 13), (128, 10, 10)])
def test_bottleneck_reference_matches_jax(c, h, w):
    args = _bottleneck_inputs(c, h, w)
    got = bottleneck_reference(*map(torch.from_numpy, args)).numpy()
    ref_xla = np.asarray(xla_bottleneck(*map(jnp.asarray, args)))
    ref_pallas = np.asarray(pallas_bottleneck(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(got, ref_xla, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, ref_pallas, atol=ATOL, rtol=RTOL)
    # on a CPU tensor the wrapper is the plain version, from HWIO weights or their pack
    np.testing.assert_array_equal(fused_bottleneck(*map(torch.from_numpy, args)).numpy(), got)
    x, w1, b1, w2, b2 = map(torch.from_numpy, args)
    packed = fused_bottleneck(x, pack_bottleneck_weights(w1), b1, pack_bottleneck_weights(w2), b2)
    np.testing.assert_array_equal(packed.numpy(), got)


def _tf32_rna_numpy(a):
    """Independent TF32 rounding (11 significant bits, ties away from zero) in float64."""
    m, e = np.frexp(a.astype(np.float64))  # |a| = |m| * 2**e, |m| in [0.5, 1)
    scaled = np.abs(m) * 2.0**11
    return (np.sign(m) * np.floor(scaled + 0.5) * 2.0 ** (e - 11)).astype(np.float32)


@pytest.mark.parametrize("c", [32, 128])
def test_bottleneck_weight_pack(c):
    w = torch.from_numpy(np.random.default_rng(c).normal(0, 0.05, (3, 3, c, c)).astype(np.float32))
    p = pack_bottleneck_weights(w)
    assert p.shape == (2, 9, c, c) and p.dtype == torch.float32 and p.is_contiguous()
    assert torch.equal(unpack_bottleneck_weights(p), w)
    hi, lo = p[0], p[1]
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0  # 13 low mantissa bits clear
    assert torch.equal(hi + lo, p.sum(0)) and torch.equal((hi + lo).reshape(3, 3, c, c).permute(0, 1, 3, 2), w)
    assert float(lo.abs().max()) <= float(hi.abs().max()) * 2.0**-11
    np.testing.assert_array_equal(hi.numpy(), _tf32_rna_numpy(w.permute(0, 1, 3, 2).reshape(9, c, c).numpy()))
    # K-major per tap: pack[., tap, co, ci] is w[ky, kx, ci, co]
    assert torch.equal(p.sum(0)[4, 5, 7], w[1, 1, 7, 5])


def _split(t):
    """The kernel's operand split: hi = rna_tf32(a), lo = rna_tf32(a - hi)."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def _tf32_bits(t):
    """What the tensor cores read of an f32 operand: its TF32 bits, the low 13
    mantissa bits ignored."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _conv_3xtf32(x, p, passes=3):
    """One conv of the kernel: NCHW activations against a pack, the operands
    split as the kernel splits them (the activations in registers, the
    weights' lo read from the pack as TF32 bits), lo*hi + hi*lo + hi*hi summed
    (float64: products of TF32 values are exact; the kernel sums them in f32)."""
    c = p.shape[2]
    w_hi, w_lo = p[0], _tf32_bits(p[1])
    x_hi, x_lo = _split(x)

    def conv(a, w):
        oihw = w.reshape(3, 3, c, c).permute(2, 3, 0, 1)  # (9, co, ci) -> (co, ci, ky, kx)
        return F.conv2d(a.double(), oihw.double(), padding=1)

    if passes == 1:
        return conv(x_hi, w_hi)
    return conv(x_lo, w_hi) + conv(x_hi, w_lo) + conv(x_hi, w_hi)


@pytest.mark.parametrize("passes", [3, 1])
def test_bottleneck_3xtf32_emulation_matches_jax(passes):
    """The kernel's precision scheme at C = 128: 3xTF32 holds the 1e-4
    abs/rel tolerance against XLA's f32 bottleneck; one TF32 pass does not."""
    args = _bottleneck_inputs(128, 10, 10, seed=11)
    x, w1, b1, w2, b2 = map(torch.from_numpy, args)
    xc = x.permute(0, 3, 1, 2)
    y = F.silu((_conv_3xtf32(xc, pack_bottleneck_weights(w1), passes) + b1.double()[:, None, None]).float())
    out = F.silu((_conv_3xtf32(y, pack_bottleneck_weights(w2), passes) + b2.double()[:, None, None]).float()) + xc
    got = out.permute(0, 2, 3, 1).numpy()
    ref = np.asarray(xla_bottleneck(*map(jnp.asarray, args)))
    err = np.abs(got - ref) - 1e-4 * np.abs(ref)
    if passes == 3:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    else:
        assert err.max() > 1e-4, "a single TF32 pass unexpectedly held the f32 tolerance"


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


@pytest.mark.parametrize("k", [1, 63, 64, 65])
@pytest.mark.parametrize("case", NMS_CASES)
def test_greedy_keep_edge_cases_match_pallas(case, k):
    boxes, valid = nms_edge_case(case, 3, k, seed=k)
    iou = box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    assert np.abs(iou - 0.7).min() > 1e-5, "an IoU sits on the threshold: masks could differ by rounding"
    got = greedy_keep_reference(torch.from_numpy(boxes), torch.from_numpy(valid), 0.7).numpy()
    pallas = np.asarray(pallas_greedy_keep(jnp.asarray(boxes), jnp.asarray(valid), 0.7, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    if case in ("all_invalid", "no_overlap"):
        np.testing.assert_array_equal(got, valid)
    if case == "chain":  # each kept box removes its successor, which then spares the next
        np.testing.assert_array_equal(got, np.broadcast_to(np.arange(k) % 2 == 0, got.shape))


def test_wrappers_raise_off_cpu_and_cuda():
    with pytest.raises(ValueError, match="unsupported device"):
        greedy_keep(torch.zeros(1, 4, 4, device="meta"), torch.zeros(1, 4, dtype=torch.bool, device="meta"), 0.5)
    x = torch.zeros(1, 4, 4, 32, device="meta")
    w = torch.zeros(3, 3, 32, 32, device="meta")
    b = torch.zeros(32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bottleneck(x, w, b, w, b)
