"""The port's letterbox (data/augment.py) and scale_boxes against the JAX package.

The JAX predictor letterboxes with the native library (native/preprocess.cpp,
NativeBatchLetterbox) whenever it builds, and with cv2 INTER_LINEAR
(data/augment.py:letterbox) otherwise. The port repeats the native
fixed-point arithmetic, so against the library it is held exactly; cv2 rounds
where the native code truncates and keeps 11-bit weights, so against it the
tolerance is 1 grey level, on smooth spectrogram frames.
"""

import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_tpu.data.augment import letterbox as jax_letterbox
from spectrogram_yolov11_tpu.ops.boxes import scale_boxes as jax_scale_boxes
from spectrogram_yolov11_tpu.utils.native import NativeBatchLetterbox, load_native
from spectrogram_yolov11_torch.data.augment import letterbox_batch, letterbox_geometry
from spectrogram_yolov11_torch.data.synth import synth_frames
from spectrogram_yolov11_torch.ops.boxes import scale_boxes

CPU = torch.device("cpu")
# (h, w) of each frame: downsampled, upsampled, odd, same size, extreme aspect
SIZES = {
    "down": [(360, 640), (720, 1280), (720, 1280)],
    "up": [(37, 53), (60, 40), (1, 5)],
    "odd": [(500, 333), (95, 97), (641, 640)],
    "same": [(96, 96), (54, 96)],
    "thin": [(2000, 17), (13, 900)],
}


def _frames(sizes, seed, gray=False):
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    return [np.repeat(f[..., :1], 3, -1) for f in frames] if gray else frames


@pytest.mark.parametrize("imgsz", [96, 320])
@pytest.mark.parametrize("case", sorted(SIZES))
def test_letterbox_equals_native(case, imgsz):
    if load_native() is None:
        pytest.skip("native/libsytnative.so does not build here; the cv2 comparison below still runs")
    frames = _frames(SIZES[case], seed=len(case) + imgsz)
    ref, _ = NativeBatchLetterbox(len(frames), imgsz)(frames)
    got = letterbox_batch(frames, imgsz, CPU)
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gray_frames_go_up_as_one_channel():
    """A gray batch letterboxes to one channel equal to each native plane; one
    colour frame makes the batch three-channel, and a 1-channel or 2-D frame in
    it is broadcast."""
    if load_native() is None:
        pytest.skip("native/libsytnative.so does not build here")
    gray = _frames(SIZES["down"] + SIZES["odd"], seed=1, gray=True)
    ref, _ = NativeBatchLetterbox(len(gray), 96)(gray)
    got = letterbox_batch([gray[0][..., :1], gray[1][..., 0]] + gray[2:], 96, CPU)
    assert got.shape[-1] == 1
    np.testing.assert_array_equal(np.repeat(got.numpy(), 3, -1), ref)

    mixed = gray[:2] + _frames([(40, 70)], seed=2)
    ref, _ = NativeBatchLetterbox(len(mixed), 96)(mixed)
    got = letterbox_batch([mixed[0][..., :1], mixed[1][..., 0], mixed[2]], 96, CPU, gray_state=[None])
    assert got.shape[-1] == 3
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hw", [(360, 640), (720, 1280), (500, 333), (60, 40), (95, 97)])
def test_letterbox_within_one_grey_level_of_cv2(hw):
    frame = np.repeat(synth_frames(1, *hw, seed=sum(hw))[0], 3, -1)
    ref, _, _ = jax_letterbox(frame, (96, 96))
    got = letterbox_batch([frame], 96, CPU)[0].numpy()
    assert np.abs(got.astype(np.int16) - ref).max() <= 1


@pytest.mark.parametrize("hw", [(360, 640), (720, 1280), (500, 333), (37, 53), (641, 640)])
def test_scale_boxes_round_trip(hw):
    """Boxes in original pixels, mapped into the letterboxed frame by its own
    geometry and back by scale_boxes (which recomputes the pad from the gain),
    land within a pixel of the letterbox scale; scale_boxes equals the JAX one."""
    imgsz = 96
    h, w = hw
    rng = np.random.default_rng(h * w)
    xy = rng.uniform(0, 1, (20, 2)) * [w, h]
    wh = rng.uniform(0.05, 0.5, (20, 2)) * [w, h]
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2, rng.uniform(0.3, 1, (20, 1)), rng.integers(0, 2, (20, 1))], 1)
    boxes[:, :4] = boxes[:, :4].clip(0, [w, h, w, h])
    nh, nw, top, left = letterbox_geometry(imgsz, hw)
    lb = boxes.astype(np.float32).copy()
    lb[:, [0, 2]] = lb[:, [0, 2]] * (nw / w) + left
    lb[:, [1, 3]] = lb[:, [1, 3]] * (nh / h) + top
    got = scale_boxes((imgsz, imgsz), lb, hw)
    np.testing.assert_array_equal(got, jax_scale_boxes((imgsz, imgsz), lb, hw))
    gain = min(imgsz / h, imgsz / w)
    np.testing.assert_allclose(got[:, :4], boxes[:, :4], atol=1.0 / gain + 1e-3, rtol=0)
    np.testing.assert_array_equal(got[:, 4:], lb[:, 4:])
