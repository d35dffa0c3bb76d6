"""The port's on-card image augmentation against the JAX package's, on the CPU.

spectrogram_yolov11_torch/ops/device_augment.py:augment_batch assembles a
train batch's images from the tiles and parameters the host's TrainTransform
draws. Its inputs here are JAX's own: TrainTransform(device_mode=True) over
a small in-memory dataset of colour images of ragged sizes (so the hue path
of the HSV jitter runs), at 64 px, seeds 0-5, as a batch of 6.

- Separable warps (the default hyps: degrees = shear = perspective = 0, with
  mosaic, flips and HSV on): equal to jax.vmap(_augment_one), the exact
  general form, and to jax.vmap(_augment_one_separable_gather), both run op by
  op as the JAX package's own tests run them.
- Non-separable warps (degrees 10, shear 3, perspective 5e-4, flipud 0.5):
  equal to jax.vmap(_augment_one).
- Against JAX's production form, augment_batch(..., separable=True) (bf16
  matmuls with Dekker-split operands), within the bounds
  tests/test_device_augment.py::test_separable_matmul_vs_gather_oracle holds
  it to its gather oracle: under 1 % of values unequal, none off by more
  than 8 (HSV gains neutral, as there).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.ops.device_augment import augment_batch
from spectrogram_yolov11_tpu.data.augment import TrainTransform as JaxTrainTransform
from spectrogram_yolov11_tpu.ops.device_augment import _augment_one, _augment_one_separable_gather
from spectrogram_yolov11_tpu.ops.device_augment import augment_batch as jax_augment_batch

S, SEEDS = 64, range(6)
KEYS = ("aug_src", "aug_regions", "aug_pads", "aug_inv", "aug_hsv")


class _ColourDS:
    """Colour images of ragged sizes with a few boxes each; load_sample resizes
    the long side to `square_to` by nearest-neighbour (any resize serves: the
    tiles are inputs here)."""

    def __init__(self, n: int = 6):
        rng = np.random.default_rng(0)
        self.items = []
        for _ in range(n):
            h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
            img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            img[: h // 2, : w // 2] = rng.integers(0, 256, 3)  # a flat patch: equal channels nowhere, hue steady
            nb = int(rng.integers(1, 4))
            cx, cy = rng.uniform(0.3, 0.7, nb), rng.uniform(0.3, 0.7, nb)
            bw, bh = rng.uniform(0.2, 0.4, nb), rng.uniform(0.2, 0.4, nb)
            b = np.stack([(cx - bw / 2) * w, (cy - bh / 2) * h, (cx + bw / 2) * w, (cy + bh / 2) * h], 1)
            self.items.append((img, b.astype(np.float32), rng.integers(0, 2, nb).astype(np.int32)))

    def __len__(self):
        return len(self.items)

    def load_sample(self, i, square_to=None):
        img, b, c = self.items[i]
        h0, w0 = img.shape[:2]
        r = square_to / max(h0, w0)
        h, w = min(int(h0 * r), square_to), min(int(w0 * r), square_to)
        img = img[(np.arange(h) * h0 // h)[:, None], np.arange(w) * w0 // w]
        return {"img": img, "cls": c.copy(), "bboxes": b * np.float32(r), "ori_shape": (h0, w0)}


def _hyp(**kw):
    base = dict(mosaic=1.0, mixup=0.0, copy_paste=0.0, degrees=0.0, translate=0.1, scale=0.5, shear=0.0,
                perspective=0.0, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, fliplr=0.5, flipud=0.0)
    return SimpleNamespace(**{**base, **kw})


def _params(hyp, close_mosaic_after: int = 4):
    """JAX's device-mode parameters for SEEDS as one batch; the last samples
    after close_mosaic(), so the single-tile path is in every batch."""
    ds = _ColourDS()
    t = JaxTrainTransform(ds, S, hyp, max_gt=32, device_mode=True)
    out = []
    for seed in SEEDS:
        if seed == close_mosaic_after:
            t.close_mosaic()
        out.append(t(seed % len(ds), np.random.default_rng(seed)))
    return tuple(np.stack([o[k] for o in out]) for k in KEYS)


def _port(args):
    with torch.no_grad():
        return augment_batch(*(torch.from_numpy(a) for a in args)).numpy()


@pytest.fixture(scope="module")
def separable():
    return _params(_hyp(flipud=0.5))


@pytest.fixture(scope="module")
def general():
    return _params(_hyp(degrees=10.0, shear=3.0, perspective=5e-4, flipud=0.5))


def test_separable_equals_the_exact_forms(separable):
    got = _port(separable)
    assert got.shape == (len(SEEDS), S, S, 3) and got.dtype == np.float32
    assert np.array_equal(got, np.round(got)) and got.min() >= 0 and got.max() <= 255
    assert np.abs(separable[3][:, [0, 1], [1, 0]]).max() == 0  # axis-aligned, as the default hyps give
    assert np.array_equal(got, np.asarray(jax.vmap(_augment_one)(*separable)))
    assert np.array_equal(got, np.asarray(jax.vmap(_augment_one_separable_gather)(*separable)))


def test_general_warp_equals_augment_one(general):
    assert np.abs(general[3][:, [0, 1], [1, 0]]).min() > 0  # rotated and sheared
    assert np.abs(general[3][:, 2, :2]).max() > 0  # and in perspective
    got = _port(general)
    ref = np.asarray(jax.vmap(_augment_one)(*general))
    assert np.array_equal(got, ref)


def test_within_the_production_forms_bounds():
    args = _params(_hyp(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0))
    got = _port(args)
    ref = np.asarray(jax_augment_batch(*args, separable=True))
    d = np.abs(got.astype(np.float64) - ref)
    print(f"against the bf16 matmul form: {(d > 0).mean():.4%} of values unequal, max {d.max()}")
    assert (d > 0).mean() < 0.01 and d.max() <= 8.0
