"""The port's detect loss against the JAX package's, f32 on the CPU.

Inputs come from a seed through numpy. bbox_iou in every mode (IoU, GIoU,
DIoU, CIoU; xywh and xyxy) and its gradient; the DFL loss and the BCE with
logits; preprocess_targets; and detection_loss on random head logits of a
64 px image (3 levels, nc = 2, reg_max 16) with padded GT rows: the loss
items and the gradient with respect to every level's box and cls logits.

Tolerances: 1e-6 abs + 1e-6 rel for the elementwise functions (the same
operations in the same order, up to the last bit of atan and log1p); the
loss items within 1e-5 relative and the logits' gradients within 1e-5 of
each map's max |g| (sums over 84 anchors and 2 classes in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.ops.iou import bbox_iou
from spectrogram_yolov11_torch.ops.losses import bce_logits, detection_loss, df_loss, preprocess_targets
from spectrogram_yolov11_tpu.ops.iou import bbox_iou as jax_bbox_iou
from spectrogram_yolov11_tpu.ops.losses import _bce_logits as jax_bce_logits
from spectrogram_yolov11_tpu.ops.losses import detection_loss as jax_detection_loss
from spectrogram_yolov11_tpu.ops.losses import df_loss as jax_df_loss
from spectrogram_yolov11_tpu.ops.losses import preprocess_targets as jax_preprocess_targets

TOL = dict(atol=1e-6, rtol=1e-6)
ITEMS_RTOL, GRAD_FRAC = 1e-5, 1e-5
MODES = {"iou": {}, "giou": {"GIoU": True}, "diou": {"DIoU": True}, "ciou": {"CIoU": True}}


def _boxes(rng, n, xywh):
    xy, wh = rng.uniform(5, 60, (n, 2)), rng.uniform(0.5, 30, (n, 2))
    b = np.concatenate([xy, wh] if xywh else [xy - wh / 2, xy + wh / 2], -1)
    return b.astype(np.float32)


@pytest.mark.parametrize("xywh", [True, False], ids=["xywh", "xyxy"])
@pytest.mark.parametrize("mode", list(MODES))
def test_bbox_iou_and_its_gradient_equal_jax(mode, xywh):
    rng = np.random.default_rng(len(mode) + xywh)
    b1, b2 = _boxes(rng, 64, xywh), _boxes(rng, 64, xywh)
    b2[:8] = b1[:8]  # identical pairs
    kw = dict(xywh=xywh, **MODES[mode])
    ref, ref_grad = jax.value_and_grad(lambda a: jax_bbox_iou(a, jnp.asarray(b2), **kw).sum())(jnp.asarray(b1))
    t1 = torch.from_numpy(b1).requires_grad_()
    got = bbox_iou(t1, torch.from_numpy(b2), **kw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy().sum(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(bbox_iou(torch.from_numpy(b1), torch.from_numpy(b2), **kw).numpy(),
                               np.asarray(jax_bbox_iou(jnp.asarray(b1), jnp.asarray(b2), **kw)), **TOL)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(ref_grad), atol=1e-5, rtol=1e-5)


def test_dfl_bce_and_targets_equal_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (3, 7, 4, 16)).astype(np.float32)
    target = rng.uniform(0, 14.99, (3, 7, 4)).astype(np.float32)
    target[0, 0] = [0.0, 14.99, 3.0, 7.5]  # the clamp's edges and whole bins
    np.testing.assert_allclose(df_loss(torch.from_numpy(logits), torch.from_numpy(target)).numpy(),
                               np.asarray(jax_df_loss(jnp.asarray(logits), jnp.asarray(target))), **TOL)
    x, y = rng.normal(0, 5, (50,)).astype(np.float32), rng.uniform(0, 1, (50,)).astype(np.float32)
    np.testing.assert_allclose(bce_logits(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(jax_bce_logits(jnp.asarray(x), jnp.asarray(y))), **TOL)
    cls, bboxes, mask = _gt(rng)
    for g, r in zip(preprocess_targets(torch.from_numpy(cls), torch.from_numpy(bboxes), torch.from_numpy(mask), 64.0),
                    jax_preprocess_targets(jnp.asarray(cls), jnp.asarray(bboxes), jnp.asarray(mask), 64.0)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _gt(rng, b=2, g=6):
    cls = rng.integers(0, 2, (b, g)).astype(np.int32)
    xy, wh = rng.uniform(0.2, 0.8, (b, g, 2)), rng.uniform(0.05, 0.5, (b, g, 2))
    bboxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.arange(g)[None] < np.array([[4], [2]])
    bboxes[~mask], cls[~mask] = 0, 0
    return cls, bboxes, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_loss_and_its_gradient_equal_jax(seed):
    rng = np.random.default_rng(seed)
    sizes = [(8, 8), (4, 4), (2, 2)]
    boxes = [rng.normal(0, 2, (2, 64, h, w)).astype(np.float32) for h, w in sizes]
    scores = [rng.normal(-2, 2, (2, 2, h, w)).astype(np.float32) for h, w in sizes]
    cls, bboxes, mask = _gt(rng)
    kw = dict(nc=2, imgsz=64, strides=(8.0, 16.0, 32.0))

    def jax_total(maps):
        feats = [(jnp.transpose(bx, (0, 2, 3, 1)), jnp.transpose(sc, (0, 2, 3, 1))) for bx, sc in maps]
        total, items = jax_detection_loss(feats, jnp.asarray(cls), jnp.asarray(bboxes), jnp.asarray(mask), **kw)
        return total, items

    (ref_total, ref_items), ref_grads = jax.value_and_grad(jax_total, has_aux=True)(
        [(jnp.asarray(bx), jnp.asarray(sc)) for bx, sc in zip(boxes, scores)])
    maps = [(torch.from_numpy(bx).requires_grad_(), torch.from_numpy(sc).requires_grad_()) for bx, sc in zip(boxes, scores)]
    total, items = detection_loss(maps, torch.from_numpy(cls), torch.from_numpy(bboxes), torch.from_numpy(mask), **kw)
    total.backward()
    print(f"seed {seed}: items {items.tolist()} (JAX {np.asarray(ref_items).tolist()})")
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=ITEMS_RTOL, atol=0)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=ITEMS_RTOL)
    assert not items.requires_grad and (items > 0).all()
    for (gb, gs), (rb, rs) in zip(maps, ref_grads):
        for got, ref in ((gb.grad, rb), (gs.grad, rs)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, atol=GRAD_FRAC * np.abs(ref).max(), rtol=0)
