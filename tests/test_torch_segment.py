"""The port's segment model and its ops against the JAX package's, on the CPU.

- The model: `yolo11n-seg.yaml` at scale n builds with JAX's leaf paths and
  shapes (through the weight bridge), JAX's info line (layers, parameters;
  GFLOPs at 640 px equal at the line's one decimal, JAX's count read from
  XLA's cost analysis of the lowered graph, within 0.5 % of the port's
  count), npr = 64, proto at a quarter of the input. A JAX variables tree
  (seeded leaves, BN statistics away from 0 and 1) carried across and back
  equals itself leaf for leaf, the transposed conv's kernel among them (the
  bridge's HWIO -> OIHW transpose, unflipped: both packages' transposed
  convs are the gradient of a conv). The head's outputs at 64 px, B = 2:
  every level's box and cls maps, the coefficients and the prototypes
  within 1e-3 abs/rel of JAX's (the detect model's tolerance,
  tests/test_torch_model.py); the bf16 copy within twice JAX's own bf16 to
  f32 distance.
- crop_masks_device (float and bool) and crop_mask: exact.
- non_max_suppression_extras: the rows (boxes, conf, cls, coefficients)
  and n_valid equal to JAX's, so the keep sets are equal.
- segmentation_loss: the items (box, seg, cls, dfl) within 1e-5 relative
  and the gradients of every box and cls map, the coefficients and the
  prototypes within 1e-5 of each one's max |g| (sums in another order; at
  least 1e-8 of the largest |g| of them all, for a map whose gradients are
  all rounding noise, 1e-22 where max_fg = 4), at
  128 px with 3 and 40 ground-truth rows (under and over max_fg = 128
  foreground anchors, the top-k cut), and max_fg = 4; overlap=False, and
  max_fg above the anchor count, raise JAX's ValueError in both.
- mask_iou within 1e-6; SegmentMetrics' results_dict (the (M) keys and the
  fitness) equal to JAX's within 1e-12.
- The RLE codec: encode equal to JAX's strings on seeded masks (empty,
  full, first pixel set), decode and area round trips, each decoding the
  other's; COCOeval(iou_type="segm") stats within 1e-12 of JAX's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.nn.tasks import SegmentationModel, build_model
from spectrogram_yolov11_torch.ops.cocoeval import COCOeval, rle_area, rle_decode, rle_encode
from spectrogram_yolov11_torch.ops.iou import mask_iou
from spectrogram_yolov11_torch.ops.losses import segmentation_loss
from spectrogram_yolov11_torch.ops.masks import crop_mask, crop_masks_device
from spectrogram_yolov11_torch.ops.metrics import SegmentMetrics
from spectrogram_yolov11_torch.ops.nms import non_max_suppression_extras
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.ops import cocoeval as jax_cocoeval
from spectrogram_yolov11_tpu.ops.iou import mask_iou as jax_mask_iou
from spectrogram_yolov11_tpu.ops.losses import crop_mask as jax_crop_mask
from spectrogram_yolov11_tpu.ops.losses import segmentation_loss as jax_segmentation_loss
from spectrogram_yolov11_tpu.ops.masks import crop_masks_device as jax_crop_masks_device
from spectrogram_yolov11_tpu.ops.metrics import SegmentMetrics as JaxSegmentMetrics
from spectrogram_yolov11_tpu.ops.nms import non_max_suppression_extras as jax_nms_extras

TOL = 1e-3
ITEMS_RTOL, GRAD_FRAC = 1e-5, 1e-5


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.fixture(scope="module")
def seg():
    """(JAX model, its seeded numpy variables, the port's model carried from them)."""
    jm = jax_build_model("yolo11n-seg.yaml", verbose=False)
    shapes = jax.eval_shape(lambda: jm.graph.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(0)

    def draw(path, s):
        if path.startswith("batch_stats"):
            return (rng.uniform(0.5, 1.5, s.shape) if path.endswith("var") else rng.normal(0, 0.1, s.shape)).astype(
                np.float32)
        if path.endswith("scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.uniform(-1, 1, s.shape) / np.sqrt(max(fan_in, 1))).astype(np.float32)

    variables = {}
    for path, s in _leaves(jax.tree_util.tree_map(lambda a: a, shapes)):
        node = variables
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = draw(path, s)
    return jm, variables, shapes, build_model("yolo11n-seg.yaml", variables=variables)


def test_builds_as_jax_and_round_trips_the_bridge(seg):
    jm, variables, shapes, tm = seg
    assert isinstance(tm, SegmentationModel) and tm.task == "segment"
    head = tm.model[-1]
    assert (head.nm, head.npr) == (32, 64) and head.proto.upsample.weight.shape == (64, 64, 2, 2)
    assert tm.stride == (8.0, 16.0, 32.0) == tuple(float(s) for s in jm.stride)
    back = dict(_leaves(state_dict_to_variables(tm.state_dict())))
    ref = dict(_leaves(variables))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    assert "params/model_23/proto/upsample/kernel" in back
    fresh = build_model("yolo11n-seg.yaml").init(0)
    assert {k: v.shape for k, v in _leaves(state_dict_to_variables(fresh.state_dict()))} == \
           {k: tuple(v.shape) for k, v in _leaves(shapes)}
    lowered = jax.jit(lambda v, x: jm.apply(v, x, train=False)).lower(
        shapes, jax.ShapeDtypeStruct((1, 640, 640, 3), jnp.float32))
    ca = lowered.cost_analysis()
    xla = float((ca[0] if isinstance(ca, (list, tuple)) else ca)["flops"]) / 1e9
    port = fresh.get_flops(640)
    print(f"GFLOPs at 640 px: port {port:.4f}, XLA {xla:.4f} ({xla / port - 1:+.2%})")
    assert abs(xla / port - 1) < 5e-3
    assert fresh.info() == jm.info(shapes, flops=False) + f", {xla:.1f} GFLOPs @ 640px"


def _apply_jax(jm, variables, x, dtype=None):
    if dtype is not None:
        jm.set_dtype(dtype)
    try:
        return jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    finally:
        jm.set_dtype(None)


def _port_out(model, x):
    with torch.inference_mode():
        feats, mc, proto = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return ([(b.permute(0, 2, 3, 1).float().numpy(), c.permute(0, 2, 3, 1).float().numpy()) for b, c in feats],
            mc.float().numpy(), proto.permute(0, 2, 3, 1).float().numpy())


def test_head_outputs_match_jax(seg):
    jm, variables, _, tm = seg
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    (rf, rmc, rp), (gf, gmc, gp) = _apply_jax(jm, variables, x), _port_out(tm, x)
    assert gmc.shape == (2, 84, 32) and gp.shape == (2, 16, 16, 32)
    for (gb, gc), (rb, rc) in zip(gf, rf):
        np.testing.assert_allclose(gb, np.asarray(rb), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(gc, np.asarray(rc), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(gmc, np.asarray(rmc), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(gp, np.asarray(rp), atol=TOL, rtol=TOL)
    # bf16: the port's copy within twice JAX's own bf16-to-f32 distance
    (jf, jmc, jp) = _apply_jax(jm, variables, x, jnp.bfloat16)
    (hf, hmc, hp) = _port_out(tm.set_dtype(torch.bfloat16), x)
    for got, ref16, ref32 in ((hmc, jmc, rmc), (hp, jp, rp), (hf[0][0], jf[0][0], rf[0][0])):
        ref16, ref32 = np.asarray(ref16, np.float32), np.asarray(ref32)
        assert np.abs(got - ref32).max() <= 2 * np.abs(ref16 - ref32).max() + 1e-6


@pytest.mark.parametrize("dtype", ["float", "bool"])
def test_crop_masks_equal_jax(dtype):
    rng = np.random.default_rng(len(dtype))
    masks = rng.normal(0, 1, (2, 5, 16, 20)).astype(np.float32)
    masks = masks > 0 if dtype == "bool" else masks
    xy = rng.uniform(-8, 70, (2, 5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 40, (2, 5, 2))], -1).astype(np.float32)
    got = crop_masks_device(torch.from_numpy(masks), torch.from_numpy(boxes), (64, 80)).numpy()
    ref = np.asarray(jax_crop_masks_device(jnp.asarray(masks), jnp.asarray(boxes), (64, 80)))
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    if dtype == "float":
        got = crop_mask(torch.from_numpy(masks), torch.from_numpy(boxes / 4)).numpy()
        assert np.array_equal(got, np.asarray(jax_crop_mask(jnp.asarray(masks), jnp.asarray(boxes / 4))))


@pytest.mark.parametrize("seed", range(3))
def test_nms_with_extras_equals_jax(seed):
    rng = np.random.default_rng(seed)
    b, a, nc, e = 2, 300, 3, 32
    xy = rng.uniform(20, 300, (b, a, 2))
    wh = rng.uniform(5, 80, (b, a, 2))
    xy[:, 100:200] = xy[:, :100] + rng.normal(0, 3, (b, 100, 2))  # overlapping pairs to suppress
    scores = rng.uniform(0, 1, (b, a, nc)) ** 3
    scores[:, :10] = 0.3  # ties
    preds = np.concatenate([xy, wh, scores, rng.normal(0, 1, (b, a, e))], -1).astype(np.float32)
    kw = dict(conf_thres=0.05, iou_thres=0.6, nc=nc, max_det=100, pre_nms_topk=256)
    out, nv = non_max_suppression_extras(torch.from_numpy(preds), **kw)
    ref_out, ref_nv = jax_nms_extras(jnp.asarray(preds), **kw)
    assert out.shape == (b, 100, 6 + e) and nv.tolist() == np.asarray(ref_nv).tolist() and nv.min() > 10
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))


def _seg_inputs(rng, g: int):
    sizes = [(16, 16), (8, 8), (4, 4)]
    boxes = [rng.normal(0, 2, (2, 64, h, w)).astype(np.float32) for h, w in sizes]
    scores = [rng.normal(-2, 2, (2, 2, h, w)).astype(np.float32) for h, w in sizes]
    coeffs = rng.normal(0, 1, (2, 336, 8)).astype(np.float32)
    proto = rng.normal(0, 1, (2, 8, 32, 32)).astype(np.float32)
    cls = rng.integers(0, 2, (2, g)).astype(np.int32)
    xy, wh = rng.uniform(0.2, 0.8, (2, g, 2)), rng.uniform(0.1, 0.5, (2, g, 2))
    bboxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.arange(g)[None] < np.array([[g], [max(g // 2, 1)]])
    bboxes[~mask], cls[~mask] = 0, 0
    gt_masks = rng.integers(0, g + 1, (2, 32, 32)).astype(np.int32)
    return boxes, scores, coeffs, proto, cls, bboxes, mask, gt_masks


@pytest.mark.parametrize("g,max_fg", [(3, 128), (40, 128), (6, 4)], ids=["few_gt", "many_gt", "max_fg_4"])
def test_segmentation_loss_and_its_gradient_equal_jax(g, max_fg):
    rng = np.random.default_rng(g)
    boxes, scores, coeffs, proto, cls, bboxes, mask, gt_masks = _seg_inputs(rng, g)
    kw = dict(nc=2, imgsz=128, strides=(8.0, 16.0, 32.0), max_fg=max_fg)

    def jax_total(args):
        maps, mc, pr = args
        feats = [(jnp.transpose(bx, (0, 2, 3, 1)), jnp.transpose(sc, (0, 2, 3, 1))) for bx, sc in maps]
        return jax_segmentation_loss(feats, mc, jnp.transpose(pr, (0, 2, 3, 1)), jnp.asarray(cls),
                                     jnp.asarray(bboxes), jnp.asarray(mask), jnp.asarray(gt_masks), **kw)

    (ref_total, ref_items), ref_grads = jax.value_and_grad(jax_total, has_aux=True)(
        ([(jnp.asarray(bx), jnp.asarray(sc)) for bx, sc in zip(boxes, scores)], jnp.asarray(coeffs), jnp.asarray(proto)))
    maps = [(torch.from_numpy(bx).requires_grad_(), torch.from_numpy(sc).requires_grad_()) for bx, sc in zip(boxes, scores)]
    mc, pr = torch.from_numpy(coeffs).requires_grad_(), torch.from_numpy(proto).requires_grad_()
    total, items = segmentation_loss(maps, mc, pr, torch.from_numpy(cls), torch.from_numpy(bboxes),
                                     torch.from_numpy(mask), torch.from_numpy(gt_masks), **kw)
    total.backward()
    print(f"g {g}: items {items.tolist()} (JAX {np.asarray(ref_items).tolist()})")
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=ITEMS_RTOL, atol=0)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=ITEMS_RTOL)
    assert items.shape == (4,) and (items > 0).all() and not items.requires_grad
    ref_maps, ref_mc, ref_pr = ref_grads
    pairs = [(t.grad, np.asarray(r)) for (gb, gs), (rb, rs) in zip(maps, ref_maps) for t, r in ((gb, rb), (gs, rs))]
    pairs += [(mc.grad, np.asarray(ref_mc)), (pr.grad, np.asarray(ref_pr))]
    floor = 1e-3 * max(np.abs(r).max() for _, r in pairs)  # a map whose gradients are all rounding noise
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), ref, atol=GRAD_FRAC * max(np.abs(ref).max(), floor), rtol=0)
    assert np.abs(np.asarray(ref_mc)).max() > 0 and np.abs(np.asarray(ref_pr)).max() > 0  # the mask term reaches both


def test_overlap_false_raises_as_jax():
    boxes, scores, coeffs, proto, cls, bboxes, mask, gt_masks = _seg_inputs(np.random.default_rng(0), 3)
    feats = [(jnp.transpose(jnp.asarray(bx), (0, 2, 3, 1)), jnp.transpose(jnp.asarray(sc), (0, 2, 3, 1)))
             for bx, sc in zip(boxes, scores)]
    with pytest.raises(ValueError, match="same number of dimensions") as ref:
        jax_segmentation_loss(feats, jnp.asarray(coeffs), jnp.transpose(jnp.asarray(proto), (0, 2, 3, 1)),
                              jnp.asarray(cls), jnp.asarray(bboxes), jnp.asarray(mask), jnp.asarray(gt_masks), nc=2,
                              imgsz=128, overlap=False)
    with pytest.raises(ValueError) as got:
        segmentation_loss([(torch.from_numpy(bx), torch.from_numpy(sc)) for bx, sc in zip(boxes, scores)],
                          torch.from_numpy(coeffs), torch.from_numpy(proto), torch.from_numpy(cls),
                          torch.from_numpy(bboxes), torch.from_numpy(mask), torch.from_numpy(gt_masks), nc=2,
                          imgsz=128, overlap=False)
    assert str(got.value) == str(ref.value)
    small = [(torch.from_numpy(bx[..., :n, :n]), torch.from_numpy(sc[..., :n, :n]))
             for bx, sc, n in zip(boxes, scores, (8, 4, 2))]
    with pytest.raises(ValueError, match="k=128 with shape=\\[2, 84\\]"):  # an image under 80 px, as JAX's top_k
        segmentation_loss(small, torch.from_numpy(coeffs[:, :84]), torch.from_numpy(proto), torch.from_numpy(cls),
                          torch.from_numpy(bboxes), torch.from_numpy(mask), torch.from_numpy(gt_masks), nc=2, imgsz=64)


def test_mask_iou_and_segment_metrics_equal_jax():
    rng = np.random.default_rng(0)
    m1, m2 = rng.uniform(0, 1, (7, 400)) > 0.6, rng.uniform(0, 1, (9, 400)) > 0.5
    m2[:3] = m1[:3]
    np.testing.assert_allclose(mask_iou(torch.from_numpy(m1), torch.from_numpy(m2)).numpy(),
                               np.asarray(jax_mask_iou(jnp.asarray(m1), jnp.asarray(m2))), atol=1e-6, rtol=1e-6)
    n, names = 200, {0: "a", 1: "b", 2: "c"}
    tp, tp_m = rng.uniform(0, 1, (n, 10)) > 0.4, rng.uniform(0, 1, (n, 10)) > 0.5
    conf, pred_cls = rng.uniform(0, 1, n), rng.integers(0, 3, n).astype(float)
    target_cls = rng.integers(0, 3, 150).astype(float)
    ours, theirs = SegmentMetrics(names), JaxSegmentMetrics(names)
    for m in (ours, theirs):
        m.process(tp, conf, pred_cls, target_cls, tp_m=tp_m)
    assert list(ours.results_dict) == list(theirs.results_dict) and len(ours.results_dict) == 9
    assert "metrics/mAP50-95(M)" in ours.results_dict
    for k, v in ours.results_dict.items():
        assert abs(v - theirs.results_dict[k]) <= 1e-12, k
    assert ours.fitness == pytest.approx(theirs.fitness, abs=1e-12)


def _masks(rng: np.random.Generator, n: int, h: int = 23, w: int = 17) -> list:
    out = [np.zeros((h, w), bool), np.ones((h, w), bool)]
    for i in range(n):
        m = np.zeros((h, w), bool)
        y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
        m[y0 : y0 + rng.integers(2, h - y0), x0 : x0 + rng.integers(2, w - x0)] = True
        m ^= rng.uniform(0, 1, (h, w)) > 0.9
        if i % 3 == 0:
            m[0, 0] = True
        out.append(m)
    return out


def test_rle_codec_equals_jax():
    rng = np.random.default_rng(0)
    for m in _masks(rng, 30):
        ours, theirs = rle_encode(m), jax_cocoeval.rle_encode(m)
        assert ours == theirs
        assert np.array_equal(rle_decode(ours), m) and np.array_equal(jax_cocoeval.rle_decode(ours), m)
        assert rle_area(ours) == jax_cocoeval.rle_area(theirs) == float(m.sum())
    with pytest.raises(ValueError, match="RLE decodes"):
        rle_decode({"size": [4, 4], "counts": [3, 2]})


@pytest.mark.parametrize("seed", range(3))
def test_segm_cocoeval_equals_jax(seed):
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for img in range(4):
        for j, m in enumerate(_masks(rng, 6, 40, 48)[2:]):
            cat = int(rng.integers(0, 2))
            ys, xs = np.nonzero(m)
            box = [float(xs.min()), float(ys.min()), float(np.ptp(xs) + 1), float(np.ptp(ys) + 1)]
            gts.append({"image_id": img, "category_id": cat, "bbox": box, "iscrowd": int(j == 5),
                        "segmentation": rle_encode(m)})
            for _ in range(int(rng.integers(0, 3))):
                d = m ^ (rng.uniform(0, 1, m.shape) > 0.85)
                dts.append({"image_id": img, "category_id": cat if rng.uniform() < 0.8 else 1 - cat, "bbox": box,
                            "score": float(rng.uniform()), "segmentation": rle_encode(d)})
    ours = COCOeval(gts, dts, iou_type="segm").evaluate().stats
    theirs = jax_cocoeval.COCOeval(gts, dts, iou_type="segm").evaluate().stats
    assert list(ours) == list(theirs) and len(ours) == 12
    for k, v in ours.items():
        assert abs(v - theirs[k]) <= 1e-12, (k, v, theirs[k])
    assert ours["AP50"] > 0
    with pytest.raises(NotImplementedError, match="item 10"):  # keypoints run since the pose task
        COCOeval(gts, dts, iou_type="obb")  # (tests/test_torch_pose.py)
