"""The port's OBB model and its ops against the JAX package's, on the CPU.

- The model: `yolo11n-obb.yaml` at scale n (nc 2, as the trainer rebuilds
  it for shapes128-obb; the angle branches c4 = 16 wide) builds with JAX's
  leaf paths and shapes (through the weight
  bridge); a JAX variables tree (seeded leaves, BN statistics away from 0
  and 1) carried across and back equals itself leaf for leaf, the angle
  branches `model_23/cv4_{i}_{j}` and the nested `model_23/detect/...`
  among them, and the optimizer state crosses both ways (tree and flat
  forms). The whole forward at 64 px, B = 2: every level's box and cls maps
  and the raw angles within 1e-5 of each output's max |value|. The OBB head
  alone on seeded maps at narrow widths (ch 16, 32, 64), the same.
- probiou (with and without CIoU) and batch_probiou, their values within
  1e-5 relative (on pairs half a pixel apart and further: at identical
  boxes the value is the ill-conditioned 1 - sqrt(eps + tiny), which JAX's
  jit rounds 2e-5 lower than its own eager form and the port, ROADMAP.md
  §3.40) and the gradient of probiou within 1e-5 of its max |g|; dist2rbox
  and decode_obb within 1e-5 relative.
- The rotated assigner (task_aligned_assign(rotated=True): the rotated
  point-in-box test, probiou overlaps): the labels, fg mask and GT index
  equal, the target boxes and scores within 1e-5.
- obb_loss: the items (box, cls, dfl) within 1e-5 relative and the
  gradients (to every box and cls map and to the raw angles) within 1e-5 of
  each one's max |g|, on ground truth with padded rows, at nc 1 and 3.
- nms_rotated equal to JAX's on seeded predictions with tied scores, at
  pre_nms_topk below and above the anchor count and max_det below and above k.
- OBBMetrics' results_dict and fitness equal to JAX's; the rotated-box
  helpers (regularize_rboxes, xywhr2xyxyxyxy) within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pose import _close, _leaves, _seeded
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.nn.modules import OBB
from spectrogram_yolov11_torch.nn.tasks import OBBModel, build_model, yaml_model_load
from spectrogram_yolov11_torch.ops.boxes import regularize_rboxes, xywhr2xyxyxyxy
from spectrogram_yolov11_torch.ops.decode import decode_obb, dist2rbox, make_anchors
from spectrogram_yolov11_torch.ops.iou import batch_probiou, probiou
from spectrogram_yolov11_torch.ops.losses import obb_loss
from spectrogram_yolov11_torch.ops.metrics import OBBMetrics
from spectrogram_yolov11_torch.ops.nms import nms_rotated
from spectrogram_yolov11_torch.ops.tal import task_aligned_assign
from spectrogram_yolov11_torch.utils.jax_compat import (opt_state_from_flax, opt_state_to_flax,
                                                        state_dict_to_variables, variables_to_state_dict)
from spectrogram_yolov11_tpu.engine.optim import flatten_tree
from spectrogram_yolov11_tpu.nn.modules.head import OBB as JaxOBB
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.ops import boxes as jax_boxes
from spectrogram_yolov11_tpu.ops.decode import decode_obb as jax_decode_obb
from spectrogram_yolov11_tpu.ops.decode import dist2rbox as jax_dist2rbox
from spectrogram_yolov11_tpu.ops.iou import batch_probiou as jax_batch_probiou
from spectrogram_yolov11_tpu.ops.iou import probiou as jax_probiou
from spectrogram_yolov11_tpu.ops.losses import obb_loss as jax_obb_loss
from spectrogram_yolov11_tpu.ops.metrics import OBBMetrics as JaxOBBMetrics
from spectrogram_yolov11_tpu.ops.nms import nms_rotated as jax_nms_rotated
from spectrogram_yolov11_tpu.ops.tal import task_aligned_assign as jax_assign

REL = 1e-5  # of each output's (or gradient's) max |value|
SHAPES, STRIDES = [(16, 16), (8, 8), (4, 4)], (8.0, 16.0, 32.0)


@functools.lru_cache(maxsize=None)
def jax_obb(nc: int = 2) -> tuple:
    """(the model dict, JAX's yolo11n-obb at nc, its init's shapes), built once per process: the engine tests'
    train step (tests/test_torch_obb_engine.py) takes the same JAX model."""
    d = {k: v for k, v in yaml_model_load("yolo11n-obb.yaml").items() if k != "yaml_file"}
    d["nc"] = nc
    jm = jax_build_model(dict(d), verbose=False)
    shapes = jax.eval_shape(lambda: jm.graph.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    return d, jm, shapes


@pytest.fixture(scope="module")
def obb_model():
    """(JAX model, its init's shapes, seeded numpy variables, the port's model carried from them)."""
    d, jm, shapes = jax_obb()
    variables = _seeded(shapes)
    return jm, shapes, variables, build_model(dict(d), variables=variables)


def test_builds_as_jax_and_round_trips_the_bridge(obb_model):
    jm, shapes, variables, tm = obb_model
    assert isinstance(tm, OBBModel) and tm.task == "obb" and tm.nc == 2
    head = tm.model[-1]
    assert isinstance(head, OBB) and head.cv4[0][0].conv.out_channels == 64 // 4 and head.cv4[2][2].out_channels == 1
    assert tm.stride == (8.0, 16.0, 32.0) == tuple(float(s) for s in jm.stride)
    back = dict(_leaves(state_dict_to_variables(tm.state_dict())))
    ref = dict(_leaves(variables))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    assert "params/model_23/cv4_0_2/kernel" in back and "params/model_23/detect/cv3_2_2/bias" in back
    names, params = zip(*tm.named_parameters())
    g = torch.Generator().manual_seed(1)
    mu, nu = [torch.randn(p.shape, generator=g) for p in params], [torch.rand(p.shape, generator=g) for p in params]
    tree = opt_state_to_flax(3, names, mu, nu)
    assert {k: v.shape for k, v in _leaves(tree["mu"])} == {k[len("params/"):]: tuple(v.shape)
                                                           for k, v in _leaves(shapes) if k.startswith("params/")}
    for form in (tree, {"step": tree["step"], "mu": np.asarray(flatten_tree(tree["mu"])),
                        "nu": np.asarray(flatten_tree(tree["nu"]))}):
        step, mu2, nu2 = opt_state_from_flax(form, names, params)
        assert step == 3 and all(torch.equal(a, b) for a, b in zip(mu + nu, mu2 + nu2))


def test_forward_matches_jax(obb_model):
    jm, _, variables, tm = obb_model
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    rf, ra = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.inference_mode():
        gf, ga = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert ga.shape == (2, 84, 1)
    _close(ga, ra, "angles")
    for i, ((gb, gc), (rb, rc)) in enumerate(zip(gf, rf)):
        _close(gb.permute(0, 2, 3, 1), rb, f"box {i}")
        _close(gc.permute(0, 2, 3, 1), rc, f"cls {i}")


def test_obb_head_alone_matches_jax():
    ne, ch = 1, (16, 32, 64)
    rng = np.random.default_rng(ne)
    xs = [rng.normal(0, 1, (2, 8 // 2**i, 8 // 2**i, c)).astype(np.float32) for i, c in enumerate(ch)]
    jh = JaxOBB(nc=2, ne=ne, ch=ch, legacy=False)
    shapes = jax.eval_shape(lambda: jh.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs]))
    variables = _seeded(shapes, seed=ne)
    th = OBB(2, ne, ch)
    th.load_state_dict(variables_to_state_dict(variables), strict=True)
    rf, ra = jax.jit(lambda v, a: jh.apply(v, a))(variables, [jnp.asarray(x) for x in xs])
    with torch.inference_mode():
        gf, ga = th.eval()([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    assert th.cv4[0][0].conv.out_channels == max(16 // 4, ne) and ga.shape == (2, 84, ne)
    _close(ga, ra, "angles")
    for (gb, gc), (rb, rc) in zip(gf, rf):
        _close(gb.permute(0, 2, 3, 1), rb, "box")
        _close(gc.permute(0, 2, 3, 1), rc, "cls")


# -- probiou, decode and the rotated-box helpers ------------------------------------

def _rboxes(rng: np.random.Generator, n: int) -> np.ndarray:
    return np.concatenate([rng.uniform(0, 60, (n, 2)), rng.uniform(2, 30, (n, 2)), rng.uniform(-2, 2, (n, 1))],
                          -1).astype(np.float32)


@pytest.mark.parametrize("ciou", [False, True])
def test_probiou_and_its_gradient_equal_jax(ciou):
    rng = np.random.default_rng(int(ciou))
    a = _rboxes(rng, 40)
    b = (a + rng.normal(0, [3, 3, 2, 2, 0.3], a.shape)).astype(np.float32)
    b[:, 2:4] = np.abs(b[:, 2:4]) + 1
    b[:8] = a[:8] + np.float32(0.5)  # near pairs: probiou near 1
    cot = rng.normal(0, 1, 40).astype(np.float32)

    @jax.jit
    def ref_fn(p, c):
        v, vjp = jax.vjp(lambda q: jax_probiou(q, jnp.asarray(b), CIoU=ciou), p)
        return v, vjp(c)[0]

    ref, ref_g = ref_fn(jnp.asarray(a), jnp.asarray(cot))
    t = torch.from_numpy(a).requires_grad_()
    got = probiou(t, torch.from_numpy(b), CIoU=ciou)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=REL, atol=1e-6)
    _close(t.grad, ref_g, "gradient")
    assert got.max() > 0.9 and got.min() < 0.5


def test_batch_probiou_equals_jax():
    rng = np.random.default_rng(3)
    a, b = _rboxes(rng, 30), _rboxes(rng, 45)
    got = batch_probiou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jax.jit(jax_batch_probiou)(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (30, 45)
    np.testing.assert_allclose(got, ref, rtol=REL, atol=1e-6)


def test_dist2rbox_and_decode_obb_equal_jax():
    rng = np.random.default_rng(4)
    dist = rng.uniform(0, 8, (2, 336, 4)).astype(np.float32)
    ang = rng.uniform(-0.8, 2.4, (2, 336, 1)).astype(np.float32)
    anchors, _ = make_anchors(SHAPES, STRIDES)
    got = dist2rbox(torch.from_numpy(dist), torch.from_numpy(ang), anchors[None]).numpy()
    ref = np.asarray(jax_dist2rbox(jnp.asarray(dist), jnp.asarray(ang), jnp.asarray(anchors.numpy())[None]))
    np.testing.assert_allclose(got, ref, rtol=REL, atol=1e-5)
    boxes = [rng.normal(0, 2, (2, 64, h, w)).astype(np.float32) for h, w in SHAPES]
    scores = [rng.normal(-2, 2, (2, 3, h, w)).astype(np.float32) for h, w in SHAPES]
    raw = rng.normal(0, 1, (2, 336, 1)).astype(np.float32)
    got = decode_obb([(torch.from_numpy(bx), torch.from_numpy(sc)) for bx, sc in zip(boxes, scores)],
                     torch.from_numpy(raw), 3, STRIDES).numpy()
    feats = [(jnp.transpose(bx, (0, 2, 3, 1)), jnp.transpose(sc, (0, 2, 3, 1))) for bx, sc in zip(boxes, scores)]
    ref = np.asarray(jax.jit(lambda f, r: jax_decode_obb(f, r, 3, STRIDES))(feats, jnp.asarray(raw)))
    assert got.shape == (2, 336, 8)
    _close(got, ref, "decoded")
    np.testing.assert_allclose(got[..., 4:], ref[..., 4:], rtol=REL, atol=1e-6)


def test_rbox_helpers_equal_jax():
    rng = np.random.default_rng(5)
    r = _rboxes(rng, 50)
    r[::5, 2] = r[::5, 3]  # squares: w == h keeps w, turns the angle by pi / 2
    for got_np in (regularize_rboxes(r), regularize_rboxes(torch.from_numpy(r)).numpy()):
        np.testing.assert_allclose(got_np, jax_boxes.regularize_rboxes(r), rtol=REL, atol=1e-6)
    ref = jax_boxes.xywhr2xyxyxyxy(r)
    np.testing.assert_allclose(xywhr2xyxyxyxy(r), ref, rtol=REL, atol=1e-5)
    np.testing.assert_allclose(xywhr2xyxyxyxy(torch.from_numpy(r)).numpy(), ref, rtol=REL, atol=1e-5)
    assert xywhr2xyxyxyxy(r).shape == (50, 4, 2)


# -- the rotated assigner and the loss ---------------------------------------------

def _gt(rng: np.random.Generator, g: int = 6, nc: int = 3):
    cls = rng.integers(0, nc, (2, g)).astype(np.int32)
    bb = np.concatenate([rng.uniform(0.3, 0.7, (2, g, 2)), rng.uniform(0.1, 0.4, (2, g, 2)),
                         rng.uniform(-1.5, 1.5, (2, g, 1))], -1).astype(np.float32)
    mask = np.arange(g)[None] < np.array([[g - 1], [2]])
    bb[~mask] = 0
    cls[~mask] = 0
    return cls, bb, mask


def test_rotated_assigner_equals_jax():
    rng = np.random.default_rng(6)
    anchors, stride_t = make_anchors(SHAPES, STRIDES)
    anc = (anchors * stride_t).numpy()
    scores = rng.uniform(0, 1, (2, 336, 3)).astype(np.float32)
    pd = np.concatenate([anc[None].repeat(2, 0) + rng.normal(0, 4, (2, 336, 2)), rng.uniform(4, 50, (2, 336, 2)),
                         rng.uniform(-1.5, 1.5, (2, 336, 1))], -1).astype(np.float32)
    cls, bb, mask = _gt(rng)
    gt = np.concatenate([bb[..., :4] * 128, bb[..., 4:]], -1) * mask[..., None]
    ref = jax_assign(jnp.asarray(scores), jnp.asarray(pd), jnp.asarray(anc), jnp.asarray(cls[..., None]),
                     jnp.asarray(gt), jnp.asarray(mask[..., None]), num_classes=3, rotated=True)
    got = task_aligned_assign(torch.from_numpy(scores), torch.from_numpy(pd), torch.from_numpy(anc),
                              torch.from_numpy(cls[..., None]), torch.from_numpy(gt), torch.from_numpy(mask[..., None]),
                              num_classes=3, rotated=True)
    assert int(got.fg_mask.sum()) > 20
    for name in ("target_labels", "fg_mask", "target_gt_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    assert got.target_bboxes.shape == (2, 336, 5)
    np.testing.assert_allclose(got.target_bboxes.numpy(), np.asarray(ref.target_bboxes), rtol=REL, atol=1e-6)
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(ref.target_scores), rtol=REL, atol=1e-6)


@pytest.mark.parametrize("nc", [1, 3])
def test_obb_loss_and_its_gradient_equal_jax(nc):
    rng = np.random.default_rng(nc)
    boxes = [rng.normal(0, 2, (2, 64, h, w)).astype(np.float32) for h, w in SHAPES]
    scores = [rng.normal(-2, 2, (2, nc, h, w)).astype(np.float32) for h, w in SHAPES]
    raw = rng.normal(0, 1, (2, 336, 1)).astype(np.float32)
    cls, bb, mask = _gt(rng, nc=nc)
    kw = dict(nc=nc, imgsz=128, strides=STRIDES)

    def jax_total(args):
        maps, a = args
        feats = [(jnp.transpose(bx, (0, 2, 3, 1)), jnp.transpose(sc, (0, 2, 3, 1))) for bx, sc in maps]
        return jax_obb_loss(feats, a, jnp.asarray(cls), jnp.asarray(bb), jnp.asarray(mask), **kw)

    (ref_total, ref_items), (ref_maps, ref_raw) = jax.value_and_grad(jax_total, has_aux=True)(
        ([(jnp.asarray(bx), jnp.asarray(sc)) for bx, sc in zip(boxes, scores)], jnp.asarray(raw)))
    maps = [(torch.from_numpy(bx).requires_grad_(), torch.from_numpy(sc).requires_grad_())
            for bx, sc in zip(boxes, scores)]
    a = torch.from_numpy(raw).requires_grad_()
    total, items = obb_loss(maps, a, torch.from_numpy(cls), torch.from_numpy(bb), torch.from_numpy(mask), **kw)
    total.backward()
    print(f"nc {nc}: items {items.tolist()} (JAX {np.asarray(ref_items).tolist()})")
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=REL, atol=0)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=REL)
    assert items.shape == (3,) and not items.requires_grad and (items > 0).all()
    pairs = [(t.grad, r) for (gb, gs), (rb, rs) in zip(maps, ref_maps) for t, r in ((gb, rb), (gs, rs))]
    for i, (got, ref) in enumerate(pairs + [(a.grad, ref_raw)]):
        _close(got, ref, f"gradient {i}")
    assert np.abs(np.asarray(ref_raw)).max() > 0  # the box loss reaches the raw angles


# -- rotated NMS and the metrics ----------------------------------------------------

@pytest.mark.parametrize("topk,max_det", [(256, 300), (256, 20), (1024, 300)])
def test_nms_rotated_equals_jax(topk, max_det):
    rng = np.random.default_rng(topk + max_det)
    p = np.concatenate([rng.uniform(0, 100, (2, 500, 2)), rng.uniform(5, 30, (2, 500, 2)),
                        rng.uniform(-1.5, 1.5, (2, 500, 1)), rng.uniform(0, 1, (2, 500, 3))], -1).astype(np.float32)
    p[:, 100:140, 5:] = p[:, 60:100, 5:]  # tied scores
    p[:, 200:220, :5] = p[:, 180:200, :5]  # identical boxes
    got, n = nms_rotated(torch.from_numpy(p), 0.25, 0.45, 3, max_det, topk)
    ref, rn = jax_nms_rotated(jnp.asarray(p), 0.25, 0.45, 3, False, max_det, topk)
    assert got.shape == (2, max_det, 7) and n.dtype == torch.int32
    np.testing.assert_array_equal(n.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (n > 10).all()


def test_obb_metrics_equal_jax():
    rng = np.random.default_rng(0)
    n, names = 200, {0: "a", 1: "b"}
    tp = rng.uniform(0, 1, (n, 10)) > 0.4
    conf, pred_cls = rng.uniform(0, 1, n), rng.integers(0, 2, n).astype(float)
    target_cls = rng.integers(0, 2, 150).astype(float)
    ours, theirs = OBBMetrics(names), JaxOBBMetrics(names)
    for m in (ours, theirs):
        m.process(tp, conf, pred_cls, target_cls)
    assert list(ours.results_dict) == list(theirs.results_dict) and len(ours.results_dict) == 5
    for k, v in ours.results_dict.items():
        assert v == theirs.results_dict[k], k
    assert ours.fitness == theirs.fitness and ours.task == theirs.task and OBBMetrics.task == "obb"
