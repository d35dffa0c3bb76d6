"""The port's pose model and its ops against the JAX package's, on the CPU.

- The model: `yolo11n-pose.yaml` at scale n with the keypoint layouts
  (5, 3) (shapes128-pose) and (17, 3) (coco8-pose, c4 = 51: an odd width)
  builds with JAX's leaf paths and shapes (through the weight bridge). A JAX variables tree (seeded leaves, BN statistics away
  from 0 and 1) carried across and back equals itself leaf for leaf, the
  keypoint branches `model_23/cv4_{i}_{j}` and the nested
  `model_23/detect/...` among them; the optimizer state crosses both ways
  (tree and flat forms). The whole forward at 64 px, B = 2: every level's
  box and cls maps and the raw keypoints within 1e-5 of each output's max
  |value| (measured 1e-7). The Pose head alone at (12, 2) (tiger-pose's
  nd = 2) on seeded maps, the same. The train-mode forward at (5, 3) on
  the same weights against the port's own in float64 (ROADMAP.md §3.34):
  the port's f32 output closer to it than JAX's in every output; JAX with
  flax's two-pass variance within 2x of the port.
- decode_kpts at nd = 2 and 3 and kpt_iou (OKS, invisible ground-truth
  points masked) within 1e-5 relative.
- keypoint_loss_terms and pose_loss: the values (pose_loss's items box,
  pose, kobj, cls, dfl) within 1e-5 relative, and the gradients (of the
  terms to the predicted points; of the total to every box and cls map and
  to the raw keypoints) within 1e-5 of each one's max |g|, at nk = 5 and 17
  (OKS_SIGMA), nd = 2 (kobj 0) and 3, 128 px, ground truth with invisible
  points and padded rows.
- PoseMetrics' results_dict (the (P) keys and the fitness) equal to JAX's
  within 1e-12.
- COCOeval(iou_type="keypoints"): the stats equal to JAX's on seeded
  ground truth (visible, partly visible, without labelled keypoints, crowd)
  and detections, with COCO's 17 sigmas and with 5 uniform ones; max_dets
  (20,) and no "small" range.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.nn.modules import Pose
from spectrogram_yolov11_torch.nn.tasks import PoseModel, build_model, yaml_model_load
from spectrogram_yolov11_torch.ops.cocoeval import COCOeval
from spectrogram_yolov11_torch.ops.decode import decode_kpts
from spectrogram_yolov11_torch.ops.iou import kpt_iou
from spectrogram_yolov11_torch.ops.losses import keypoint_loss_terms, pose_loss
from spectrogram_yolov11_torch.ops.metrics import OKS_SIGMA, PoseMetrics
from spectrogram_yolov11_torch.utils.jax_compat import (opt_state_from_flax, opt_state_to_flax,
                                                        state_dict_to_variables, variables_to_state_dict)
from spectrogram_yolov11_tpu.engine.optim import flatten_tree
from spectrogram_yolov11_tpu.nn.modules.head import Pose as JaxPose
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.ops import cocoeval as jax_cocoeval
from spectrogram_yolov11_tpu.ops.decode import decode_kpts as jax_decode_kpts
from spectrogram_yolov11_tpu.ops.iou import kpt_iou as jax_kpt_iou
from spectrogram_yolov11_tpu.ops.losses import keypoint_loss_terms as jax_keypoint_loss_terms
from spectrogram_yolov11_tpu.ops.losses import pose_loss as jax_pose_loss
from spectrogram_yolov11_tpu.ops.metrics import OKS_SIGMA as JAX_OKS_SIGMA
from spectrogram_yolov11_tpu.ops.metrics import PoseMetrics as JaxPoseMetrics

REL = 1e-5  # of each output's (or gradient's) max |value|
XLA_OPTIONS = {"xla_llvm_disable_expensive_passes": True}
KPTS = [(5, 3), (17, 3)]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _seeded(shapes, seed: int = 0) -> dict:
    """A variables tree of `shapes` with seeded leaves: conv kernels ~ U(+-1/sqrt(fan_in)), BN scales and
    variances in [0.5, 1.5], biases and means ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, s in _leaves(jax.tree_util.tree_map(lambda a: a, shapes)):
        if path.startswith("batch_stats"):
            a = rng.uniform(0.5, 1.5, s.shape) if path.endswith("var") else rng.normal(0, 0.1, s.shape)
        elif path.endswith("scale"):
            a = rng.uniform(0.5, 1.5, s.shape)
        elif path.endswith("bias"):
            a = rng.normal(0, 0.1, s.shape)
        else:
            a = rng.uniform(-1, 1, s.shape) / np.sqrt(max(int(np.prod(s.shape[:-1])), 1))
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a.astype(np.float32)
    return out


def _close(got, ref, what="", rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= rel * scale, (what, err, scale)


@functools.lru_cache(maxsize=None)
def _jax_pose(kpt: tuple) -> tuple:
    """(the model dict, JAX model, its shapes, seeded numpy variables) of yolo11n-pose at `kpt`, built once per
    layout. At (17, 3) the shapes are JAX's init's; at (5, 3) the bridge's of the port's model, which JAX's
    forward then takes (its own shapes, or it fails)."""
    d = {**yaml_model_load("yolo11n-pose.yaml"), "kpt_shape": list(kpt)}
    jm = jax_build_model(dict(d), verbose=False)
    if kpt == (17, 3):
        shapes = jax.eval_shape(lambda: jm.graph.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    else:
        shapes = state_dict_to_variables(build_model(dict(d)).state_dict())
    return d, jm, shapes, _seeded(shapes)


@pytest.fixture(scope="module", params=KPTS, ids=lambda k: f"{k[0]}x{k[1]}")
def pose(request):
    """(kpt_shape, JAX model, its shapes, seeded numpy variables, the port's model carried from them)."""
    d, jm, shapes, variables = _jax_pose(request.param)
    return request.param, jm, shapes, variables, build_model(dict(d), variables=variables)


def test_builds_as_jax_and_round_trips_the_bridge(pose):
    kpt, jm, shapes, variables, tm = pose
    assert isinstance(tm, PoseModel) and tm.task == "pose" and tm.kpt_shape == kpt == tuple(jm.kpt_shape)
    nk = kpt[0] * kpt[1]
    head = tm.model[-1]
    assert head.cv4[0][0].conv.out_channels == max(64 // 4, nk) and head.cv4[2][2].out_channels == nk
    assert tm.stride == (8.0, 16.0, 32.0) == tuple(float(s) for s in jm.stride)
    back = dict(_leaves(state_dict_to_variables(tm.state_dict())))
    ref = dict(_leaves(variables))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    assert "params/model_23/cv4_0_2/kernel" in back and "params/model_23/detect/cv3_2_2/bias" in back
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    if kpt == (17, 3):  # the YAML's own layout: JAX's init shapes
        fresh = build_model("yolo11n-pose.yaml").init(0)
        assert {k: v.shape for k, v in _leaves(state_dict_to_variables(fresh.state_dict()))} == \
               {k: tuple(v.shape) for k, v in _leaves(shapes)}
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


def test_forward_matches_jax(pose):
    kpt, jm, _, variables, tm = pose
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    rf, rk = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.inference_mode():
        gf, gk = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert gk.shape == (2, 84, kpt[0] * kpt[1])
    _close(gk, rk, "keypoints")
    for i, ((gb, gc), (rb, rc)) in enumerate(zip(gf, rf)):
        _close(gb.permute(0, 2, 3, 1), rb, f"box {i}")
        _close(gc.permute(0, 2, 3, 1), rc, f"cls {i}")


@pytest.mark.parametrize("kpt", [(12, 2)])
def test_pose_head_alone_matches_jax(kpt):
    ch = (16, 32, 64)
    rng = np.random.default_rng(kpt[1])
    xs = [rng.normal(0, 1, (2, 8 // 2**i, 8 // 2**i, c)).astype(np.float32) for i, c in enumerate(ch)]
    jh = JaxPose(nc=2, kpt_shape=kpt, ch=ch, legacy=False)
    shapes = jax.eval_shape(lambda: jh.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs]))
    variables = _seeded(shapes, seed=kpt[1])
    th = Pose(2, kpt, ch)
    th.load_state_dict(variables_to_state_dict(variables), strict=True)
    rf, rk = jax.jit(lambda v, a: jh.apply(v, a))(variables, [jnp.asarray(x) for x in xs])
    with torch.inference_mode():
        gf, gk = th.eval()([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    assert th.cv4[0][0].conv.out_channels == max(16 // 4, kpt[0] * kpt[1])
    _close(gk, rk, "keypoints")
    for (gb, gc), (rb, rc) in zip(gf, rf):
        _close(gb.permute(0, 2, 3, 1), rb, "box")
        _close(gc.permute(0, 2, 3, 1), rc, "cls")


def _outputs(out) -> list:
    """A forward's outputs (every level's box and cls map NHWC, the raw keypoints) as float64 arrays."""
    feats, kpts = out
    nhwc = [np.asarray(t.detach().permute(0, 2, 3, 1), np.float64) if isinstance(t, torch.Tensor) else
            np.asarray(t, np.float64) for bc in feats for t in bc]
    return nhwc + [np.asarray(kpts.detach() if isinstance(kpts, torch.Tensor) else kpts, np.float64)]


def test_train_mode_forward_against_float64():
    """The witness of ROADMAP.md §3.34 on the seeded (not zero-mean) weights at 64 px, B = 2: the train-mode
    forward in float64 (the port's model in f64, its casts to f32 kept at f64) is the truth. The port's f32
    forward lies closer to it than JAX's in every output, by 2x or more at the worst output (measured 3.8e-4
    against 1.1e-3 of the output's max |value|); JAX with flax's two-pass variance (use_fast_variance=False)
    lands within 2x of the port, so the one-pass variance E[x^2] - E[x]^2 is what puts JAX further off."""
    from flax import linen as nn

    import spectrogram_yolov11_tpu.nn.modules.conv as jax_conv

    d, jm, _, variables = _jax_pose((5, 3))
    tm = build_model(dict(d), variables=variables)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    def jax_train_forward():
        fn = jax.jit(lambda v, a: jm.apply(v, a, train=True)[0])
        return _outputs(fn.lower(variables, x).compile(compiler_options=XLA_OPTIONS)(variables, x))

    one_pass = jax_train_forward()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_conv.nn, "BatchNorm", functools.partial(nn.BatchNorm, use_fast_variance=False))
        two_pass = jax_train_forward()
    port = _outputs(tm.train()(xt))
    f32_cast = torch.Tensor.float
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", lambda t: t if t.dtype == torch.float64 else f32_cast(t))
        m64 = tm.double().train()
        m64.compute_dtype = torch.float64
        truth = _outputs(m64(xt.double()))
    err = {name: [float(np.abs(o - t).max() / np.abs(t).max()) for o, t in zip(outs, truth)]
           for name, outs in (("port", port), ("jax", one_pass), ("jax_two_pass", two_pass))}
    print(err)
    assert all(p < j for p, j in zip(err["port"], err["jax"])), err
    assert 2 * max(err["port"]) <= max(err["jax"]) and max(err["jax_two_pass"]) <= 2 * max(err["port"]), err


# -- decode and OKS ----------------------------------------------------------------

SHAPES, STRIDES = [(16, 16), (8, 8), (4, 4)], (8.0, 16.0, 32.0)


@pytest.mark.parametrize("kpt", [(5, 3), (17, 2)])
def test_decode_kpts_equals_jax(kpt):
    raw = np.random.default_rng(kpt[0]).normal(0, 2, (2, 336, kpt[0] * kpt[1])).astype(np.float32)
    got = decode_kpts(torch.from_numpy(raw), kpt, SHAPES, STRIDES)
    ref = jax.jit(lambda r: jax_decode_kpts(r, kpt, SHAPES, STRIDES))(jnp.asarray(raw))
    assert got.shape == (2, 336, *kpt) and got.dtype == torch.float32
    _close(got, ref, "decoded keypoints")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=REL, atol=0)


@pytest.mark.parametrize("nd", [2, 3])
def test_kpt_iou_equals_jax(nd):
    rng = np.random.default_rng(nd)
    gt = np.concatenate([rng.uniform(0, 100, (6, 17, 2)), rng.integers(0, 3, (6, 17, 1))], -1).astype(np.float32)
    gt[2, :, 2] = 0  # a ground truth without visible points: OKS 0
    pred = (gt[None, :, :, :nd].repeat(2, 0).reshape(12, 17, nd) + rng.normal(0, 3, (12, 17, nd))).astype(np.float32)
    area = rng.uniform(100, 3000, 6).astype(np.float32)
    for sigma in (OKS_SIGMA, np.full(17, 1 / 17)):
        got = kpt_iou(torch.from_numpy(gt), torch.from_numpy(pred), torch.from_numpy(area), sigma).numpy()
        ref = np.asarray(jax.jit(jax_kpt_iou)(jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(area), sigma))
        assert got.shape == (6, 12) and (got[2] == 0).all() and got.max() > 0.3
        np.testing.assert_allclose(got, ref, rtol=REL, atol=1e-7)
    np.testing.assert_array_equal(OKS_SIGMA, JAX_OKS_SIGMA)


# -- the losses --------------------------------------------------------------------

def test_keypoint_loss_terms_and_gradient_equal_jax():
    rng = np.random.default_rng(0)
    pred = rng.normal(5, 3, (2, 40, 17, 2)).astype(np.float32)
    gt = (pred + rng.normal(0, 1, pred.shape)).astype(np.float32)
    mask = (rng.uniform(0, 1, (2, 40, 17)) > 0.3).astype(np.float32)
    area = rng.uniform(1, 30, (2, 40, 1)).astype(np.float32)
    sig = np.asarray(OKS_SIGMA, np.float32)
    cot = rng.normal(0, 1, pred.shape[:-1]).astype(np.float32)

    @jax.jit
    def ref_fn(p, c):
        terms, vjp = jax.vjp(lambda q: jax_keypoint_loss_terms(q, jnp.asarray(gt), jnp.asarray(mask),
                                                               jnp.asarray(area), jnp.asarray(sig)), p)
        return terms, vjp(c)[0]

    ref, ref_g = ref_fn(jnp.asarray(pred), jnp.asarray(cot))
    p = torch.from_numpy(pred).requires_grad_()
    got = keypoint_loss_terms(p, torch.from_numpy(gt), torch.from_numpy(mask), torch.from_numpy(area),
                              torch.from_numpy(sig))
    got.backward(torch.from_numpy(cot))
    _close(got.detach(), ref, "terms")
    _close(p.grad, ref_g, "gradient")


def _pose_inputs(rng: np.random.Generator, nk: int, nd: int, g: int = 6):
    boxes = [rng.normal(0, 2, (2, 64, h, w)).astype(np.float32) for h, w in SHAPES]
    scores = [rng.normal(-2, 2, (2, 1, h, w)).astype(np.float32) for h, w in SHAPES]
    raw = rng.normal(0, 1, (2, 336, nk * nd)).astype(np.float32)
    cls = np.zeros((2, g), np.int32)
    xy, wh = rng.uniform(0.25, 0.75, (2, g, 2)), rng.uniform(0.1, 0.4, (2, g, 2))
    bboxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.arange(g)[None] < np.array([[g - 1], [2]])
    bboxes[~mask] = 0
    kxy = xy[:, :, None] + (rng.uniform(-0.5, 0.5, (2, g, nk, 2)) * wh[:, :, None])
    vis = rng.choice([0.0, 1.0, 2.0], (2, g, nk, 1), p=[0.25, 0.25, 0.5])
    kpts = np.concatenate([kxy, vis], -1).astype(np.float32)
    kpts[~mask] = 0
    return boxes, scores, raw, cls, bboxes, mask, kpts


@pytest.mark.parametrize("nk,nd", [(5, 3), (5, 2), (17, 3), (17, 2)])
def test_pose_loss_and_its_gradient_equal_jax(nk, nd):
    boxes, scores, raw, cls, bboxes, mask, kpts = _pose_inputs(np.random.default_rng(nk * 10 + nd), nk, nd)
    kw = dict(nc=1, kpt_shape=(nk, nd), imgsz=128, strides=STRIDES)

    def jax_total(args):
        maps, kr = args
        feats = [(jnp.transpose(bx, (0, 2, 3, 1)), jnp.transpose(sc, (0, 2, 3, 1))) for bx, sc in maps]
        return jax_pose_loss(feats, kr, jnp.asarray(cls), jnp.asarray(bboxes), jnp.asarray(mask), jnp.asarray(kpts),
                             **kw)

    (ref_total, ref_items), (ref_maps, ref_raw) = jax.value_and_grad(jax_total, has_aux=True)(
        ([(jnp.asarray(bx), jnp.asarray(sc)) for bx, sc in zip(boxes, scores)], jnp.asarray(raw)))
    maps = [(torch.from_numpy(bx).requires_grad_(), torch.from_numpy(sc).requires_grad_())
            for bx, sc in zip(boxes, scores)]
    kr = torch.from_numpy(raw).requires_grad_()
    total, items = pose_loss(maps, kr, torch.from_numpy(cls), torch.from_numpy(bboxes), torch.from_numpy(mask),
                             torch.from_numpy(kpts), **kw)
    total.backward()
    print(f"({nk}, {nd}): items {items.tolist()} (JAX {np.asarray(ref_items).tolist()})")
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=REL, atol=0)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=REL)
    assert items.shape == (5,) and not items.requires_grad and (items[[0, 1, 3, 4]] > 0).all()
    assert (items[2] > 0) if nd == 3 else (items[2] == 0)
    pairs = [(t.grad, r) for (gb, gs), (rb, rs) in zip(maps, ref_maps) for t, r in ((gb, rb), (gs, rs))]
    for i, (got, ref) in enumerate(pairs + [(kr.grad, ref_raw)]):
        _close(got, ref, f"gradient {i}")
    assert np.abs(np.asarray(ref_raw)).max() > 0  # the keypoint terms reach the raw keypoints


# -- metrics and the COCO keypoints protocol ----------------------------------------

def test_pose_metrics_equal_jax():
    rng = np.random.default_rng(0)
    n, names = 200, {0: "a", 1: "b"}
    tp, tp_p = rng.uniform(0, 1, (n, 10)) > 0.4, rng.uniform(0, 1, (n, 10)) > 0.5
    conf, pred_cls = rng.uniform(0, 1, n), rng.integers(0, 2, n).astype(float)
    target_cls = rng.integers(0, 2, 150).astype(float)
    ours, theirs = PoseMetrics(names), JaxPoseMetrics(names)
    for m in (ours, theirs):
        m.process(tp, conf, pred_cls, target_cls, tp_p=tp_p)
    assert list(ours.results_dict) == list(theirs.results_dict) and len(ours.results_dict) == 9
    assert "metrics/mAP50-95(P)" in ours.results_dict and ours.results_dict["metrics/mAP50-95(P)"] > 0
    for k, v in ours.results_dict.items():
        assert abs(v - theirs.results_dict[k]) <= 1e-12, k
    assert ours.fitness == pytest.approx(theirs.fitness, abs=1e-12)


def _kpt_rows(rng: np.random.Generator, nk: int):
    gts, dts = [], []
    for img in range(5):
        for j in range(int(rng.integers(1, 6))):
            x, y, w, h = rng.uniform(0, 200), rng.uniform(0, 200), rng.uniform(10, 120), rng.uniform(10, 120)
            kx, ky = x + rng.uniform(0, w, nk), y + rng.uniform(0, h, nk)
            v = rng.choice([0, 1, 2], nk, p=[0.3, 0.2, 0.5]).astype(float)
            if j == 1:
                v[:] = 0  # no labelled keypoint: ignored, matched by the grown-box branch
            row = {"image_id": img, "category_id": 0, "bbox": [x, y, w, h], "iscrowd": int(j == 4),
                   "keypoints": np.stack([kx, ky, v], -1).reshape(-1).round(3).tolist()}
            if j % 2:
                row["num_keypoints"] = int((v > 0).sum())
            if j == 2:
                row["area"] = 0.53 * w * h
            gts.append(row)
            for _ in range(int(rng.integers(0, 4))):
                dx, dy = kx + rng.normal(0, 4, nk), ky + rng.normal(0, 4, nk)
                d = {"image_id": img, "category_id": 0, "bbox": [x, y, w, h], "score": float(rng.uniform()),
                     "keypoints": np.stack([dx, dy, rng.uniform(0, 1, nk)], -1).reshape(-1).round(3).tolist()}
                if rng.uniform() < 0.3:
                    d["area"] = float(w * h)
                dts.append(d)
    return gts, dts


@pytest.mark.parametrize("seed,nk", [(0, 17), (1, 17), (2, 5)])
def test_keypoints_cocoeval_equals_jax(seed, nk):
    gts, dts = _kpt_rows(np.random.default_rng(seed), nk)
    sigmas = None if nk == 17 else np.full(nk, 1.0 / nk)
    ours = COCOeval(gts, dts, iou_type="keypoints", kpt_sigmas=sigmas)
    theirs = jax_cocoeval.COCOeval(gts, dts, iou_type="keypoints", kpt_sigmas=sigmas)
    assert ours.max_dets == [20] and list(ours.area_rng) == ["all", "medium", "large"]
    assert ours.evaluate().stats == theirs.evaluate().stats
    assert list(ours.stats) == ["AP", "AP50", "AP75", "APmedium", "APlarge", "AR20", "ARmedium", "ARlarge"]
    assert ours.stats["AP50"] > 0
    np.testing.assert_array_equal(ours.precision, theirs.precision)
