"""The port's inference tail and whole serving pipeline against the JAX chain.

decode_detections and non_max_suppression get the same inputs on both sides;
the pipeline (build_pipeline at 96 px on seeded synth frames) is held against
the JAX chain composed inline as bench.py:_build_pipeline composes it.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.ops.decode import decode_detections as jax_decode
from spectrogram_yolov11_tpu.ops.nms import non_max_suppression as jax_nms
from spectrogram_yolov11_torch.data.synth import synth_frames
from spectrogram_yolov11_torch.engine.pipeline import build_pipeline, letterbox_geometry
from spectrogram_yolov11_torch.ops.decode import decode_detections
from spectrogram_yolov11_torch.ops.iou import box_iou
from spectrogram_yolov11_torch.ops.nms import non_max_suppression

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"


def test_decode_matches_jax():
    rng = np.random.default_rng(0)
    nc, shapes = 2, [(8, 12), (4, 6), (2, 3)]
    feats = [(rng.normal(0, 3, (2, h, w, 64)).astype(np.float32), rng.normal(0, 2, (2, h, w, nc)).astype(np.float32))
             for h, w in shapes]
    ref = np.asarray(jax_decode([(jnp.asarray(b), jnp.asarray(c)) for b, c in feats], nc=nc, strides=(8.0, 16.0, 32.0)))
    got = decode_detections([(torch.from_numpy(b).permute(0, 3, 1, 2), torch.from_numpy(c).permute(0, 3, 1, 2))
                             for b, c in feats], nc, (8.0, 16.0, 32.0)).numpy()
    assert got.shape == ref.shape == (2, 96 + 24 + 6, 4 + nc)
    np.testing.assert_allclose(got[..., :4], ref[..., :4], atol=1e-3, rtol=0)  # px
    np.testing.assert_allclose(got[..., 4:], ref[..., 4:], atol=1e-6, rtol=0)


def _nms_preds(seed, b=2, a=300, nc=3):
    """Clustered boxes with well-separated scores: no score within 1e-4 of a
    conf threshold, no IoU within 1e-5 of an IoU threshold. The first seed
    from `seed` on that has both properties is used."""
    while True:
        preds = _try_nms_preds(np.random.default_rng(seed), b, a, nc)
        if preds is not None:
            return preds
        seed += 1000


def _try_nms_preds(rng, b, a, nc):
    centers = rng.uniform(30, 300, (b, 10, 2))
    cxy = np.take_along_axis(centers, rng.integers(0, 10, (b, a))[..., None], 1) + rng.normal(0, 8, (b, a, 2))
    wh = rng.uniform(10, 60, (b, a, 2))
    scores = rng.uniform(0, 0.02, (b, a, nc))
    hot = rng.uniform(size=(b, a, nc)) < 0.3
    scores[hot] = rng.uniform(0.3, 0.99, hot.sum())
    preds = np.concatenate([cxy, wh, scores], -1).astype(np.float32)
    xyxy = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    iou = box_iou(torch.from_numpy(xyxy), torch.from_numpy(xyxy)).numpy()
    if min(np.abs(iou - t).min() for t in (0.45, 0.7)) <= 1e-5 or np.abs(preds[..., 4:] - 0.25).min() <= 1e-4:
        return None
    return preds


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(multi_label=True),
        dict(agnostic=True),
        dict(classes=(0, 2)),
        dict(max_det=300, pre_nms_topk=128),  # k < max_det: zero padding
        dict(iou_thres=0.7, max_det=10, pre_nms_topk=512),  # predict settings, max_det cut
    ],
    ids=["single", "multi_label", "agnostic", "classes", "max_det_pad", "predict"],
)
def test_nms_matches_jax(kw):
    preds = _nms_preds(seed=len(kw) + 7 * sum(map(len, map(str, kw.values()))))
    args = dict(conf_thres=0.25, iou_thres=0.45, nc=3, max_det=50, pre_nms_topk=256)
    args.update(kw)
    jargs = dict(args, classes=jnp.asarray(args["classes"])) if "classes" in args else args
    out_r, n_r = map(np.asarray, jax_nms(jnp.asarray(preds), **jargs))
    out, n = non_max_suppression(torch.from_numpy(preds), **args)
    out, n = out.numpy(), n.numpy()
    assert out.shape == out_r.shape == (2, args["max_det"], 6)
    np.testing.assert_array_equal(n, n_r)
    assert n.min() > 0
    np.testing.assert_allclose(out, out_r, atol=1e-4, rtol=0)  # same kept rows, same order, zero padding
    if "classes" in kw:
        assert set(np.unique(out[..., 5][out[..., 4] > 0])) <= {0.0, 2.0}


@pytest.fixture(scope="module")
def jax_chain():
    """bench.py:_build_pipeline's device function, f32, at 96 px."""
    tree, meta = jax_load_checkpoint(CKPT)
    variables = tree.get("ema") or tree["variables"]
    model = jax_build_model(meta["model_yaml"], nc=meta["nc"], verbose=False)
    strides = tuple(float(s) for s in model.stride)
    imgsz, src_hw = 96, (54, 96)
    nh, nw, top, left = letterbox_geometry(imgsz, src_hw)

    @jax.jit
    def device_fn(v, imgs):
        x = jnp.pad(imgs, ((0, 0), (top, imgsz - top - nh), (left, imgsz - left - nw), (0, 0)), constant_values=114)
        x = jnp.broadcast_to(x, (*x.shape[:-1], 3))
        x = x[..., ::-1].astype(jnp.float32) / 255.0
        feats = model.apply(v, x, train=False)
        preds = jax_decode(feats, nc=model.nc, strides=strides)
        return feats, preds, jax_nms(preds, conf_thres=0.25, iou_thres=0.7, nc=model.nc, max_det=300, pre_nms_topk=512)

    return device_fn, variables, imgsz, src_hw


def test_pipeline_matches_jax_chain(jax_chain):
    device_fn, variables, imgsz, src_hw = jax_chain
    fn, model, nh, nw = build_pipeline(CKPT, device="cpu", imgsz=imgsz, src_hw=src_hw)
    assert (nh, nw) == (54, 96)
    frames = synth_frames(4, nh, nw, seed=3)
    assert frames.dtype == np.uint8 and frames.shape == (4, 54, 96, 1)
    feats_r, preds_r, (out_r, n_r) = device_fn(variables, jnp.asarray(frames))
    captured = {}
    hook = model.model[-1].register_forward_hook(lambda mod, args, out: captured.update(feats=out))
    out, n = fn(frames)
    hook.remove()

    # the head's maps inside the pipeline: same tolerance as the model test
    for (gb, gc), (rb, rc) in zip(captured["feats"], feats_r):
        np.testing.assert_allclose(gb.permute(0, 2, 3, 1).numpy(), np.asarray(rb), atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(gc.permute(0, 2, 3, 1).numpy(), np.asarray(rc), atol=1e-3, rtol=1e-3)

    # detections exactly, given no score within 1e-4 of conf and no kept-candidate IoU within 1e-5 of iou
    preds_r = np.asarray(preds_r)
    assert np.abs(preds_r[..., 4:].max(-1) - 0.25).min() > 1e-4
    out_r, n_r, out, n = np.asarray(out_r), np.asarray(n_r), out.numpy(), n.numpy()
    for i in range(4):
        top_k = np.argsort(-preds_r[i, :, 4:].max(-1), kind="stable")[:512]
        xy, wh = preds_r[i, top_k, :2], preds_r[i, top_k, 2:4]
        xyxy = torch.from_numpy(np.concatenate([xy - wh / 2, xy + wh / 2], -1))
        assert np.abs(box_iou(xyxy, xyxy).numpy() - 0.7).min() > 1e-5
    np.testing.assert_array_equal(n, n_r)
    assert n.sum() > 0
    np.testing.assert_array_equal(out[..., 5], out_r[..., 5])
    np.testing.assert_allclose(out[..., :4], out_r[..., :4], atol=1e-2, rtol=0)  # px
    np.testing.assert_allclose(out[..., 4], out_r[..., 4], atol=1e-4, rtol=0)


def test_pipeline_rejects_bad_frames():
    fn, _, nh, nw = build_pipeline(CKPT, device="cpu", imgsz=96, src_hw=(54, 96))
    with pytest.raises(ValueError, match="uint8"):
        fn(np.zeros((1, nh, nw, 1), np.float32))
    with pytest.raises(ValueError):
        fn(np.zeros((1, nh + 1, nw, 1), np.uint8))
    out, n = fn(np.zeros((2, nh, nw, 3), np.uint8))  # 3-channel frames take the same path
    assert out.shape == (2, 300, 6) and n.shape == (2,)
