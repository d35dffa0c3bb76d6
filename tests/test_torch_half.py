"""bf16 serving (half=True) on the port against the JAX package's bf16 path, on the CPU.

- The plain bf16 bottleneck (ops/fused_conv.py:bottleneck_reference_bf16)
  against the Pallas kernel in interpret mode and `xla_bottleneck`, both in
  bf16. Tolerance: every element within max|ref| * 2^-7 (two bf16 steps of
  the largest magnitude) with at most 1 % of elements unequal: a sum in
  another order flips the bf16 rounding of a few intermediates, by one step.
- The bf16 weight pack, and `set_dtype`'s bf16 copy of the model.
- dfl_decode and decode_detections on bf16 logits: the distances to 1e-6,
  since both sides take the same bf16 exp and project in f32; the boxes in
  pixels to four f32 steps of the largest coordinate; the scores, bf16 values
  on both sides, to two bf16 steps (XLA's CPU backend rounds each of the
  three ops of its sigmoid to bf16, torch the whole sigmoid once).
- The trained model in bf16 through decode and NMS (build_pipeline(half=True)
  at 96 px on seeded synth frames) against jax_build_model(dtype=bfloat16).
  The yardstick is JAX's own distance between its bf16 and f32 models, d_jax:
  the port stays within 2 * d_jax of JAX's bf16 model, for boxes and scores
  separately. The port's bf16 rounds where JAX's does (conv output, BN in f32,
  SiLU) except in the fused bottlenecks, which fold BN into bf16 weights as
  the Pallas kernel takes them. Detections are equal in count and class on
  seeds whose scores all stay >= 3e-2 from conf.
- NMS on those bf16 scores, which tie exactly, equals JAX's keep sets.
- YOLO(ckpt).predict(half=True, device="cpu"), and f32 again after it.

Run as a script (`PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_half.py`),
it prints how far the head's logits lie from JAX's bf16 model with BN kept in
f32 (the port) and with BN folded into bf16 weights, beside JAX's own
bf16-to-f32 distance.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpu import assert_bf16_close
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from spectrogram_yolov11_tpu.nn.modules.block import dfl_decode as jax_dfl_decode
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.ops.decode import decode_detections as jax_decode
from spectrogram_yolov11_tpu.ops.nms import non_max_suppression as jax_nms
from spectrogram_yolov11_tpu.ops.pallas_fused_conv import fused_bottleneck as pallas_bottleneck
from spectrogram_yolov11_tpu.ops.pallas_fused_conv import xla_bottleneck
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.data.synth import synth_frames, synth_iq
from spectrogram_yolov11_torch.engine.pipeline import build_pipeline, letterbox_geometry, load_model
from spectrogram_yolov11_torch.nn.modules.block import dfl_decode
from spectrogram_yolov11_torch.ops.decode import decode_detections
from spectrogram_yolov11_torch.ops.fused_conv import (
    bottleneck_reference_bf16,
    fused_bottleneck,
    pack_bottleneck_weights_bf16,
    unpack_bottleneck_weights_bf16,
)
from spectrogram_yolov11_torch.ops.iou import box_iou
from spectrogram_yolov11_torch.ops.nms import non_max_suppression

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
IMGSZ, SRC_HW = 96, (54, 96)
CONF, SCORE_MARGIN = 0.25, 3e-2
BF16 = torch.bfloat16


def _bf16_numpy(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16, held as f32 so that both frameworks get the same values."""
    return torch.from_numpy(a.astype(np.float32)).to(BF16).float().numpy()


@pytest.mark.parametrize("c,h,w", [(32, 11, 13), (64, 7, 9), (128, 9, 6)])
def test_bottleneck_reference_bf16_matches_pallas(c, h, w):
    rng = np.random.default_rng(c + h)
    x, w1, w2 = (_bf16_numpy(rng.normal(0, s, shape)) for s, shape in (
        (1.0, (2, h, w, c)), (0.05, (3, 3, c, c)), (0.05, (3, 3, c, c))))
    b1, b2 = (rng.normal(0, 0.1, c).astype(np.float32) for _ in range(2))
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1, jnp.bfloat16), jnp.asarray(b1),
             jnp.asarray(w2, jnp.bfloat16), jnp.asarray(b2))
    ref_pallas = np.asarray(pallas_bottleneck(*jargs, interpret=True).astype(jnp.float32))
    ref_xla = np.asarray(xla_bottleneck(*jargs).astype(jnp.float32))
    xt, w1t, b1t, w2t, b2t = map(torch.from_numpy, (x, w1, b1, w2, b2))
    got = bottleneck_reference_bf16(xt.to(BF16), w1t, b1t, w2t, b2t)
    assert got.dtype == BF16 and got.shape == xt.shape
    assert_bf16_close(got, torch.from_numpy(ref_pallas))
    assert_bf16_close(got, torch.from_numpy(ref_xla))
    # on a CPU tensor the wrapper is the plain version, from HWIO weights or the bf16 pack, whatever x's dtype says
    assert torch.equal(fused_bottleneck(xt.to(BF16), w1t, b1t, w2t, b2t), got)
    packs = [pack_bottleneck_weights_bf16(t) for t in (w1t, w2t)]
    assert torch.equal(fused_bottleneck(xt.to(BF16), packs[0], b1t, packs[1], b2t), got)


def test_bf16_weight_pack_round_trip():
    c = 64
    w = torch.from_numpy(np.random.default_rng(c).normal(0, 0.05, (3, 3, c, c)).astype(np.float32))
    p = pack_bottleneck_weights_bf16(w)
    assert p.shape == (9, c, c) and p.dtype == BF16 and p.is_contiguous()
    assert torch.equal(unpack_bottleneck_weights_bf16(p), w.to(BF16))
    assert torch.equal(p[4, 5, 7], w[1, 1, 7, 5].to(BF16))  # K-major per tap: pack[tap, co, ci] is w[ky, kx, ci, co]


def test_set_dtype_makes_a_bf16_copy_and_leaves_the_model():
    model, _ = load_model(CKPT)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    packs = [(m.w1.clone(), m.b1.clone()) for m in model.modules() if getattr(m, "fusable", False)]
    half = model.set_dtype(BF16)
    assert half is not model and model.dtype == torch.float32 and half.dtype == BF16
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    fused = [m for m in model.modules() if getattr(m, "fusable", False)]
    assert all(torch.equal(m.w1, w) and torch.equal(m.b1, b) for m, (w, b) in zip(fused, packs))
    convs = [m for m in half.modules() if isinstance(m, torch.nn.Conv2d)]
    bns = [m for m in half.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert convs and all(p.dtype == BF16 for m in convs for p in m.parameters())
    assert bns and all(t.dtype == torch.float32 for m in bns for t in (*m.parameters(), *m.buffers()) if t.is_floating_point())
    half_fused = [m for m in half.modules() if getattr(m, "fusable", False)]
    assert [(m.w1.shape, m.w1.dtype, m.b1.dtype) for m in half_fused] == \
        [((9, 32, 32), BF16, torch.float32)] * 2 + [((9, 64, 64), BF16, torch.float32)] * 4
    assert half.set_dtype(BF16) is half and model.set_dtype(torch.float32) is model
    for m, dtype in ((half, torch.float32), (model, torch.float16)):
        with pytest.raises(ValueError, match="set_dtype"):
            m.set_dtype(dtype)


def test_decode_on_bf16_logits_matches_jax():
    rng = np.random.default_rng(0)
    nc, shapes, strides = 2, [(8, 12), (4, 6), (2, 3)], (8.0, 16.0, 32.0)
    feats = [(_bf16_numpy(rng.normal(0, 3, (2, h, w, 64))), _bf16_numpy(rng.normal(0, 2, (2, h, w, nc))))
             for h, w in shapes]
    box = feats[0][0].reshape(2, -1, 64)
    ref = np.asarray(jax_dfl_decode(jnp.asarray(box, jnp.bfloat16)))
    got = dfl_decode(torch.from_numpy(box).to(BF16))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)
    ref = np.asarray(jax_decode([(jnp.asarray(b, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16)) for b, c in feats],
                                nc=nc, strides=strides))
    got = decode_detections([(torch.from_numpy(b).to(BF16).permute(0, 3, 1, 2),
                              torch.from_numpy(c).to(BF16).permute(0, 3, 1, 2)) for b, c in feats], nc, strides)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, 96 + 24 + 6, 4 + nc)
    # boxes in pixels: x1y1 = anchor - lt cancels, so to four f32 steps of the largest coordinate
    np.testing.assert_allclose(got[..., :4].numpy(), ref[..., :4], atol=2.0**-21 * np.abs(ref[..., :4]).max(), rtol=0)
    # scores: bf16 values on both sides, two bf16 steps apart at most. XLA's CPU backend rounds each of
    # the three ops of its expanded logistic, 1 / (1 + exp(-x)), to bf16; torch rounds the bf16 sigmoid once
    scores, ref_scores = got[..., 4:].numpy(), ref[..., 4:]
    assert np.array_equal(scores, _bf16_numpy(scores)) and np.array_equal(ref_scores, _bf16_numpy(ref_scores))
    assert (np.abs(scores - ref_scores) <= 2.0**-6 * ref_scores).all()
    logits = torch.cat([torch.from_numpy(c).to(BF16).reshape(2, -1, nc) for _, c in feats], 1)
    np.testing.assert_array_equal(torch.reciprocal(1 + torch.exp(-logits)).float().numpy(), ref_scores)


@pytest.fixture(scope="module")
def jax_chains():
    """bench.py:_build_pipeline's device function at 96 px, for the JAX model
    in bf16 (as bench.py builds it) and in f32: frames -> decoded predictions
    and the NMS output."""
    tree, meta = jax_load_checkpoint(CKPT)
    variables = tree.get("ema") or tree["variables"]
    nh, nw, top, left = letterbox_geometry(IMGSZ, SRC_HW)

    def chain(dtype):
        model = jax_build_model(meta["model_yaml"], nc=meta["nc"], verbose=False, dtype=dtype)
        strides = tuple(float(s) for s in model.stride)

        @jax.jit
        def device_fn(imgs):
            x = jnp.pad(imgs, ((0, 0), (top, IMGSZ - top - nh), (left, IMGSZ - left - nw), (0, 0)), constant_values=114)
            x = jnp.broadcast_to(x, (*x.shape[:-1], 3))[..., ::-1].astype(jnp.float32) / 255.0
            preds = jax_decode(model.apply(variables, x, train=False), nc=model.nc, strides=strides)
            return preds, jax_nms(preds, conf_thres=CONF, iou_thres=0.7, nc=model.nc, max_det=300, pre_nms_topk=512)

        return device_fn

    return chain(jnp.bfloat16), chain(None), (nh, nw)


@pytest.fixture(scope="module")
def margin_seeds(jax_chains):
    """The first two frame seeds whose JAX bf16 scores all stay >= 3e-2 from
    conf: (frames, JAX bf16 preds, JAX f32 preds, JAX bf16 (out, n))."""
    chain_bf16, chain_f32, (nh, nw) = jax_chains
    found = []
    for seed in range(20):
        frames = synth_frames(4, nh, nw, seed=seed)
        preds, (out, n) = map(lambda t: jax.tree_util.tree_map(np.asarray, t), chain_bf16(jnp.asarray(frames)))
        if np.abs(preds[..., 4:] - CONF).min() >= SCORE_MARGIN:
            found.append((frames, preds, np.asarray(chain_f32(jnp.asarray(frames))[0]), (out, n)))
            if len(found) == 2:
                return found
    raise AssertionError("fewer than two seeds in 0..19 keep every score 3e-2 from conf")


def test_bf16_pipeline_matches_jax_bf16(margin_seeds):
    fn, model, _, _ = build_pipeline(CKPT, device="cpu", imgsz=IMGSZ, src_hw=SRC_HW, half=True)
    assert model.dtype == BF16
    captured = {}
    hook = model.model[-1].register_forward_hook(lambda mod, args, out: captured.update(feats=out))
    detections = 0
    for frames, preds_b, preds_f, (out_r, n_r) in margin_seeds:
        out, n = fn(frames)
        assert all(t.dtype == BF16 for level in captured["feats"] for t in level)  # the head's logits stay bf16
        preds = decode_detections(captured["feats"], model.nc, model.stride).numpy()
        assert np.abs(preds_b[..., 4:] - CONF).min() >= SCORE_MARGIN
        d_jax = {k: float(np.abs(preds_b[..., s] - preds_f[..., s]).max()) for k, s in (("box", np.s_[:4]), ("score", np.s_[4:]))}
        d_port = {k: float(np.abs(preds[..., s] - preds_b[..., s]).max()) for k, s in (("box", np.s_[:4]), ("score", np.s_[4:]))}
        assert d_jax["box"] > 0 and d_jax["score"] > 0
        assert d_port["box"] <= 2 * d_jax["box"] and d_port["score"] <= 2 * d_jax["score"], (d_port, d_jax)
        out, n = out.numpy(), n.numpy()
        assert out.dtype == np.float32
        np.testing.assert_array_equal(n, n_r)
        np.testing.assert_array_equal(out[..., 5], out_r[..., 5])
        np.testing.assert_allclose(out[..., :4], out_r[..., :4], atol=2 * d_jax["box"], rtol=0)
        detections += int(n.sum())
    hook.remove()
    assert detections > 0


@pytest.mark.parametrize("conf,multi_label", [(CONF, False), (0.001, False), (0.001, True)],
                         ids=["predict", "low-conf", "low-conf-multi-label"])
def test_nms_on_tied_bf16_scores_matches_jax(margin_seeds, conf, multi_label):
    """JAX's bf16 predictions: scores of 8 significant bits, which tie exactly
    within an image; the port's stable sort breaks ties by index, as JAX's
    top_k does, so the keep sets are equal."""
    tied = 0
    for _, preds, _, _ in margin_seeds:
        for p in preds:
            s = p[:, 4:].max(-1) if not multi_label else p[:, 4:].ravel()
            _, counts = np.unique(s[s > conf], return_counts=True)
            tied += int(counts[counts > 1].sum())
            cand = p[p[:, 4:].max(-1) > conf]
            xyxy = torch.from_numpy(np.concatenate([cand[:, :2] - cand[:, 2:4] / 2, cand[:, :2] + cand[:, 2:4] / 2], -1))
            assert np.abs(box_iou(xyxy, xyxy).numpy() - 0.7).min(initial=1.0) > 1e-5
        args = dict(conf_thres=conf, iou_thres=0.7, nc=2, max_det=300, pre_nms_topk=512, multi_label=multi_label)
        out_r, n_r = map(np.asarray, jax_nms(jnp.asarray(preds), **args))
        out, n = non_max_suppression(torch.from_numpy(preds), **args)
        np.testing.assert_array_equal(n.numpy(), n_r)
        np.testing.assert_array_equal(out.numpy(), out_r)
    assert tied >= (0 if conf == CONF else 20)


def test_predict_half_on_cpu_then_f32_again(tmp_path):
    """predict(half=True) runs a bf16 copy of the model and returns f32 boxes;
    the next half=False call on the same YOLO gives exactly the f32 results."""
    iq, _ = synth_iq(np.random.default_rng(0), 256 + 128 * 639)
    np.save(tmp_path / "capture.npy", iq)
    arrays = [np.repeat(synth_frames(1, h, w, seed=i)[0], 3, -1) for i, (h, w) in
              enumerate([(360, 640), (720, 1280), (500, 333)])]
    yolo = YOLO(CKPT, device="cpu")
    for source, batch in ((str(tmp_path / "capture.npy"), 1), (arrays, 2)):
        ref = yolo.predict(source, imgsz=IMGSZ, batch=batch)
        half = yolo.predict(source, imgsz=IMGSZ, batch=batch, half=True)
        assert yolo.predictor.model.dtype == BF16 and yolo.model.dtype == torch.float32
        assert len(half) == len(ref) and sum(map(len, half)) > 0
        for h, r in zip(half, ref):
            assert h.boxes.data.dtype == np.float32 and h.orig_shape == r.orig_shape and h.path == r.path
            assert np.isfinite(h.boxes.data).all()
        again = yolo.predict(source, imgsz=IMGSZ, batch=batch)
        assert yolo.predictor.model is yolo.model
        for a, r in zip(again, ref):
            np.testing.assert_array_equal(a.boxes.data, r.boxes.data)


def _bn_folded_copy(model, half):
    """`half` (model's bf16 copy) with BN folded into every Conv in f32 and the
    folded weight and bias rounded to bf16: the alternative to the port's
    mixed-dtype BN, for the readings below."""
    import copy

    from spectrogram_yolov11_torch.nn.modules.conv import Conv

    folded = copy.deepcopy(half)
    for mod, src in zip(folded.modules(), model.modules()):
        if isinstance(mod, Conv):
            w, b = src.folded()
            mod.conv.weight.data = w.to(BF16)
            mod.conv.bias = torch.nn.Parameter(b.to(BF16))
            mod.bn = torch.nn.Identity()
    return folded


if __name__ == "__main__":  # the head's distance to JAX's bf16 model, 96 px, seeds 0-3
    tree, meta = jax_load_checkpoint(CKPT)
    variables = tree.get("ema") or tree["variables"]
    applies = {name: jax.jit(lambda x, m=jax_build_model(meta["model_yaml"], nc=meta["nc"], verbose=False, dtype=dt):
                             m.apply(variables, x, train=False)) for name, dt in (("bf16", jnp.bfloat16), ("f32", None))}
    model, _ = load_model(CKPT)
    half = model.set_dtype(BF16)
    nets = {"mixed-dtype BN (the port)": half, "BN folded into bf16 weights": _bn_folded_copy(model, half)}

    def flat(feats):
        return np.concatenate([np.asarray(t, np.float32).reshape(t.shape[0], -1) for level in feats for t in level], 1)

    for seed in range(4):
        x = np.random.default_rng(seed).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
        ref = {k: flat(f(jnp.asarray(x))) for k, f in applies.items()}
        line = [f"seed {seed}: JAX bf16 vs f32 max {np.abs(ref['bf16'] - ref['f32']).max():.4g} "
                f"mean {np.abs(ref['bf16'] - ref['f32']).mean():.4g};"]
        for name, net in nets.items():
            with torch.inference_mode():
                got = flat([[t.permute(0, 2, 3, 1).float().numpy() for t in level]
                            for level in net(torch.from_numpy(x).permute(0, 3, 1, 2))])
            line.append(f"{name} vs JAX bf16 max {np.abs(got - ref['bf16']).max():.4g} "
                        f"mean {np.abs(got - ref['bf16']).mean():.4g};")
        print(" ".join(line), flush=True)
