"""Predict's remaining model paths on the port against the JAX package's, on the CPU.

- TTA (augment=True): the port's device function (engine/pipeline.py:
  build_device_fn with augment=True) against JAX's run_tta
  (engine/predictor.py:134-174) on the trained spectrogram_yolo11n at 128
  px, B = 2, on letterboxed synth frames
  picked so that no best-class score of the merged candidates lies within
  1e-4 of conf and no pair of boxes passing conf has an IoU within 1e-5 of
  iou: counts and classes equal, boxes within 1e-3 px, conf within 1e-4,
  in f32. bf16 (half=True) by the existing bf16 rule (tests/test_torch_half.py):
  the merged candidates of the port's bf16 passes within twice JAX's own
  bf16-to-f32 distance of JAX's bf16 ones (JAX's run_tta traced with its
  NMS replaced by the identity gives them). The resize and pad against
  jax.image.resize at 640 -> 531 and 640 -> 428 (within 1e-5; pads of 0.447
  to 544 and 448), the tail clipping's candidate counts (15 049 at 640 px,
  each pass's share), a gray upload equal to its 3-channel copy, and the
  facade's predict(augment=True) equal to the device function.
- Weight ensembles: YOLO([yolo11n.yaml, yolo11_p2_BiFPN.yaml]) (P2
  head: four levels, so the members' anchor lists differ; the port's init
  with seeded BN statistics, carried into JAX's graphs by the reverse bridge)
  against JAX's EnsemblePredictor device function at 64 px: conf set in a
  gap of the merged scores that both members' candidates pass, then the same
  tolerances. The refusals: members of different nc, train().
- visualize=True: the port's file names equal JAX's _visualize_features'
  on the trained model (128 px, one frame; its graph's apply jitted, which
  its eager call would compile op by op), and each PNG's decoded pixels
  within 1 of JAX's cv2.imwrite (the share of unequal pixels printed); the
  stage numbering against the structure of JAX's intermediates
  (jax.eval_shape) for yolo11n.yaml and the P2 fork config.
- Results' tables: to_json, to_df, to_csv, to_xml and to_sql (twice, rows
  appended) equal to JAX's on seeded detections built without a model.
JAX's facade is built with its logging integrations out (the TensorBoard
one imports TensorFlow, 10 s or more); each JAX program compiles once per
module fixture.
"""

import sqlite3
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fork_models import _jax_graph, scaled_bn
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_tpu.engine.predictor as jax_predictor
import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.data.augment import letterbox_batch
from spectrogram_yolov11_torch.data.imageio import imread
from spectrogram_yolov11_torch.data.synth import synth_frames
from spectrogram_yolov11_torch.engine.pipeline import TTA_PAD, normalize, tta_input, tta_predictions
from spectrogram_yolov11_torch.engine.predictor import BasePredictor, EnsemblePredictor, feature_stages
from spectrogram_yolov11_torch.engine.results import Results
from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load
from spectrogram_yolov11_torch.ops.iou import box_iou
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables
from spectrogram_yolov11_tpu import YOLO as JaxYOLO
from spectrogram_yolov11_tpu.engine.results import Results as JaxResults
from spectrogram_yolov11_tpu.ops.nms import non_max_suppression as jax_nms

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
IMGSZ, B, CONF, IOU = 128, 2, 0.25, 0.7
SCORE_MARGIN, IOU_MARGIN = 1e-4, 1e-5
PX_TOL, CONF_TOL = 1e-3, 1e-4
FORK = "yolo11_p2_BiFPN.yaml"
ENS_IMGSZ = 64  # the ensemble's JAX program (two members) compiles in seconds fewer than at 128
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def trained():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        jax_yolo = JaxYOLO(str(CKPT))
    return YOLO(CKPT, device="cpu"), jax_yolo


def _margins_ok(preds: torch.Tensor, conf: float) -> bool:
    """No best-class score within SCORE_MARGIN of conf, and no pair of boxes
    passing conf with an IoU within IOU_MARGIN of IOU."""
    best = preds[..., 4:].max(-1).values
    if (best - conf).abs().min() <= SCORE_MARGIN:
        return False
    for p, s in zip(preds, best):
        p = p[s > conf]
        xyxy = torch.cat([p[:, :2] - p[:, 2:4] / 2, p[:, :2] + p[:, 2:4] / 2], -1)
        if len(p) > 1 and (box_iou(xyxy, xyxy) - IOU).abs().min() <= IOU_MARGIN:
            return False
    return True


@pytest.fixture(scope="module")
def frames(trained):
    """Letterboxed uint8 BGR frames (B, 128, 128, 3) of seeded synth
    spectrograms whose merged TTA candidates keep clear margins and detect."""
    port, _ = trained
    net = port.model.eval()
    for seed in range(50):
        raw = [np.repeat(synth_frames(1, 90, 160, seed=seed * B + i)[0], 3, -1) for i in range(B)]
        x = letterbox_batch(raw, IMGSZ, CPU)
        with torch.inference_mode():
            preds = tta_predictions(net, normalize(x))
        if _margins_ok(preds, CONF) and int((preds[..., 4:].max(-1).values > CONF).sum()) >= 2:
            return x
    raise AssertionError("no seed in 0..49 gives frames with detections and clear margins")


def _assert_same_dets(got, want) -> None:
    """(out, nv) pairs: counts and classes equal, boxes to PX_TOL, conf to CONF_TOL."""
    (go, gn), (wo, wn) = got, want
    gn, wn = np.asarray(gn), np.asarray(wn)
    np.testing.assert_array_equal(gn, wn)
    for i, n in enumerate(wn):
        g, w = np.asarray(go)[i, :n], np.asarray(wo)[i, :n]
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=PX_TOL, rtol=0)
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=CONF_TOL, rtol=0)


def _jax_tta_preds(predictor, x):
    """JAX's run_tta traced with its NMS replaced by the identity: the merged
    candidates (B, A', 4 + nc) of its three passes, for uint8 frames x."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_predictor, "non_max_suppression", lambda preds, **kw: preds)
        return np.asarray(predictor._build_device_fn()(predictor.variables, x), np.float32)


@pytest.fixture(scope="module")
def jax_tta(trained, frames):
    """JAX's TTA on `frames`: its merged candidates in f32 and bf16, and the
    f32 ones through JAX's non_max_suppression at run_tta's settings (predict's:
    best class, pre_nms_topk 1024), which is run_tta's output."""
    _, jax_yolo = trained
    x = jnp.asarray(frames.numpy())
    kw = {"augment": True, "imgsz": IMGSZ, "conf": CONF, "iou": IOU}
    p32 = jax_predictor.BasePredictor(jax_yolo.model, jax_yolo.variables, overrides=kw)
    preds32 = _jax_tta_preds(p32, x)
    from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model

    m16 = jax_build_model(jax_yolo.model.yaml, nc=jax_yolo.model.nc, verbose=False, dtype=jnp.bfloat16)
    preds16 = _jax_tta_preds(jax_predictor.BasePredictor(m16, jax_yolo.variables, overrides={**kw, "half": True}), x)
    nms = jax.jit(lambda p: jax_nms(p, conf_thres=CONF, iou_thres=IOU, nc=jax_yolo.model.nc, multi_label=False,
                                    agnostic=False, max_det=300, classes=None, pre_nms_topk=1024))
    return {"preds": preds32, "preds_bf16": preds16, "out": nms(jnp.asarray(preds32))}


def test_tta_matches_jax_run_tta(trained, frames, jax_tta):
    port, _ = trained
    fn = BasePredictor(port.model, overrides={"augment": True, "imgsz": IMGSZ, "device": "cpu"})._build_device_fn()
    got = fn(frames)
    want = jax_tta["out"]
    print(f"TTA detections per frame {np.asarray(want[1]).tolist()}")
    assert int(np.asarray(want[1]).sum()) >= 2
    _assert_same_dets([t.numpy() for t in got], want)
    gray = fn(frames[..., :1].contiguous())  # the gray upload: one channel, broadcast on the device
    assert all(torch.equal(a, b) for a, b in zip(gray, got))


def test_tta_bf16_within_twice_jax_own_distance(trained, frames, jax_tta):
    port, _ = trained
    want32, want16 = jax_tta["preds"], jax_tta["preds_bf16"]
    with torch.inference_mode():
        got32 = tta_predictions(port.model.eval(), normalize(frames)).numpy()
        got16 = tta_predictions(port.model.set_dtype(torch.bfloat16), normalize(frames)).float().numpy()
    assert got32.shape == want32.shape == got16.shape == want16.shape
    np.testing.assert_allclose(got32, want32, atol=1e-3, rtol=1e-4)
    for part, sl in (("boxes", np.s_[..., :4]), ("scores", np.s_[..., 4:])):
        d_jax = float(np.abs(want16[sl] - want32[sl]).max())
        d_port = float(np.abs(got16[sl] - want16[sl]).max())
        print(f"bf16 TTA {part}: port to JAX bf16 {d_port:.3g}, JAX bf16 to f32 {d_jax:.3g}")
        assert d_port <= 2 * d_jax


def test_tta_resize_and_pad_match_jax_image_resize():
    x = np.random.default_rng(0).uniform(0, 1, (2, 640, 640, 3)).astype(np.float32)
    for si, s_new, pad_to in ((0.83, 531, 544), (0.67, 428, 448)):
        got = tta_input(torch.from_numpy(x), si, False, 32)
        assert tuple(got.shape) == (2, 3, pad_to, pad_to)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, s_new, s_new, 3), method="bilinear"))
        err = float(np.abs(got[:, :, :s_new, :s_new].permute(0, 2, 3, 1).numpy() - want).max())
        print(f"640 -> {s_new}: max |port - jax.image.resize| {err:.3g}")
        assert err <= 1e-5
        assert bool((got[:, :, s_new:] == TTA_PAD).all()) and bool((got[:, :, :, s_new:] == TTA_PAD).all())
    flipped = tta_input(torch.from_numpy(x), 1.0, True, 32)
    assert torch.equal(flipped, torch.from_numpy(x[:, :, ::-1].copy()).permute(0, 3, 1, 2))


def test_tta_tail_clipping_counts(trained):
    port, _ = trained
    net = port.model.eval()
    for s in (IMGSZ, 640):
        with torch.inference_mode():
            n = tta_predictions(net, torch.zeros(1, s, s, 3)).shape[1]
        sizes = [s, -(-int(s * 0.83) // 32) * 32, -(-int(s * 0.67) // 32) * 32]
        counts = [[(z // st) ** 2 for st in (8, 16, 32)] for z in sizes]
        want = counts[0][0] + counts[0][1] + sum(counts[1]) + sum(counts[2][1:])
        assert n == want
        if s == 640:
            assert (n, sizes) == (8000 + 6069 + 980, [640, 544, 448])


def test_tta_through_the_facade(trained, frames):
    port, _ = trained
    raw = [f for f in frames.numpy()]  # already 128 x 128: the letterbox is the identity
    res = port.predict(raw, imgsz=IMGSZ, augment=True, save=False, batch=B)
    fn = port.predictor._build_device_fn()
    out, nv = fn(frames)
    for r, o, n in zip(res, out.numpy(), nv.numpy()):
        np.testing.assert_array_equal(r.boxes.data, o[:n])


# -- weight ensembles -----------------------------------------------------------

def _member(name: str, seed: int, sharp: bool = False):
    """The port's init(seed) of a config at scale n with seeded BN statistics;
    with `sharp` its class logits spread (the head's last class convs' weights
    x 30, biases N(-3, 1)): at init every score sits near the 1e-4 the bias
    gives, within 1e-6 of each other."""
    d = yaml_model_load(name)
    d["scale"] = "n"
    model = build_model(d).init(seed)
    if sharp:
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for branch in model.model[-1].cv3:
                branch[-1].weight.mul_(30.0)
                branch[-1].bias.copy_(torch.randn(branch[-1].bias.shape, generator=g) - 3.0)
    scaled_bn(model, seed)
    return model


@pytest.fixture(scope="module")
def ensemble():
    """The two members (port models, JAX graphs with the bridged weights), the
    frames, and a conf in a gap of the merged best-class scores that some
    candidates of each member pass."""
    members = [_member("yolo11n.yaml", 1, sharp=True), _member(FORK, 2, sharp=True)]
    assert len(members[0].stride) == 3 and len(members[1].stride) == 4
    raw = [np.repeat(synth_frames(1, 90, 160, seed=100 + i)[0], 3, -1) for i in range(B)]
    x = letterbox_batch(raw, ENS_IMGSZ, CPU)
    with torch.inference_mode():
        per = [m(normalize(x).permute(0, 3, 1, 2)) for m in members]
    from spectrogram_yolov11_torch.ops.decode import decode_detections

    preds = [decode_detections(f, m.nc, m.stride) for f, m in zip(per, members)]
    best = torch.cat([p[..., 4:].max(-1).values for p in preds], 1)
    n0 = preds[0].shape[1]
    order = best.flatten().sort(descending=True).values
    conf = None
    for k in range(8, 60):  # the widest relative gap below the k-th score that keeps both members in
        lo, hi = float(order[k]), float(order[k - 1])
        c = (lo * hi) ** 0.5
        passing = (best > c).nonzero()[:, 1]
        if (hi - lo) / hi > 1e-3 and (passing < n0).any() and (passing >= n0).any():
            if _margins_ok(torch.cat(preds, 1), c) and (conf is None or (hi - lo) / hi > conf[1]):
                conf = (c, (hi - lo) / hi)
    assert conf is not None, "no conf separates the members' candidates with clear margins"
    jax_members = []
    for name, m in zip(("yolo11n.yaml", FORK), members):
        graph = _jax_graph(name, "n")
        jax_members.append((type("JaxMember", (), {"nc": m.nc, "stride": m.stride, "apply": graph.apply,
                                                   "names": m.names})(),
                            jax.tree_util.tree_map(jnp.asarray, state_dict_to_variables(m.state_dict()))))
    return members, jax_members, x, conf[0]


def test_ensemble_matches_jax_ensemble_predictor(ensemble):
    members, jax_members, x, conf = ensemble
    port = EnsemblePredictor(members, overrides={"imgsz": ENS_IMGSZ, "conf": conf, "device": "cpu"})
    got = port._build_device_fn()(x)
    jp = jax_predictor.EnsemblePredictor(jax_members, overrides={"imgsz": ENS_IMGSZ, "conf": conf})
    want = jp._build_device_fn()(jp.variables, jnp.asarray(x.numpy()))
    print(f"ensemble at conf {conf:.4g}: detections per frame {np.asarray(want[1]).tolist()}")
    assert int(np.asarray(want[1]).sum()) >= 2
    _assert_same_dets([t.numpy() for t in got], want)


def test_ensemble_facade_and_refusals(tmp_path):
    ens = YOLO(["yolo11n.yaml", FORK], device="cpu")
    assert ens.model is ens._ensemble[0].model and ens.names == ens._ensemble[0].model.names
    frame = np.repeat(synth_frames(1, 90, 160, seed=7)[0], 3, -1)
    res = ens.predict([frame], imgsz=64, conf=1e-6, save=False)
    assert isinstance(ens.predictor, EnsemblePredictor) and len(res) == 1 and len(res[0]) > 0
    with pytest.raises(ValueError, match="inference-only"):
        ens.train(data={"path": str(tmp_path)})
    nc2 = build_model(yaml_model_load("yolo11n.yaml"), nc=2).init(0)
    with pytest.raises(AssertionError, match="share nc"):
        EnsemblePredictor([ens.model, nc2], overrides={"device": "cpu"})
    before = [t.clone() for t in ens._ensemble[0].model.state_dict().values()]
    ens.reset_weights()  # the facade's copy of the lead, not the member (as JAX's facade variables)
    assert ens.model is not ens._ensemble[0].model
    assert all(torch.equal(a, b) for a, b in zip(before, ens._ensemble[0].model.state_dict().values()))


# -- visualize -------------------------------------------------------------------

def test_visualize_writes_jax_files(trained, frames, tmp_path):
    port, jax_yolo = trained
    kw = {"visualize": True, "imgsz": IMGSZ, "project": str(tmp_path), "exist_ok": True}
    jp = jax_predictor.BasePredictor(jax_yolo.model, jax_yolo.variables, overrides={**kw, "name": "jax"})
    graph = jp.model.graph  # its eager apply compiles op by op (about 18 s here): the same apply, jitted
    jitted = jax.jit(lambda v, x: graph.apply(v, x, train=False, capture_intermediates=True,
                                              mutable=["intermediates"]))
    jp.model = type("JaxModel", (), {"graph": type("Graph", (), {"apply": staticmethod(
        lambda v, x, **kw: jitted(v, x))})()})()
    jp._visualize_features(frames[:1].numpy())
    pp = BasePredictor(port.model, overrides={**kw, "name": "port", "device": "cpu"})
    pp._visualize_features(frames[:1])
    want = sorted(p.name for p in (tmp_path / "jax" / "features").iterdir())
    got = sorted(p.name for p in (tmp_path / "port" / "features").iterdir())
    assert got == want and len(want) > 20
    unequal, total, worst = 0, 0, 0
    for name in want:
        a = imread(tmp_path / "port" / "features" / name)
        b = cv2.imread(str(tmp_path / "jax" / "features" / name), cv2.IMREAD_GRAYSCALE)
        assert a.shape[:2] == b.shape, name
        d = np.abs(a[..., 0].astype(int) - b.astype(int)) if a.ndim == 3 else np.abs(a.astype(int) - b.astype(int))
        worst, unequal, total = max(worst, int(d.max())), unequal + int((d > 0).sum()), total + d.size
    print(f"visualize: {len(want)} files, {unequal} of {total} pixels unequal ({unequal / total:.2e}), "
          f"at most {worst} apart")
    assert worst <= 1


def _jax_stage_names(name: str, s: int = 64) -> list:
    """(stage, flax name) of every intermediate JAX's _visualize_features
    writes, from the structure of the graph's intermediates alone."""
    graph = _jax_graph(name, "n")
    model = _member(name, 0)
    variables = jax.tree_util.tree_map(jnp.asarray, state_dict_to_variables(model.state_dict()))
    _, state = jax.eval_shape(lambda v, x: graph.apply(v, x, train=False, capture_intermediates=True,
                                                       mutable=["intermediates"]),
                              variables, jax.ShapeDtypeStruct((1, s, s, 3), jnp.float32))
    out = []
    for stage, (k, node) in enumerate(sorted(state["intermediates"].items())):
        o = node.get("__call__", [None])[0] if isinstance(node, dict) else None
        arr = o[0] if isinstance(o, (tuple, list)) else o
        if getattr(arr, "ndim", 0) == 4:
            out.append((stage, k))
    return out, model


@pytest.mark.parametrize("name", ["yolo11n.yaml", FORK])
def test_visualize_stage_numbering_matches_jax(name):
    want, model = _jax_stage_names(name)
    outs = {}
    hooks = [m.register_forward_hook(lambda mod, a, o, k=k: outs.setdefault(k, o)) for _, k, m in feature_stages(model)]
    with torch.inference_mode():
        model(torch.zeros(1, 3, 64, 64))
    for h in hooks:
        h.remove()
    got = []
    for stage, k, _ in feature_stages(model):
        o = outs[k][0] if isinstance(outs[k], (tuple, list)) else outs[k]
        if torch.is_tensor(o) and o.ndim == 4:
            got.append((stage, k))
    assert got == want and (name != "yolo11n.yaml" or (len(got), got[0], got[-1]) == (
        23, (1, "model_0"), (24, "model_9")))


# -- Results' tables --------------------------------------------------------------

def _seeded_results(seed: int, n: int):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    xy = rng.uniform(0, 40, (n, 2))
    wh = rng.uniform(1, 20, (n, 2))
    boxes = np.concatenate([xy, xy + wh, rng.uniform(0.25, 1, (n, 1)), rng.integers(0, 3, (n, 1))], 1)
    names = {0: "LTE", 1: "RF", 2: "other"}
    boxes = boxes.astype(np.float32)
    return Results(img, "frame.png", names, boxes=boxes), JaxResults(img, "frame.png", names, boxes=boxes)


@pytest.mark.parametrize("n", [0, 1, 5])
def test_tables_match_jax(n, tmp_path):
    got, want = _seeded_results(n, n)
    assert got.to_json() == want.to_json()
    assert got.to_df().equals(want.to_df())
    assert got.to_csv() == want.to_csv() and got.to_csv(index=False) == want.to_csv(index=False)
    assert got.to_xml() == want.to_xml()
    for who, r in (("port", got), ("jax", want)):
        for _ in range(2):  # appended, not replaced
            r.to_sql(db_path=str(tmp_path / f"{who}.db"))
    rows = {}
    for who in ("port", "jax"):
        con = sqlite3.connect(tmp_path / f"{who}.db")
        rows[who] = (con.execute("SELECT sql FROM sqlite_master WHERE name='results'").fetchone(),
                     con.execute("SELECT * FROM results").fetchall())
        con.close()
    assert rows["port"] == rows["jax"] and len(rows["port"][1]) == 2 * n
