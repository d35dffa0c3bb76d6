"""The port's segment trainer, validator, predictor and results against the JAX package's, on the CPU.

A tiny segment model (strided Convs, one C3k2, a Segment head with nm = 8,
npr = 16 over three levels) at 96 px, B = 2: the smallest square size whose
anchors (189) reach the loss's max_fg = 128 cut (jax.lax.top_k refuses fewer).
JAX's init, its BN statistics and class biases moved (scores near 0.5, so
val and predict keep detections) and its coefficient kernels scaled by 10
(masks away from the 0.5 threshold), carried across by the bridge.

- The f32 train step (SGD; an accumulation step at ni = 3, an update at
  ni = 4) against JAX's SegmentationTrainer step: loss items (box, seg,
  cls, dfl) within 1e-5 relative; the grad buffer leaf by leaf within 5e-4
  of each leaf's max |g| (1e-6 of the largest leaf's for a leaf of rounding
  noise, as tests/test_torch_train_step.py); parameters after the update
  within 1e-3 of the leaf's change plus four f32 steps of its largest value.
- The amp step (amp=True) against JAX's compiled amp step, by the distance
  rule of tests/test_torch_train_amp.py: |port bf16 - JAX bf16| <= 3 x
  |port f32 - JAX bf16| + 1e-6 x |JAX bf16|, over the items and the L2 norm
  of all gradient leaves.
- Val on a 4-image shapes-seg split (96 px) whose labels are the port's own
  top detections at conf 0.5 as rectangle polygons (a random model matches
  no drawn shape; these give box and mask matches to score): results_dict
  (box and mask P, R, mAP50, mAP50-95, fitness) and the save_json COCO
  stats of both protocols within 1e-4 of JAX's; the mask TP matrix equal;
  results.csv's columns of a segment training run are JAX's.
- Predict on three arrays of odd sizes: per image, the detections equal in
  count and class, boxes within 1e-3 px, the masks' unequal pixels at most
  1e-3 of all (the cv2 float resize's sums round differently, ops/masks.py;
  measured 0); Results.plot with masks byte-equal to JAX's on the same
  detections and masks (labels off: the port's label font is its own,
  tests/test_torch_plot.py).
- The facade and the CLI: YOLO("yolo11n-seg.yaml") is a segment model whose
  training runs under runs/segment; `segment val` goes through
  cfg.entrypoint; pose, OBB and classify, Masks.xy, save_txt of masks, a
  served segment model and a segment ensemble raise as tabled.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import _flax, _leaves, one_torch_thread  # noqa: F401 (autouse)

import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.cfg import entrypoint
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.engine.results import Results
from spectrogram_yolov11_torch.engine.predictor import SegmentationPredictor
from spectrogram_yolov11_torch.engine.trainer import SegmentationTrainer
from spectrogram_yolov11_torch.engine.validator import SegmentationValidator
from spectrogram_yolov11_torch.nn.autobackend import AutoBackend
from spectrogram_yolov11_torch.nn.tasks import build_model
from spectrogram_yolov11_tpu.engine import optim as jopt
from spectrogram_yolov11_tpu.engine.predictor import SegmentationPredictor as JaxSegmentationPredictor
from spectrogram_yolov11_tpu.engine.results import Results as JaxResults
from spectrogram_yolov11_tpu.engine.trainer import SegmentationTrainer as JaxSegmentationTrainer
from spectrogram_yolov11_tpu.engine.validator import SegmentationValidator as JaxSegmentationValidator
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_tpu.ops.metrics import SegmentMetrics as JaxSegmentMetrics

TINY_SEG = {"nc": 2, "scales": {"t": [1.0, 1.0, 1024]}, "scale": "t",
            "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                         [-1, 1, "C3k2", [16, True]], [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]]],
            "head": [[[3, 4, 5], 1, "Segment", ["nc", 8, 16]]]}
NB, IMGSZ, BATCH = 50, 96, 2
STEPS = ((3, False), (4, True))
ITEMS_RTOL, GRAD_FRAC, ZERO_LEAF = 1e-5, 5e-4, 1e-6
MULTIPLE, FLOOR = 3, 1e-6
VAL_TOL, BOX_TOL, MASK_SHARE = 1e-4, 1e-3, 1e-3
XLA_OPTIONS = {"xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg96")
    d = {"path": str(root), "train": "images/train", "val": "images/val", "synthetic": "shapes-seg",
         "n_train": 4, "n_val": 4, "gen_imgsz": IMGSZ, "seed": 0, "names": {0: "blob", 1: "ellipse"}}
    check_det_dataset(d)
    return d


@pytest.fixture(scope="module")
def variables():
    jm = jax_build_model(dict(TINY_SEG), nc=2, verbose=False)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), imgsz=IMGSZ))
    rng = np.random.default_rng(1)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.min() > 0.5 else rng.normal(0, 0.1, a.shape)).astype(np.float32),
        v["batch_stats"])
    head = v["params"]["model_6"]
    for i in range(3):
        head["detect"][f"cv3_{i}_2"]["bias"] = np.zeros_like(head["detect"][f"cv3_{i}_2"]["bias"])
        head[f"cv4_{i}_2"]["kernel"] = head[f"cv4_{i}_2"]["kernel"] * np.float32(10)
    return v


def _batch(seed=2, g=5):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 2, (BATCH, g)).astype(np.int32)
    xy, wh = rng.uniform(0.3, 0.7, (BATCH, g, 2)), rng.uniform(0.1, 0.4, (BATCH, g, 2))
    bboxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.arange(g)[None] < np.array([[4], [2]])
    bboxes[~mask], cls[~mask] = 0, 0
    masks = np.zeros((BATCH, IMGSZ // 4, IMGSZ // 4), np.int32)
    for b in range(BATCH):
        for j in np.nonzero(mask[b])[0]:
            x, y, w, h = bboxes[b, j] * (IMGSZ // 4)
            masks[b, int(y - h / 2) : int(y + h / 2), int(x - w / 2) : int(x + w / 2)] = j + 1
    return {"img": rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8), "cls": cls, "bboxes": bboxes,
            "mask_gt": mask, "masks": masks}


def _jax_steps(data, variables, amp):
    """JAX's SegmentationTrainer step, compiled once, on the state its train() builds."""
    overrides = dict(data=data, imgsz=IMGSZ, batch=BATCH, amp=amp, optimizer="SGD", workers=1,
                     project=str(data["path"]), exist_ok=True, plots=False)
    with pytest.MonkeyPatch.context() as mp:  # the JAX trainer's logging integrations touch no result
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        jt = JaxSegmentationTrainer(overrides=overrides, model=jax_build_model(dict(TINY_SEG), nc=2, verbose=False),
                                    variables=variables)
    jt.setup_model()
    wd = float(jt.args.weight_decay) * BATCH * max(round(jt.args.nbs / BATCH), 1) / jt.args.nbs
    opt = jopt.choose_optimizer(jt.args, 2, NB)
    groups = jopt.param_groups(variables["params"])
    spec = jopt.make_flat_spec(variables["params"], groups)
    copy = lambda t: jax.tree_util.tree_map(lambda x: jnp.array(x, jnp.float32, copy=True), t)  # noqa: E731
    state = {"params": copy(variables["params"]), "batch_stats": copy(variables["batch_stats"]),
             "opt": jopt.init_opt_state_flat(spec), "grad_buf": jnp.zeros((spec.n,), jnp.float32),
             "ema": {"params": copy(variables["params"]), "batch_stats": copy(variables["batch_stats"])},
             "ema_updates": jnp.asarray(0, jnp.int32)}
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    args = (jnp.asarray(STEPS[0][0], jnp.int32), jnp.asarray(STEPS[0][1]))
    step = jt._make_train_step(opt, groups, wd).lower(state, batch, *args).compile(compiler_options=XLA_OPTIONS)
    out = {"items": []}
    for ni, do_step in STEPS:
        state, _, items = step(state, batch, jnp.asarray(ni, jnp.int32), jnp.asarray(do_step))
        out["items"].append(np.asarray(items))
        if not do_step:
            out["grads"] = dict(_leaves(jopt.unflatten_tree(state["grad_buf"], spec)))
    out["params"] = dict(_leaves(state["params"]))
    return out


def _port_steps(data, variables, amp):
    t = SegmentationTrainer(build_model(dict(TINY_SEG), nc=2, variables=variables),
                            dict(data=data, imgsz=IMGSZ, batch=BATCH, amp=amp, optimizer="SGD", device="cpu"))
    t.setup_model()
    t.setup_optimizer(NB)
    out = {"items": []}
    for ni, do_step in STEPS:
        out["items"].append(t.train_step(_batch(), ni, do_step)[1].numpy())
        if not do_step:
            out["grads"] = _flax(t.param_names, t.state["grad_buf"])
    out["params"] = _flax(t.param_names, t.params)
    return out


@pytest.fixture(scope="module")
def steps(data, variables):
    return {"jax_f32": _jax_steps(data, variables, False), "port_f32": _port_steps(data, variables, False),
            "jax_amp": _jax_steps(data, variables, True), "port_amp": _port_steps(data, variables, True)}


def test_f32_train_step_equals_jax(steps, variables):
    got, ref = steps["port_f32"], steps["jax_f32"]
    for p, j in zip(got["items"], ref["items"]):
        print(f"items {p.tolist()} (JAX {j.tolist()})")
        assert p.shape == (4,)
        np.testing.assert_allclose(p, j, rtol=ITEMS_RTOL, atol=0)
    assert got["grads"].keys() == ref["grads"].keys()
    top = max(np.abs(g).max() for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        scale = np.abs(g).max()
        tol = GRAD_FRAC * scale if scale > ZERO_LEAF * top else ZERO_LEAF * top
        np.testing.assert_allclose(got["grads"][k], g, atol=tol, rtol=0, err_msg=k)
    init = dict(_leaves(variables["params"]))
    for k, p in ref["params"].items():
        change, big = np.abs(p - init[k]).max(), np.abs(p).max()
        np.testing.assert_allclose(got["params"][k], p, atol=1e-3 * change + 4 * np.spacing(np.float32(big)), rtol=0,
                                   err_msg=k)


def _norm(d: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(d[k], np.float64).ravel() for k in keys])


def test_amp_train_step_within_jax_bf16_distance(steps):
    p16, f32, j16 = steps["port_amp"], steps["port_f32"], steps["jax_amp"]
    for got, yard, ref in zip(p16["items"], f32["items"], j16["items"]):
        err, bound = np.abs(got - ref).max(), MULTIPLE * np.abs(yard - ref).max() + FLOOR * np.abs(ref).max()
        print(f"amp items {got.tolist()} (JAX {ref.tolist()}; port f32 {yard.tolist()})")
        assert err <= bound, (err, bound)
    keys = sorted(j16["grads"])
    ref = _norm(j16["grads"], keys)
    err = np.linalg.norm(_norm(p16["grads"], keys) - ref)
    bound = MULTIPLE * np.linalg.norm(_norm(f32["grads"], keys) - ref) + FLOOR * np.linalg.norm(ref)
    print(f"amp grads: |port bf16 - JAX bf16| {err:.4g}, bound {bound:.4g}")
    assert err <= bound


# -- val and predict ---------------------------------------------------------------

@pytest.fixture(scope="module")
def models(variables):
    jm = jax_build_model(dict(TINY_SEG), nc=2, verbose=False)
    tm = build_model(dict(TINY_SEG), nc=2, variables=variables)
    tm.names = dict(jm.names)
    return jm, tm


def _self_labelled(data: dict, tm, root: Path) -> dict:
    """A copy of the val split labelled with the port's detections at conf 0.5
    (at most 6 per image), each box written as its rectangle's polygon."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    pred = SegmentationPredictor(tm, overrides=dict(imgsz=IMGSZ, conf=0.5, max_det=6, save=False, device="cpu"))
    for f in sorted(Path(data["path"], "images", "val").glob("*.jpg")):
        (root / "images" / f.name).write_bytes(f.read_bytes())
        (r,) = pred(str(f))
        h, w = r.orig_shape
        rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in (x1 / w, y1 / h, x2 / w, y1 / h, x2 / w, y2 / h, x1 / w,
                                                                y2 / h))
                for (x1, y1, x2, y2), c in zip(r.boxes.xyxy, r.boxes.cls)]
        (root / "labels" / f"{f.stem}.txt").write_text("\n".join(rows))
    return {"path": str(root), "train": "images", "val": "images", "names": data["names"]}


@pytest.fixture(scope="module")
def vals(data, variables, models, tmp_path_factory):
    jm, tm = models
    root = tmp_path_factory.mktemp("seg_val")
    data = _self_labelled(data, tm, root / "split")
    kw = dict(data=data, imgsz=IMGSZ, batch=BATCH, plots=False, save_json=True, workers=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        jv = JaxSegmentationValidator(jm, variables, overrides=dict(kw, project=str(root / "jax")))
        jres = jv(data)
    pv = SegmentationValidator(tm, overrides=dict(kw, project=str(root / "port"), device="cpu"))
    return pv(data), pv, jres, jv


def test_val_box_and_mask_map_equal_jax(vals):
    got, pv, ref, jv = vals
    assert list(got) == list(ref) and "metrics/mAP50-95(M)" in got and "metrics/coco_AP(M)" in got
    for k, v in ref.items():
        assert abs(got[k] - v) <= VAL_TOL, (k, got[k], v)
    tp_m = np.concatenate(pv.stats["tp_m"])
    np.testing.assert_array_equal(tp_m, np.concatenate(jv.stats["tp_m"]))
    print({k: round(v, 5) for k, v in got.items()})
    assert len(tp_m) > 50 and tp_m[:, 0].any() and got["metrics/mAP50(B)"] > 0.5 and got["metrics/mAP50(M)"] > 0


def _arrays():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((70, 90), (96, 64), (120, 150))]


@pytest.fixture(scope="module")
def predictions(variables, models):
    jm, tm = models
    kw = dict(imgsz=IMGSZ, conf=0.3, save=False)
    ref = JaxSegmentationPredictor(jm, variables, overrides=kw)(_arrays())
    got = SegmentationPredictor(tm, overrides=dict(kw, device="cpu"), names=dict(jm.names))(_arrays(), batch_size=2)
    return got, ref


def test_predict_masks_match_jax(predictions):
    got, ref = predictions
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert len(g) == len(r) > 0
        np.testing.assert_array_equal(g.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(g.boxes.xyxy, r.boxes.xyxy, atol=BOX_TOL, rtol=0)
        assert g.masks.data.dtype == r.masks.data.dtype == bool and g.masks.data.shape == r.masks.data.shape
        share = float((g.masks.data != r.masks.data).mean())
        print(f"{g.orig_shape}: {len(g)} masks, {g.masks.data.sum()} pixels set, unequal share {share:.2e}")
        assert share <= MASK_SHARE and g.masks.data.any()


def test_results_plot_with_masks_equals_jax(predictions):
    _, ref = predictions
    for r in ref:
        ours = Results(r.orig_img, r.path, r.names, boxes=r.boxes.data, masks=r.masks.data)
        for lw in (None, 1):
            got, want = ours.plot(line_width=lw, show_labels=False), r.plot(line_width=lw, show_labels=False)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(ours[1:3].masks.data, r.masks.data[1:3]) and len(ours[1:3]) == 2
    sel = Results(ref[0].orig_img, "x", ref[0].names)
    sel.update(boxes=ref[0].boxes.data, masks=ref[0].masks.data)
    jsel = JaxResults(ref[0].orig_img, "x", ref[0].names)
    jsel.update(boxes=ref[0].boxes.data, masks=ref[0].masks.data)
    assert np.array_equal(sel.plot(show_labels=False), jsel.plot(show_labels=False))


# -- the facade, the CLI and the refusals ---------------------------------------------

def test_facade_trains_vals_and_refuses_as_tabled(data, tmp_path, predictions):
    m = YOLO("yolo11n-seg.yaml", device="cpu")
    assert m.task == "segment" and m.overrides["task"] == "segment"
    m.model = build_model(dict(TINY_SEG), nc=2).init(0)  # the trainer rebuilds nothing: same nc
    res = m.train(data=data, epochs=1, batch=BATCH, imgsz=IMGSZ, plots=False, project=str(tmp_path / "runs"),
                  name="seg", workers=1, amp=False)
    header = (tmp_path / "runs" / "seg" / "results.csv").read_text().splitlines()[0].split(",")
    assert header == ["epoch", *(f"train/{n}" for n in JaxSegmentationTrainer.loss_names.fget(None)),
                      *JaxSegmentMetrics().keys, "fitness"]
    assert list(res) == [*JaxSegmentMetrics().keys, "fitness"]
    ckpt = tmp_path / "runs" / "seg" / "weights" / "last.ckpt"
    out = entrypoint(f"yolo segment val model={ckpt} data={data['path']}/d.yaml imgsz={IMGSZ} batch=2 device=cpu "
                     f"plots=False project={tmp_path / 'cli'}") if _write_yaml(data) else None
    assert list(out) == list(res)
    assert YOLO("yolo11n-cls.yaml").task == "classify"  # since the classify slice (tests/test_torch_classify*.py)
    got, _ = predictions
    with pytest.raises(NotImplementedError, match="item 10"):
        got[0].masks.xy
    with pytest.raises(NotImplementedError, match="item 10"):
        got[0].save_txt(tmp_path / "x.txt")
    # a segment model serves since the serving slice (tests/test_torch_serve_tasks.py): predictions with the
    # mask coefficients, and the prototypes NHWC
    preds, proto = AutoBackend("yolo11n-seg.yaml", device="cpu").forward(np.zeros((1, 64, 64, 3), np.uint8))
    assert preds.shape == (1, 84, 4 + 80 + 32) and proto.shape == (1, 16, 16, 32)
    with pytest.raises(AssertionError, match="detect task"):
        YOLO([str(ckpt), str(ckpt)])


def _write_yaml(data: dict) -> bool:
    names = "\n".join(f"  {k}: {v}" for k, v in data["names"].items())
    (Path(data["path"]) / "d.yaml").write_text(f"path: {data['path']}\ntrain: images/train\nval: images/val\n"
                                               f"names:\n{names}\n")
    return True
