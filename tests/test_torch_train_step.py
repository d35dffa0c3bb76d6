"""The port's detect training step against the JAX package's train_step, f32 on the CPU.

Two models, each with its JAX step compiled once per module fixture: a tiny
detect model (strided Convs, one C3k2 whose C3k holds two same-width 3x3
bottlenecks at C = 4, gated: the kernel takes C in ops/fused_conv.py:CHANNELS,
so they run their two convs in eval too; a Detect head; random JAX init with
random BN statistics),
stepped with SGD; and the trained spectrogram_yolo11n at full width and depth,
stepped with optimizer=auto (AdamW). Both at 64 px, B = 2, on one seeded
batch with padded GT rows, weights carried across by the bridge. Each takes
an accumulation step at ni = 3 with do_step=False, then one at ni = 4 with
do_step=True (lr != 0 in the warmup; nb = 50, so 150 warmup iterations).

Tolerances, with the values a CPU run measured:
- loss items: 1e-5 relative for the tiny model (3e-6), 1e-4 for the trained
  one (2e-5: its deepest BN layers normalise over 8 values at 64 px, B = 2);
- per-leaf grads (the grad buffer after the accumulation step): within
  5e-4 of each leaf's max |g| (7.8e-5 and 1.4e-4). A leaf whose max |g| is
  below 1e-6 of the largest leaf's has a gradient that cancels analytically
  (a BN bias whose every consumer is a 1x1 conv into training-mode BN, in
  C2PSA at 2x2) and holds only rounding: it is held within 1e-6 of the
  largest leaf's max instead;
- params and the EMA of them: within 1e-3 of the leaf's largest change plus
  four f32 steps of its largest value. With AdamW the first step is
  lr * g / (|g| + eps): an element whose |g| lies within the grads' noise
  can step the other way, so elements past that bound are held within
  2 lr of JAX's instead, and their share (reported) stays under 1 %;
- first moments as the grads; second moments within 1e-3 of the leaf's max;
- BN running statistics and their EMA within 1e-5 of the leaf's max (2e-6);
- the grad buffer zero after the step; the update and step counts equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint
from spectrogram_yolov11_torch.engine.optim import lr_at
from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer
from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
from spectrogram_yolov11_torch.nn.modules.conv import Conv
from spectrogram_yolov11_torch.nn.tasks import build_model
from spectrogram_yolov11_torch.ops.fused_conv import pack_bottleneck_weights
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables, variables_to_state_dict
from spectrogram_yolov11_tpu.engine import optim as jopt
from spectrogram_yolov11_tpu.engine.trainer import DetectionTrainer as JaxDetectionTrainer
from spectrogram_yolov11_tpu.nn.modules.conv import Conv as JaxConv
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
TINY = {"nc": 2, "scales": {"t": [1.0, 1.0, 1024]}, "scale": "t",
        "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                     [-1, 1, "C3k2", [16, True]], [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]]],
        "head": [[[3, 4, 5], 1, "Detect", ["nc"]]]}
NB, IMGSZ, BATCH = 50, 64, 2
STEPS = ((3, False), (4, True))
ITEMS_RTOL = {"tiny": 1e-5, "trained": 1e-4}
GRAD_FRAC, ZERO_LEAF, NU_FRAC, STATS_FRAC, FLIP_SHARE = 5e-4, 1e-6, 1e-3, 1e-5, 0.01


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work on the CPU, the setting
    restored after. The tier-1 run shares the machine's cores among its
    workers; torch's thread pool, one thread per core in each worker, then
    slows every worker. Other heavy port test modules import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth64")
    d = {"path": str(root), "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
         "n_train": 0, "n_val": 2, "gen_imgsz": IMGSZ, "seed": 0, "names": {0: "LTE", 1: "RF"}}
    check_det_dataset(d)
    return d


def _batch(seed=2, g=6):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 2, (BATCH, g)).astype(np.int32)
    xy, wh = rng.uniform(0.2, 0.8, (BATCH, g, 2)), rng.uniform(0.05, 0.4, (BATCH, g, 2))
    bboxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.arange(g)[None] < np.array([[4], [2]])
    bboxes[~mask], cls[~mask] = 0, 0
    return {"img": rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8), "cls": cls, "bboxes": bboxes,
            "mask_gt": mask}


def _leaves(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + (k,))
        else:
            yield "/".join(pre + (k,)), np.asarray(v)


def _flax(names, tensors, kind="params"):
    return dict(_leaves(state_dict_to_variables(dict(zip(names, tensors)))[kind]))


def _run(data, cfg, variables, optimizer):
    """Both steps on both sides: JAX's jitted train_step from the JAX trainer,
    with the state its train() builds, and the port's DetectionTrainer."""
    overrides = dict(data=data, imgsz=IMGSZ, batch=BATCH, amp=False, optimizer=optimizer, workers=1)
    with pytest.MonkeyPatch.context() as mp:  # the JAX trainer's logging integrations touch no result
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        jt = JaxDetectionTrainer(overrides=dict(overrides, project=str(data["path"]), exist_ok=True, plots=False),
                                 model=jax_build_model(dict(cfg), nc=2, verbose=False), variables=variables)
    jt.setup_model()
    accumulate = max(round(jt.args.nbs / BATCH), 1)
    wd = float(jt.args.weight_decay) * BATCH * accumulate / jt.args.nbs
    opt = jopt.choose_optimizer(jt.args, 2, NB)
    groups = jopt.param_groups(variables["params"])
    spec = jopt.make_flat_spec(variables["params"], groups)
    copy = lambda t: jax.tree_util.tree_map(lambda x: jnp.array(x, jnp.float32, copy=True), t)  # noqa: E731
    state = {"params": copy(variables["params"]), "batch_stats": copy(variables["batch_stats"]),
             "opt": jopt.init_opt_state_flat(spec), "grad_buf": jnp.zeros((spec.n,), jnp.float32),
             "ema": {"params": copy(variables["params"]), "batch_stats": copy(variables["batch_stats"])},
             "ema_updates": jnp.asarray(0, jnp.int32)}
    step = jt._make_train_step(opt, groups, wd)

    port = DetectionTrainer(build_model(cfg, nc=2, variables=variables), dict(overrides, device="cpu"))
    port.setup_model()
    port.setup_optimizer(NB)
    assert port.opt == opt and port.wd_scaled == wd
    batch = _batch()
    out = {"items": [], "lr": dict(zip(("main", "bias"), lr_at(opt, STEPS[-1][0])))}
    for ni, do_step in STEPS:
        state, loss, items = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(ni, jnp.int32),
                                  jnp.asarray(do_step))
        p_loss, p_items = port.train_step(batch, ni, do_step)
        out["items"].append((p_items.numpy(), np.asarray(items), float(p_loss), float(loss)))
        if not do_step:
            out["grads"] = (_flax(port.param_names, port.state["grad_buf"]),
                            dict(_leaves(jopt.unflatten_tree(state["grad_buf"], spec))))
    st = port.state
    out["port"] = {"params": _flax(port.param_names, port.params),
                   "mu": _flax(port.param_names, st["opt"]["mu"]), "nu": _flax(port.param_names, st["opt"]["nu"]),
                   "batch_stats": _flax(port.stat_names, port.stats, "batch_stats"),
                   "ema_params": _flax(port.param_names, st["ema"]["params"]),
                   "ema_batch_stats": _flax(port.stat_names, st["ema"]["batch_stats"], "batch_stats")}
    out["jax"] = {"params": dict(_leaves(state["params"])),
                  "mu": dict(_leaves(jopt.unflatten_tree(state["opt"].mu, spec))),
                  "nu": dict(_leaves(jopt.unflatten_tree(state["opt"].nu, spec))),
                  "batch_stats": dict(_leaves(state["batch_stats"])),
                  "ema_params": dict(_leaves(state["ema"]["params"])),
                  "ema_batch_stats": dict(_leaves(state["ema"]["batch_stats"]))}
    out["init"] = dict(_leaves(variables["params"]))
    out["groups"] = dict(_leaves(groups))
    out["counts"] = ((st["ema_updates"], st["opt"]["step"], max(float(b.abs().max()) for b in st["grad_buf"])),
                     (int(state["ema_updates"]), int(state["opt"].step), float(jnp.abs(state["grad_buf"]).max())))
    out["kind"] = opt.kind
    return out


@pytest.fixture(scope="module")
def tiny(data):
    jm = jax_build_model(dict(TINY), nc=2, verbose=False)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), imgsz=IMGSZ))
    rng = np.random.default_rng(1)  # BN statistics away from 0 and 1, so their EMA and the update are seen
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.min() > 0.5 else rng.normal(0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return _run(data, TINY, variables, "SGD")


@pytest.fixture(scope="module")
def trained(data):
    tree, meta = load_checkpoint(CKPT)
    return _run(data, meta["model_yaml"], tree.get("ema") or tree["variables"], "auto")


@pytest.fixture(params=["tiny", "trained"])
def run(request):
    return request.param, request.getfixturevalue(request.param)


def test_loss_items_and_grads_equal_jax(run):
    name, r = run
    for p_items, j_items, p_loss, j_loss in r["items"]:
        print(f"{name}: items {p_items.tolist()} (JAX {j_items.tolist()})")
        np.testing.assert_allclose(p_items, j_items, rtol=ITEMS_RTOL[name], atol=0)
        np.testing.assert_allclose(p_loss, j_loss, rtol=ITEMS_RTOL[name])
    got, ref = r["grads"]
    assert got.keys() == ref.keys()
    top = max(np.abs(g).max() for g in ref.values())
    worst = 0.0
    for k, g in ref.items():
        scale = np.abs(g).max()
        tol = GRAD_FRAC * scale if scale >= ZERO_LEAF * top else ZERO_LEAF * top
        err = np.abs(got[k] - g).max()
        assert err <= tol, (k, err, scale, top)
        worst = max(worst, err / scale) if scale >= ZERO_LEAF * top else worst
    print(f"{name}: {len(ref)} grad leaves, worst error {worst:.1e} of the leaf's max |g|")


def test_step_state_equals_jax(run):
    name, r = run
    got, ref, init = r["port"], r["jax"], r["init"]
    assert r["kind"] == ("sgd" if name == "tiny" else "adamw")
    (p_upd, p_step, p_buf), (j_upd, j_step, j_buf) = r["counts"]
    assert (p_upd, p_step, p_buf) == (j_upd, j_step, j_buf) == (1, 1, 0.0)
    top_mu = max(np.abs(g).max() for g in ref["mu"].values())
    top_nu = max(np.abs(g).max() for g in ref["nu"].values())
    flipped = total = 0
    for key in ("params", "ema_params"):
        for k, j in ref[key].items():
            change = np.abs(j - init[k]).max()
            err = np.abs(got[key][k] - j)
            tight = 1e-3 * change + 4 * np.spacing(np.abs(j).max())
            lr = r["lr"]["bias" if r["groups"][k] == "bias" else "main"]
            if r["kind"] == "adamw":
                loose = err > tight
                flipped += int(loose.sum()) if key == "params" else 0
                assert (err[loose] <= 2 * lr + 4 * np.spacing(np.abs(j).max())).all(), (key, k)
            else:
                assert (err <= tight).all(), (key, k, err.max(), tight)
            total += j.size if key == "params" else 0
    share = flipped / total
    print(f"{name}: {flipped} of {total} parameter elements ({share:.3%}) past the tight bound, within 2 lr")
    assert share <= FLIP_SHARE
    for k, j in ref["mu"].items():
        scale = np.abs(j).max()
        tol = GRAD_FRAC * scale if scale >= ZERO_LEAF * top_mu else ZERO_LEAF * top_mu
        assert np.abs(got["mu"][k] - j).max() <= tol, ("mu", k)
    for k, j in ref["nu"].items():
        tol = max(NU_FRAC * np.abs(j).max(), ZERO_LEAF**2 * top_nu)
        assert np.abs(got["nu"][k] - j).max() <= tol, ("nu", k)
    for key in ("batch_stats", "ema_batch_stats"):
        for k, j in ref[key].items():
            assert np.abs(got[key][k] - j).max() <= STATS_FRAC * np.abs(j).max(), (key, k)


def test_bn_trains_with_flax_semantics():
    """A Conv in training mode against the JAX Conv with mutable batch_stats:
    the output (biased batch variance) and the running statistics after one
    step (0.97 / 0.03 with the biased variance, not torch's momentum 0.1 and
    unbiased variance)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 2, (2, 6, 5, 4)).astype(np.float32)  # NHWC: 60 values per channel
    jm = JaxConv(4, 8, 3, 1)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables["batch_stats"]["bn"] = {"mean": rng.normal(0, 1, 8).astype(np.float32),
                                      "var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    ref, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    conv = Conv(4, 8, 3, 1)
    conv.load_state_dict({k: v for k, v in variables_to_state_dict(variables).items()})
    conv.train()
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(conv.bn.running_mean.numpy(), mut["batch_stats"]["bn"]["mean"], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(conv.bn.running_var.numpy(), mut["batch_stats"]["bn"]["var"], atol=1e-6, rtol=1e-6)


def test_eval_refolds_moved_weights_and_the_bridge_inverts():
    """After the weights move in training mode, eval() packs the bottleneck
    kernel's weights from the moved ones, so the eval forward equals that of
    a model freshly loaded with them; state_dict_to_variables inverts the
    bridge leaf for leaf."""
    tree, meta = load_checkpoint(CKPT)
    variables = tree.get("ema") or tree["variables"]
    back = dict(_leaves(state_dict_to_variables(build_model(meta["model_yaml"], nc=2, variables=variables).state_dict())))
    ref = dict(_leaves(variables))
    assert back.keys() == ref.keys() and all(np.array_equal(back[k], ref[k]) for k in ref)

    # TINY with its C3k2 at width 128, so its C3k's two bottlenecks (C = 32) are fused
    fusable = dict(TINY, backbone=[*TINY["backbone"][:3], [-1, 1, "C3k2", [128, True]], *TINY["backbone"][4:]])
    model = build_model(fusable, variables=jax.tree_util.tree_map(
        np.asarray, jax_build_model(dict(fusable), nc=2, verbose=False).init(jax.random.PRNGKey(3), imgsz=IMGSZ)))
    model.train()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
        model(torch.rand(2, 3, IMGSZ, IMGSZ))  # moves the running statistics
    model.eval()
    fused = [m for m in model.modules() if isinstance(m, Bottleneck) and m.fusable]
    assert len(fused) == 2
    for m in fused:
        w1, _ = m.cv1.folded()
        assert torch.equal(m.w1, pack_bottleneck_weights(w1.permute(2, 3, 1, 0)).view_as(m.w1))
    fresh = build_model(fusable, variables=state_dict_to_variables(model.state_dict()))
    x = torch.rand(2, 3, IMGSZ, IMGSZ)
    with torch.no_grad():
        for (a, b), (c, d) in zip(model(x), fresh(x)):
            assert torch.equal(a, c) and torch.equal(b, d)


def test_trainer_refuses_amp_and_yolo_train_refuses(data):
    """amp=True, the default, is accepted (bf16 compute, tests/test_torch_train_amp.py);
    so are batch=-1 (AutoBatch picks the batch in train()), profile=True and
    plots=True, the default (tests/test_torch_artifacts.py runs them); host
    augmentation still raises (tests/test_torch_train_loop.py)."""
    model = build_model(TINY)
    t = DetectionTrainer(model, dict(data=data, device="cpu"))
    assert t.args.amp is True and t.compute_dtype == torch.bfloat16 and t.args.plots is True
    assert DetectionTrainer(model, dict(data=data, device="cpu", batch=-1)).batch_size == -1
    assert DetectionTrainer(model, dict(data=data, device="cpu", profile=True)).args.profile is True
    assert DetectionTrainer(model, dict(data=data, device="cpu", plots=False)).args.plots is False
    t = DetectionTrainer(model, dict(data=data, device="cpu", amp=False, batch=16))
    t.setup_model()
    t.setup_optimizer(nb=8)  # 100 warmup iterations; accumulate ramps 1 -> 4 over them, then stays 4
    due = [ni for ni in range(120) if t.step_due(ni)]
    assert due[:17] == list(range(17)) and due[-3:] == [111, 115, 119]
    assert all(b - a in (1, 2, 3, 4) for a, b in zip(due, due[1:]))


def test_val_and_predict_after_a_step_run_the_moved_weights_in_eval_mode(data):
    """A train step on YOLO(ckpt).model leaves that model in training mode with
    moved weights and BN statistics. val() and predict() (whose predictor was
    built before the step) then put it in eval mode, which folds the
    bottlenecks from the moved weights, and give exactly what a fresh eval
    model loaded with those weights gives; neither moves a weight or a BN
    statistic. Predict keeps every candidate above conf 0.001, so its scores
    would show BN on batch statistics."""
    yolo, fresh = YOLO(CKPT, device="cpu"), YOLO(CKPT, device="cpu")
    frame = np.ascontiguousarray(_batch()["img"][0][..., ::-1])  # BGR, as predict takes arrays
    kw = {"imgsz": IMGSZ, "device": "cpu", "save": False, "plots": False}
    yolo.predict(frame, conf=0.001, **kw)
    t = DetectionTrainer(yolo.model, dict(data=data, device="cpu", amp=False, imgsz=IMGSZ, batch=BATCH))
    t.setup_model()
    t.setup_optimizer(NB)
    before = {k: v.clone() for k, v in yolo.model.state_dict().items()}
    t.train_step(_batch(), 4, True)
    moved = {k: v.clone() for k, v in yolo.model.state_dict().items()}
    assert yolo.model.training and any(not torch.equal(before[k], moved[k]) for k in moved)

    val = yolo.val(data=data, batch=BATCH, **kw)
    assert not yolo.model.training
    yolo.model.train()  # back in training mode before predict, as a trainer leaves it
    boxes = yolo.predict(frame, conf=0.001, **kw)[0].boxes.data
    assert not yolo.model.training
    assert all(torch.equal(v, moved[k]) for k, v in yolo.model.state_dict().items())

    fresh.model.load_state_dict(moved)
    assert val == fresh.val(data=data, batch=BATCH, **kw)
    ref = fresh.predict(frame, conf=0.001, **kw)[0].boxes.data
    assert len(boxes) > 0 and np.array_equal(boxes, ref)
