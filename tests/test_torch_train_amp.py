"""bf16 training (amp=True, the default) on the port against the JAX package's, on the CPU.

JAX's amp=True computes in bf16 with f32 parameters: flax casts each conv's
input and f32 kernel to bf16, BN in training runs in f32 on the conv output,
SiLU in f32, and the result is rounded to bf16. The port is held to JAX by
distances, not a fixed epsilon: per quantity,

    |port bf16 - JAX bf16| <= MULTIPLE * yardstick + floor,

where the yardstick is |port f32 - JAX bf16| (the port's f32 step, which
tests/test_torch_train_step.py holds to JAX's f32 step within 1e-4
relative), and for the loss items the larger of that and JAX's own scatter
between its compiled step and its graph applied op by op.

- Modules in training at bf16 against JAX's at dtype=bfloat16, train=True:
  one Conv, HCoordAtt and C2PSA, with the port's module at f32 as the f32 side:
  output, running statistics, the input's and every parameter's gradient,
  max over each, MULTIPLE 2, floor one bf16 step at the quantity's largest
  magnitude (0.03 of it for the running statistics). A fixed count of bf16
  steps does not hold: HCoordAtt's kernel gradient sums over every pixel the
  gate's gradient, which torch rounds to bf16 op by op and XLA once per
  fusion, and lay 2 steps off JAX's at 22 % of its elements. Measured: at
  most 0.46 (Conv), 0.40 (HCoordAtt) and 0.75 (C2PSA) of the bound; with
  JAX's modules applied op by op (no jit) the outputs of Conv and C2PSA
  equal JAX's exactly.
- The step: the trained spectrogram_yolo11n at 64 px, B = 2, optimizer=auto
  (AdamW), an accumulation step at ni = 3 and an update at ni = 4, against
  JAX's compiled amp=True train_step (one compile). Each of grads, params,
  both moments, BN statistics and their EMA is held over all its leaves at
  once (L2 norm, relative to JAX's), MULTIPLE 3, floor 1e-6; the share of
  leaves that meet the rule leaf by leaf is printed (88-99 %). Why not leaf
  by leaf, and why 3: at this size two bf16 evaluations of the same step lie
  about as far apart as either lies from f32. JAX's compiled step with and
  without XLA's excess precision differ by 0.12 of the grads' norm; the
  port's at 1 and at 2 threads by 0.06; the port's f32 lies 0.076 from
  JAX's bf16 and the port's bf16 0.12-0.15 (ratios 1.16-1.85 across
  quantities at one torch thread, as the tests run, and up to 2.18 at two).
- The loss items: XLA's CPU compile keeps each bf16 conv's f32 result where
  flax's op list rounds it (it runs a bf16 conv as an f32 conv and drops the
  f32 -> bf16 -> f32 round trip before BN), so JAX's compiled items lie
  0.4 % from f32, while the same graph applied op by op lies 5.8 % away and
  the port 1.2-4.3 % (by its thread count). The op-by-op items are a constant
  here (20 s to compute; `PYTHONPATH=. JAX_PLATFORMS=cpu python
  tests/test_torch_train_amp.py` prints them).
- The assigner's fg_mask and target indices, recorded inside both steps:
  equal on this batch (0 of its 2 x 84 anchors differ).
- Every state tensor stays f32.
- validate() under amp runs a bf16 copy of the EMA, equal to a
  DetectionValidator(half=True) of a model holding the EMA's weights, and
  the next validate() makes a new copy.
- YOLO(ckpt).train(...) at the default amp trains, its checkpoint says
  amp: True with f32 trees in flax's bytes, and the facade's model keeps
  the compute dtype as JAX's setup_model leaves JAX's (read from JAX's
  trainer): a chained val() runs bf16.
- A checkpoint that JAX's save_checkpoint writes from JAX's amp state resumes
  in the port with weights, EMA, moments and counts exact, and trains on.
"""

import copy
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from test_torch_train_step import _batch, _flax, _leaves, one_torch_thread  # noqa: F401 (autouse)

import spectrogram_yolov11_tpu.ops.losses as jax_losses
import spectrogram_yolov11_tpu.utils.callbacks as jax_callbacks
import spectrogram_yolov11_torch.ops.losses as port_losses
from spectrogram_yolov11_torch import YOLO
from spectrogram_yolov11_torch.data.dataset import check_det_dataset
from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint
from spectrogram_yolov11_torch.engine.optim import lr_at
from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer
from spectrogram_yolov11_torch.engine.validator import DetectionValidator
from spectrogram_yolov11_torch.nn.modules import C2PSA, Conv, HCoordAtt
from spectrogram_yolov11_torch.nn.modules.conv import BN_MOMENTUM
from spectrogram_yolov11_torch.nn.tasks import build_model
from spectrogram_yolov11_torch.utils.jax_compat import state_dict_to_variables, variables_to_state_dict
from spectrogram_yolov11_tpu.engine import optim as jopt
from spectrogram_yolov11_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from spectrogram_yolov11_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from spectrogram_yolov11_tpu.engine.trainer import DetectionTrainer as JaxDetectionTrainer
from spectrogram_yolov11_tpu.nn.modules.block import C2PSA as JaxC2PSA
from spectrogram_yolov11_tpu.nn.modules.conv import Conv as JaxConv
from spectrogram_yolov11_tpu.nn.modules.fork import HCoordAtt as JaxHCoordAtt
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
NB, IMGSZ, BATCH = 50, 64, 2
STEPS = ((3, False), (4, True))
BF16 = torch.bfloat16
FLOOR, MODULE_MULTIPLE, MULTIPLE = 1e-6, 2, 3
# JAX's step compiles 4 s faster without LLVM's expensive passes, to the same bits (items, grads and state
# compared on this input)
XLA_OPTIONS = {"xla_llvm_disable_expensive_passes": True}
LEAF_KEYS = ("params", "mu", "nu", "batch_stats", "ema_params", "ema_batch_stats")
# JAX's loss items for the seeded batch, its bf16 graph applied op by op (no
# jit; 20 s on the CPU): `PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_train_amp.py`
JAX_OP_BY_OP_ITEMS = np.array([1.0167507, 0.6781101, 0.35954916], np.float32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("amp64")
    d = {"path": str(root), "train": "images/train", "val": "images/val", "synthetic": "spectrogram",
         "n_train": 4, "n_val": 2, "gen_imgsz": IMGSZ, "seed": 0, "names": {0: "LTE", 1: "RF"}}
    check_det_dataset(d)
    return d


def _module_case(name, dtype):
    if name == "Conv":
        return JaxConv(8, 16, 3, 1, dtype=dtype), Conv(8, 16, 3, 1), (2, 8, 7, 8)
    if name == "HCoordAtt":
        return JaxHCoordAtt(16, 16, dtype=dtype), HCoordAtt(16, 16), (2, 6, 9, 16)
    return JaxC2PSA(64, 64, 1, dtype=dtype), C2PSA(64, 64, 1), (2, 4, 4, 64)


def _jax_module(jm, variables, x, ct):
    """(output, running statistics, param grads, input grad) of a JAX module in training."""

    def loss(params, x):
        y, mut = jm.apply(dict(variables, params=params), x, train=True, mutable=["batch_stats"])
        return (y.astype(jnp.float32) * ct).sum(), (y, mut)

    (_, (y, mut)), (g_p, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], x)
    f32 = lambda t: np.asarray(jnp.asarray(t, jnp.float32))  # noqa: E731
    return {"out": f32(y), "x grad": f32(g_x), **{f"stats/{k}": v for k, v in _leaves(
        jax.tree_util.tree_map(f32, mut.get("batch_stats", {})))}, **{f"grad/{k}": v for k, v in _leaves(
            jax.tree_util.tree_map(f32, g_p))}}


def _port_module(pm, x, ct):
    """The same quantities of the port's module in training at x's dtype."""
    pm.train()
    xt = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    y = pm(xt)
    assert y.dtype == x.dtype and all(p.dtype == torch.float32 for p in pm.parameters())
    (y.float() * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).numpy()  # noqa: E731
    out = {"out": nhwc(y), "x grad": nhwc(xt.grad)}
    out.update({f"stats/{k}": v for k, v in _leaves(state_dict_to_variables(
        {k: b for k, b in pm.named_buffers() if k.endswith(("running_mean", "running_var"))}).get("batch_stats", {}))})
    out.update({f"grad/{k}": v for k, v in _leaves(state_dict_to_variables(
        {k: p.grad for k, p in pm.named_parameters()})["params"])})
    return out


@pytest.mark.parametrize("name", ["Conv", "HCoordAtt", "C2PSA"])
def test_module_trains_in_bf16_within_jax_bf16_distance(name):
    """The module in training at bf16 (a bf16 input, f32 parameters) against
    JAX's at dtype=bfloat16, train=True, by the distance rule with the port's
    module in f32 (the same input, upcast) as the f32 side: its output, the
    running statistics after the step, the input's gradient and every
    parameter's, for one seeded input and cotangent. Floor: one bf16 step at
    the quantity's largest magnitude (2^(e-7) for a magnitude in [2^e,
    2^(e+1))); for the f32 running statistics, 0.03 of that: the batch
    statistic, taken from bf16 values, enters them at weight 0.03."""
    jm, pm, shape = _module_case(name, jnp.bfloat16)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(0.3, 1.5, shape).astype(np.float32)).to(BF16)  # NHWC
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), xj))
    if "batch_stats" in variables:  # running statistics away from 0 and 1, so their move is seen
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.min() > 0.5 else rng.normal(0, 0.1, a.shape)).astype(
                np.float32), variables["batch_stats"])
    ct = rng.normal(0, 1, shape[:3] + (jm.c2 if hasattr(jm, "c2") else jm.oup,)).astype(np.float32)
    ref = _jax_module(jm, variables, xj, ct)
    sd = variables_to_state_dict(variables)
    pm.load_state_dict(sd, strict=False)
    got = _port_module(pm, x, ct)
    pm32 = _module_case(name, None)[1]
    pm32.load_state_dict(sd, strict=False)
    f32 = _port_module(pm32, x.float(), ct)
    assert got.keys() == ref.keys() == f32.keys()
    ratios = {}
    for k, r in ref.items():
        scale = float(np.abs(r).max())
        floor = 2.0 ** (np.floor(np.log2(scale)) - 7) * (1 - BN_MOMENTUM if k.startswith("stats/") else 1.0)
        err, bound = _rule(got[k], f32[k], r, floor)
        assert err <= bound, (k, err, bound)
        ratios[k] = err / bound
    print(f"{name}: {len(ref)} quantities, error over bound at most {max(ratios.values()):.2f} "
          f"({max(ratios, key=ratios.get)}), output {ratios['out']:.2f}, input grad {ratios['x grad']:.2f}")


def _rule(got, f32, ref, floor=0.0):
    """(error, bound) of the modules' rule on arrays: max |got - ref| against
    MODULE_MULTIPLE max |f32 - ref| + floor."""
    err = float(np.abs(got - ref).max())
    return err, MODULE_MULTIPLE * float(np.abs(f32 - ref).max()) + floor


# -- the step -------------------------------------------------------------
def _record_assign(orig, seen):
    """task_aligned_assign that also records (fg_mask, target_gt_idx) of its first call."""

    def wrapped(*args, **kwargs):
        res = orig(*args, **kwargs)
        if "assign" not in seen:
            seen["assign"] = (np.asarray(res.fg_mask), np.asarray(res.target_gt_idx))
        return res

    return wrapped


def _port_step(data, cfg, variables, amp):
    t = DetectionTrainer(build_model(cfg, nc=2, variables=variables),
                         dict(data=data, imgsz=IMGSZ, batch=BATCH, amp=amp, optimizer="auto", device="cpu"))
    t.setup_model()
    t.setup_optimizer(NB)
    seen, items = {}, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_losses, "task_aligned_assign", _record_assign(port_losses.task_aligned_assign, seen))
        for ni, do_step in STEPS:
            items.append(t.train_step(_batch(), ni, do_step)[1].numpy())
            if not do_step:
                seen["grads"] = _flax(t.param_names, t.state["grad_buf"])
    st = t.state
    seen["items"] = items
    seen["state"] = {"params": _flax(t.param_names, t.params), "mu": _flax(t.param_names, st["opt"]["mu"]),
                     "nu": _flax(t.param_names, st["opt"]["nu"]),
                     "batch_stats": _flax(t.stat_names, t.stats, "batch_stats"),
                     "ema_params": _flax(t.param_names, st["ema"]["params"]),
                     "ema_batch_stats": _flax(t.stat_names, st["ema"]["batch_stats"], "batch_stats")}
    seen["dtypes"] = {str(x.dtype) for x in (*t.params, *t.stats, *st["grad_buf"], *st["opt"]["mu"],
                                             *st["opt"]["nu"], *st["ema"]["params"], *st["ema"]["batch_stats"])}
    return t, seen


def _jax_step(data, cfg, variables):
    """JAX's amp=True train_step from its trainer, compiled once, with the
    state its train() builds; the assigner's outputs of the first step come
    back through a host callback."""
    overrides = dict(data=data, imgsz=IMGSZ, batch=BATCH, amp=True, optimizer="auto", workers=1,
                     project=str(data["path"]), exist_ok=True, plots=False)
    with pytest.MonkeyPatch.context() as mp:  # the JAX trainer's logging integrations touch no result
        mp.setattr(jax_callbacks, "_INTEGRATIONS", ())
        jt = JaxDetectionTrainer(overrides=overrides, model=jax_build_model(dict(cfg), nc=2, verbose=False),
                                 variables=variables)
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
    seen, items = {}, []

    def record(fg, idx):
        seen.setdefault("assign", (np.asarray(fg), np.asarray(idx)))

    orig = jax_losses.task_aligned_assign

    def assign(*args, **kwargs):
        res = orig(*args, **kwargs)
        jax.debug.callback(record, res.fg_mask, res.target_gt_idx)
        return res

    jax_losses.detection_loss.clear_cache()  # a loss traced earlier in this process would skip the callback
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_losses, "task_aligned_assign", assign)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        args = (jnp.asarray(STEPS[0][0], jnp.int32), jnp.asarray(STEPS[0][1]))
        step = jt._make_train_step(opt, groups, wd).lower(state, batch, *args).compile(compiler_options=XLA_OPTIONS)
        for ni, do_step in STEPS:
            state, _, it = step(state, batch, jnp.asarray(ni, jnp.int32), jnp.asarray(do_step))
            items.append(np.asarray(it))
            if not do_step:
                seen["grads"] = dict(_leaves(jopt.unflatten_tree(state["grad_buf"], spec)))
    jax_losses.detection_loss.clear_cache()
    seen["items"] = items
    seen["state"] = {"params": dict(_leaves(state["params"])),
                     "mu": dict(_leaves(jopt.unflatten_tree(state["opt"].mu, spec))),
                     "nu": dict(_leaves(jopt.unflatten_tree(state["opt"].nu, spec))),
                     "batch_stats": dict(_leaves(state["batch_stats"])),
                     "ema_params": dict(_leaves(state["ema"]["params"])),
                     "ema_batch_stats": dict(_leaves(state["ema"]["batch_stats"]))}
    seen["raw"], seen["trainer"], seen["lr"] = state, jt, dict(zip(("main", "bias"), lr_at(opt, STEPS[-1][0])))
    seen["groups"] = dict(_leaves(groups))
    return seen


@pytest.fixture(scope="module")
def step(data):
    tree, meta = load_checkpoint(CKPT)
    cfg, variables = meta["model_yaml"], tree.get("ema") or tree["variables"]
    jax_run = _jax_step(data, cfg, variables)
    port_t, port = _port_step(data, cfg, variables, True)
    _, f32 = _port_step(data, cfg, variables, False)
    return {"jax": jax_run, "port": port, "f32": f32, "trainer": port_t, "cfg": cfg}


def _vec(run, key):
    """A quantity of a run as one vector, its leaves in sorted order."""
    if key == "items":
        return np.concatenate(run["items"])
    t = run["grads"] if key == "grads" else run["state"][key]
    return np.concatenate([np.asarray(t[k], np.float32).ravel() for k in sorted(t)])


def _leaf_rule_share(step, key):
    """The share of leaves of a quantity that also meet the rule leaf by leaf
    (max over the leaf), reported beside the quantity's rule."""
    t = lambda r: r["grads"] if key == "grads" else r["state"][key]  # noqa: E731
    p, f, j = (t(step[n]) for n in ("port", "f32", "jax"))
    return float(np.mean([np.abs(p[k] - r).max() <= MULTIPLE * np.abs(f[k] - r).max() + FLOOR * np.abs(r).max()
                          for k, r in j.items()]))


def test_amp_step_items_within_jax_bf16_scatter(step):
    """The loss items of both steps; the yardstick is the larger of the port's
    f32 distance and JAX's own scatter between its compiled items and its
    op-by-op ones (the module docstring says why)."""
    j, p, f = step["jax"], step["port"], step["f32"]
    for k, (gi, fi, ji) in enumerate(zip(p["items"], f["items"], j["items"])):
        yard = max(float(np.abs(fi - ji).max()), float(np.abs(JAX_OP_BY_OP_ITEMS - ji).max()))
        err = float(np.abs(gi - ji).max())
        print(f"step {k}: items {gi.tolist()} (JAX compiled {ji.tolist()}, op by op {JAX_OP_BY_OP_ITEMS.tolist()}, "
              f"port f32 {fi.tolist()}): {err:.2e}, {err / yard:.2f} of the yardstick")
        assert err <= MULTIPLE * yard + FLOOR * float(np.abs(ji).max())


@pytest.mark.parametrize("key", ("grads",) + LEAF_KEYS)
def test_amp_step_state_within_jax_bf16_distance(step, key):
    """The grad buffer after the accumulation step, or a part of the state
    after the update, over all its leaves: ||port bf16 - JAX bf16|| <=
    MULTIPLE ||port f32 - JAX bf16|| + FLOOR ||JAX bf16||; every state
    tensor f32."""
    j, p, f = step["jax"], step["port"], step["f32"]
    assert p["dtypes"] == {"torch.float32"}
    ref = j["grads"] if key == "grads" else j["state"][key]
    assert (p["grads"] if key == "grads" else p["state"][key]).keys() == ref.keys()
    jb, pb, pf = (_vec(r, key) for r in (j, p, f))
    scale = float(np.linalg.norm(jb))
    err, yard = float(np.linalg.norm(pb - jb)) / scale, float(np.linalg.norm(pf - jb)) / scale
    print(f"{key}: port bf16 {err:.3e} of JAX bf16's norm, port f32 {yard:.3e} (ratio {err / yard:.2f}); "
          f"{_leaf_rule_share(step, key):.1%} of {len(ref)} leaves meet the rule leaf by leaf")
    assert err <= MULTIPLE * yard + FLOOR


def test_amp_step_assigner_against_jax(step):
    """The assigner's fg_mask and target indices of the first step, port bf16
    against JAX bf16 (and the port's f32 beside them): the share that
    differs is reported; it comes from bf16 rounding of the logits (ties to
    the lowest index on both sides), so it is held under 5 % of anchors."""
    (pf, pi), (jf, ji), (ff, fi) = step["port"]["assign"], step["jax"]["assign"], step["f32"]["assign"]
    fg_diff = float((pf != jf).mean())
    idx_diff = float(((pi != ji) & pf & jf).mean())
    print(f"fg_mask differs at {fg_diff:.3%} of anchors (port f32 against JAX bf16: {float((ff != jf).mean()):.3%}); "
          f"target index at {idx_diff:.3%} ({int(jf.sum())} JAX foreground anchors)")
    assert pf.shape == jf.shape and jf.sum() > 0
    assert fg_diff <= 0.05 and idx_diff <= 0.05


def test_amp_validate_runs_a_bf16_copy_equal_to_half_val(step, data):
    """validate() under amp scores a bf16 copy of the EMA, equal to
    DetectionValidator(half=True) of an f32 model holding the EMA's weights;
    the next validate() after another update scores a new copy."""
    t = step["trainer"]
    got = t.validate()
    first = t.validator.model
    assert first.dtype == BF16 and t.ema_model.dtype == torch.float32
    ema = dict(zip(t.param_names, t.state["ema"]["params"]))
    ema.update(zip(t.stat_names, t.state["ema"]["batch_stats"]))
    model = build_model(step["cfg"], nc=2)
    model.load_state_dict({**model.state_dict(), **{k: v.clone() for k, v in ema.items()}})
    ref = DetectionValidator(model, dict(data=data, imgsz=IMGSZ, batch=BATCH, half=True, device="cpu", plots=False))()
    print(f"validate() under amp {got}")
    assert got == ref
    t.train_step(_batch(), 5, True)
    t.validate()
    assert t.validator.model is not first and t.validator.model.dtype == BF16


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """YOLO(ckpt).train at its defaults (amp=True) for 1 epoch on the CPU."""
    project = tmp_path_factory.mktemp("amp_train")
    yolo = YOLO(CKPT, device="cpu")
    metrics = yolo.train(data=data, epochs=1, batch=BATCH, imgsz=IMGSZ, workers=1, project=str(project), name="run",
                         plots=False)
    return yolo, metrics, project / "run"


def test_yolo_train_defaults_to_amp(trained):
    yolo, metrics, run = trained
    assert yolo.trainer.args.amp is True and 0 <= metrics["fitness"] <= 1
    assert yolo.trainer.validator.model.dtype == BF16
    tree, meta = load_checkpoint(run / "weights" / "last.ckpt")
    assert meta["train_args"]["amp"] is True
    assert all(v.dtype == np.float32 for _, v in _leaves(tree["variables"]))
    assert all(v.dtype == np.float32 for _, v in _leaves(tree["ema"]))
    with open(run / "weights" / "last.ckpt", "rb") as f:  # the tree's bytes are flax's for the same tree
        f.seek(8 + int.from_bytes(f.read(8), "little"))
        assert serialization.msgpack_serialize(jax_load_checkpoint(run / "weights" / "last.ckpt")[0]) == f.read()


def test_facade_keeps_the_compute_dtype_as_jax(trained, step, data):
    """JAX's setup_model sets the facade's model to bf16 in place under amp
    (None, f32, without), so a chained val() at half=False runs bf16; the
    port's facade does the same, and a model trained with amp=False stays
    f32."""
    jt = step["jax"]["trainer"]
    assert jt.model.dtype == jnp.bfloat16  # set in place by setup_model; JAX's facade keeps this model
    assert JaxDetectionTrainer.compute_dtype.fget(SimpleNamespace(args=SimpleNamespace(amp=False))) is None

    yolo = trained[0]
    assert yolo.model.compute_dtype == BF16 and yolo.model.dtype == torch.float32 and not yolo.model.training
    chained = yolo.val(data=data, batch=BATCH, imgsz=IMGSZ, plots=False)
    assert yolo.validator.model.dtype == BF16
    assert chained == yolo.val(data=data, batch=BATCH, imgsz=IMGSZ, half=True, plots=False)
    f32_model = copy.deepcopy(yolo.model).set_compute_dtype(torch.float32)
    f32_val = DetectionValidator(f32_model, dict(data=data, imgsz=IMGSZ, batch=BATCH, device="cpu", plots=False))()
    print(f"chained val (bf16) against an f32 val of the same weights: "
          f"{max(abs(chained[k] - f32_val[k]) for k in chained):.2e} at most")
    f32 = DetectionTrainer(build_model(step["cfg"], nc=2), dict(data=data, amp=False, device="cpu"))
    f32.setup_model()
    assert f32.model.compute_dtype == torch.float32


def test_port_resumes_a_jax_amp_checkpoint(step, data, tmp_path):
    """JAX's save_checkpoint of its amp state after the update step (its
    train_args with amp: True) resumed by the port: weights, EMA, moments,
    step and updates exact, and the port trains on in bf16."""
    j = step["jax"]
    jt, st = j["trainer"], j["raw"]
    path = tmp_path / "jax_amp.ckpt"
    np_tree = jax.tree_util.tree_map(np.asarray, {"params": st["params"], "batch_stats": st["batch_stats"]})
    jax_save_checkpoint(path, variables=np_tree, ema_variables=jax.tree_util.tree_map(np.asarray, st["ema"]),
                        opt_state=jax.tree_util.tree_map(np.asarray, st["opt"]._asdict()), epoch=0,
                        best_fitness=0.0, updates=int(st["ema_updates"]), train_args=vars(jt.args),
                        model_yaml=dict(step["cfg"]), names={0: "LTE", 1: "RF"}, nc=2)
    assert load_checkpoint(path)[1]["train_args"]["amp"] is True
    seen = {}

    def at_start(t):
        seen["params"] = dict(_leaves(state_dict_to_variables(t.model.state_dict())))
        seen["mu"] = _flax(t.param_names, t.state["opt"]["mu"])
        seen["ema"] = _flax(t.param_names, t.state["ema"]["params"])
        seen["counts"] = (t.start_epoch, t.state["opt"]["step"], t.state["ema_updates"], t.model.compute_dtype)

    yolo = YOLO(CKPT, device="cpu")
    yolo.add_callback("on_train_start", at_start)
    metrics = yolo.train(data=data, epochs=2, batch=BATCH, imgsz=IMGSZ, workers=1, resume=str(path), plots=False,
                         project=str(tmp_path), name="resumed")
    assert seen["counts"] == (1, 1, 1, BF16)
    assert all(np.array_equal(seen["params"][k], v) for k, v in _leaves(np_tree))
    assert all(np.array_equal(seen["ema"][k], np.asarray(v)) for k, v in j["state"]["ema_params"].items())
    assert all(np.array_equal(seen["mu"][k], np.asarray(v)) for k, v in j["state"]["mu"].items())
    assert 0 <= metrics["fitness"] <= 1 and yolo.trainer.state["opt"]["step"] > 1


if __name__ == "__main__":
    from spectrogram_yolov11_tpu.ops.losses import detection_loss as jax_detection_loss

    jax.config.update("jax_platforms", "cpu")
    tree, meta = load_checkpoint(CKPT)
    b = _batch()
    model = jax_build_model(dict(meta["model_yaml"]), nc=2, verbose=False, dtype=jnp.bfloat16)
    feats, _ = model.graph.apply(tree.get("ema") or tree["variables"], jnp.asarray(b["img"].astype(np.float32) / 255),
                                 train=True, mutable=["batch_stats"])
    _, items = jax_detection_loss(feats, jnp.asarray(b["cls"]), jnp.asarray(b["bboxes"]), jnp.asarray(b["mask_gt"]),
                                  nc=2, imgsz=IMGSZ, strides=tuple(float(s) for s in model.stride))
    print(f"JAX's bf16 loss items op by op: {np.asarray(items).tolist()} (JAX_OP_BY_OP_ITEMS "
          f"{JAX_OP_BY_OP_ITEMS.tolist()})")
