"""The port's optimizer recipe against the JAX package's engine/optim.py, on the CPU.

- choose_optimizer: the same kind, lr0, momentum, warmup_bias_lr and warmup
  iterations for 'auto' on both sides of 10 000 iterations and for each
  named optimizer.
- lr_at and ema_decay: equal, bit for bit, to JAX's f32 values at every
  iteration of a warmup and past it, for the linear and the cosine schedule.
- param_groups: the same group for every leaf of the trained
  spectrogram_yolo11n.
- The update: the global-norm clip, then SGD (nesterov) or AdamW per group,
  three steps at iterations in the warmup (so lr != 0 and Adam's step count
  differs from the iteration), against apply_updates_flat on the same
  seeded tree: params and both moments within 1e-6 relative and 2e-7
  absolute, about an f32 step at the leaves' unit scale (the same f32
  operations, but the global norm is summed in another order and the port
  may fuse a multiply-add).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.engine import optim
from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint
from spectrogram_yolov11_torch.nn.tasks import build_model
from spectrogram_yolov11_torch.utils.jax_compat import _flax_path
from spectrogram_yolov11_tpu.engine import optim as jopt

CKPT = Path(__file__).resolve().parent.parent / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
DEFAULTS = dict(optimizer="auto", lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=0.0005, warmup_epochs=3.0,
                warmup_momentum=0.8, warmup_bias_lr=0.1, epochs=100, cos_lr=False)


class Args(dict):
    __getattr__ = dict.__getitem__


@pytest.mark.parametrize("kw,nb", [({}, 8), ({}, 200), ({"optimizer": "SGD"}, 8), ({"optimizer": "Adam"}, 8),
                                   ({"optimizer": "RMSProp", "warmup_epochs": 0.0}, 8),
                                   ({"optimizer": "AdamW", "warmup_epochs": 50.0, "cos_lr": True}, 8)])
def test_choose_optimizer_equals_jax(kw, nb):
    args = Args(DEFAULTS, **kw)
    got, ref = optim.choose_optimizer(args, 2, nb), jopt.choose_optimizer(args, 2, nb)
    assert got._asdict() == ref._asdict()


@pytest.mark.parametrize("cos_lr", [False, True], ids=["linear", "cosine"])
def test_lr_at_and_ema_decay_equal_jax(cos_lr):
    for kind in ("sgd", "adamw"):
        opt = optim.choose_optimizer(Args(DEFAULTS, optimizer=kind, cos_lr=cos_lr), 2, 40)  # warmup 120 iterations
        for step in (0, 1, 7, 39, 40, 119, 120, 121, 1999, 3999):
            got = optim.lr_at(opt, step)
            ref = [float(np.float32(x)) for x in jopt.lr_at(opt, jnp.asarray(step, jnp.int32))]
            assert got == tuple(ref), (kind, step)
    for updates in (1, 2, 10, 777, 5000):
        assert optim.ema_decay(updates) == float(jopt.ema_decay(jnp.asarray(updates, jnp.int32)))


def test_param_groups_equal_jax():
    tree, meta = load_checkpoint(CKPT)
    variables = tree.get("ema") or tree["variables"]
    model = build_model(meta["model_yaml"], nc=meta["nc"], variables=variables)
    ref = jopt.param_groups(variables["params"])
    got = optim.param_groups(model)
    assert len(got) == sum(1 for _ in model.parameters())
    for name, group in got.items():
        key, leaf = name.rsplit(".", 1)
        node = ref
        for tok in _flax_path(key):
            node = node[tok]
        flax_leaf = {"bias": "bias"}.get(leaf, "scale" if group == "norm" else "kernel")
        assert node[flax_leaf] == group, name
    assert sorted(set(got.values())) == ["bias", "decay", "norm"]


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"bn": {"bias": rng.normal(0, scale, 16), "scale": rng.normal(1, scale, 16)},
            "conv1": {"bias": rng.normal(0, scale, 16), "kernel": rng.normal(0, scale, (3, 3, 8, 16))},
            "head": {"kernel": rng.normal(0, scale, (1, 1, 16, 4))}}


def _leaves(tree):
    return [np.asarray(tree[m][k], np.float32) for m in sorted(tree) for k in sorted(tree[m])]


@pytest.mark.parametrize("kind,grad_scale", [("sgd", 1.0), ("adamw", 1.0), ("sgd", 0.01)],
                         ids=["sgd-clipped", "adamw-clipped", "sgd-unclipped"])
def test_update_equals_apply_updates_flat(kind, grad_scale):
    params = _tree(0)
    opt = optim.choose_optimizer(Args(DEFAULTS, optimizer=kind), 2, 4)  # warmup 100 iterations
    wd = 0.0005 * 2 * 32 / 64
    groups = jopt.param_groups(params)
    spec = jopt.make_flat_spec(params, groups)
    j_p, j_st = jopt.flatten_tree(params), jopt.init_opt_state_flat(spec)
    names = [("bias", "bn"), ("norm", "bn"), ("bias", "conv1"), ("decay", "conv1"), ("decay", "head")]
    p = [torch.from_numpy(x) for x in _leaves(params)]
    mu, nu = [torch.zeros_like(t) for t in p], [torch.zeros_like(t) for t in p]
    for n, ni in enumerate((3, 4, 9)):
        grads = _tree(10 + n, grad_scale)
        j_p, j_st = jopt.apply_updates_flat(j_p, jopt.flatten_tree(grads), j_st, opt, spec, wd, lr_step=jnp.asarray(ni))
        g = [torch.from_numpy(x) for x in _leaves(grads)]
        norm = optim.clip_grad_norm_(g, opt.clip_norm)
        assert (float(norm) > 10) == (grad_scale == 1.0)
        lr_main, lr_bias, mom = optim.lr_at(opt, ni)
        for group in ("decay", "bias", "norm"):
            idx = [i for i, (grp, _) in enumerate(names) if grp == group]
            sel = [[t[i] for i in idx] for t in (p, g, mu, nu)]
            lr, w = (lr_bias if group == "bias" else lr_main), (wd if group == "decay" else 0.0)
            if kind == "sgd":
                optim.sgd_update_(sel[0], sel[1], sel[2], lr, mom, w)
            else:
                optim.adamw_update_(*sel, n + 1, lr, opt.momentum, w)
    for got, ref in ((p, j_p), (mu, j_st.mu), (nu, j_st.nu)):
        np.testing.assert_allclose(torch.cat([t.reshape(-1) for t in got]).numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=2e-7)
    assert int(j_st.step) == 3


def test_ema_update_equals_jax():
    rng = np.random.default_rng(5)
    ema, new = rng.normal(0, 1, (2, 50)).astype(np.float32)
    d = optim.ema_decay(3)
    ref = jopt.ema_update({"a": jnp.asarray(ema)}, {"a": jnp.asarray(new)}, jopt.ema_decay(jnp.asarray(3)))["a"]
    got = [torch.from_numpy(ema.copy())]
    optim.ema_update_(got, [torch.from_numpy(new)], d)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
