"""The port's DetectionModel against the JAX model, f32 on the CPU.

The trained spectrogram_yolo11n (checkpoint `model_yaml`, weights through the
bridge) at a square and a non-square size, and the stock yolo11.yaml at scale
n with a random JAX init. Inputs are NHWC for JAX and NCHW for torch; each
level's box and cls maps are compared after transposing at the test boundary.

Tolerance 1e-3 abs/rel: ~25 conv layers in f32 on both sides, summed in other
orders, and the port runs C3k's bottlenecks with BN folded into the weights
where the JAX model applies BN after each conv.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)
import yaml

from spectrogram_yolov11_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from spectrogram_yolov11_tpu.nn.tasks import build_model as jax_build_model
from spectrogram_yolov11_torch.nn.tasks import build_model

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
TOL = 1e-3


def _compare(torch_model, jax_apply, variables, h, w, seed):
    x = np.random.default_rng(seed).uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    ref = jax_apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = torch_model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 3
    for (gb, gc), (rb, rc) in zip(got, ref):
        np.testing.assert_allclose(gb.permute(0, 2, 3, 1).numpy(), np.asarray(rb), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(gc.permute(0, 2, 3, 1).numpy(), np.asarray(rc), atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def trained():
    tree, meta = jax_load_checkpoint(CKPT)
    variables = tree.get("ema") or tree["variables"]
    jm = jax_build_model(meta["model_yaml"], nc=meta["nc"], verbose=False)
    tm = build_model(meta["model_yaml"], nc=meta["nc"], variables=variables)
    return tm, jax.jit(lambda v, x: jm.apply(v, x, train=False)), variables, jm


@pytest.mark.parametrize("h,w", [(64, 64), (64, 96)])
def test_trained_forward_matches_jax(trained, h, w):
    tm, apply, variables, _ = trained
    _compare(tm, apply, variables, h, w, seed=h + w)


def test_trained_model_structure(trained):
    tm, _, _, jm = trained
    assert tm.stride == (8.0, 16.0, 32.0) == tuple(float(s) for s in jm.stride)
    fused = [m for m in tm.modules() if getattr(m, "fusable", False)]
    # layers 6, 8 and 25: one C3k each, two same-width bottlenecks per C3k
    assert [m.w1.shape for m in fused] == [(18, 32, 32)] * 2 + [(18, 64, 64)] * 4  # hi|lo x 9 taps
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(trained[2]["params"]))


def test_stock_yolo11n_random_init_matches_jax():
    cfg = yaml.safe_load((ROOT / "spectrogram_yolov11_tpu/cfg/models/11/yolo11.yaml").read_text())
    cfg["scale"] = "n"
    jm = jax_build_model(dict(cfg), verbose=False)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    # non-trivial BN statistics, so the folding and the bridge of mean/var are exercised
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.min() > 0.5 else rng.normal(0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    tm = build_model(cfg, variables=variables)
    _compare(tm, jax.jit(lambda v, x: jm.apply(v, x, train=False)), variables, 64, 64, seed=3)


def test_unknown_module_raises():
    cfg = {"nc": 2, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "RepC3", [16]]], "head": []}
    with pytest.raises(KeyError, match="RepC3"):
        build_model(cfg)


def test_forward_and_plain_bottleneck_run_in_full_f32(trained, monkeypatch):
    """The port's f32 policy (utils.full_f32): with TF32 turned on for cuDNN
    and matmul, the network's forward and the plain bottleneck run with both
    off, and the caller's settings come back after, also on an exception."""
    from spectrogram_yolov11_torch.ops import fused_conv
    from spectrogram_yolov11_torch.utils import full_f32

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    tm, seen, silu = trained[0], [], torch.nn.functional.silu
    monkeypatch.setattr(fused_conv.F, "silu", lambda *a, **k: (seen.append(("plain", flags())), silu(*a, **k))[1])
    saved = flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        hook = tm.model[6].register_forward_pre_hook(lambda *_: seen.append(("forward", flags())))
        with torch.inference_mode():
            tm(torch.zeros(1, 3, 64, 64))
        hook.remove()
        assert ("forward", (False, False)) in seen and all(f == (False, False) for _, f in seen)
        seen.clear()
        w, b = torch.zeros(3, 3, 32, 32), torch.zeros(32)
        fused_conv.bottleneck_reference(torch.zeros(1, 4, 4, 32), w, b, w, b)
        assert seen == [("plain", (False, False))] * 2
        assert flags() == (True, True)
        with pytest.raises(RuntimeError, match="inside"):
            with full_f32():
                raise RuntimeError("inside")
        assert flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_full_f32_holds_for_concurrent_callers():
    """Sixteen threads in and out of full_f32 at once, switching every
    microsecond: each sees TF32 off inside, and the settings the process had
    come back once the last one leaves."""
    import sys
    import threading

    from spectrogram_yolov11_torch.utils import full_f32

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    seen_on = []

    def work():
        for _ in range(300):
            with full_f32():
                if flags() != (False, False):
                    seen_on.append(flags())

    saved, interval = flags(), sys.getswitchinterval()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    threads = [threading.Thread(target=work) for _ in range(16)]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not seen_on and flags() == (True, True)
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
