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
