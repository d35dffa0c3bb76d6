"""The fork's modules on the port against the JAX package's, on the CPU.

Every class of nn/modules/fork.py, and the conv and block classes the fork
builds on (GhostConv, ChannelAttention, SpatialAttention, CBAM, C2f, C3, C3x,
the width-gated Bottleneck), at (2, 16, 16, 32) NHWC as
tests/test_model_zoo.py builds them (the multi-input ones on two inputs):

- The weight bridge: the port's state dict through state_dict_to_variables
  has the paths and shapes of JAX's init (jax.eval_shape: no JAX init runs).
  The weights are the port's init_weights (JAX's distributions) with seeded
  noise on every leaf, so no gate sits at a constant (LDConv's zero offsets,
  GCT's zero gamma) and BN's statistics are not the identity; they reach JAX
  through the bridge.
- Eval: the output of JAX's apply (eager) against the port's.
- Train: one jitted JAX value_and_grad of the seeded scalar sum(y * r) in
  train mode (BN batch statistics) gives y, the new BN statistics and the
  gradients to the parameters and to x; the port's forward and backward give
  the same. A jitted call costs 0.3-2.3 s per module on the CPU, an eager
  jax.grad 0.5-8 s (measured), so the gradient is jitted.
- bf16, eval, on the modules whose dtypes are their own (f32 parts, bare
  BNs, dense layers, FFTs, the LDConv sampling, resize, the BiFPN sums): the
  port's bf16 form (convs and dense layers cast as DetectionModel.set_dtype
  casts them) within twice JAX's own bf16-to-f32 distance of JAX's module at
  dtype=bfloat16 (tests/test_torch_half.py's yardstick). The BiFPN concats
  round their f32 sum to bf16 where JAX's returns f32 (fork.py), so they are
  held to JAX's output rounded to bf16. ECAAttention raises at bf16 in both.

Tolerance (f32): 1e-5 absolute plus 1e-5 relative on outputs and BN
statistics. A gradient leaf's absolute part scales with the leaf's largest
magnitude, 1e-5 * (1 + max|g|): a kernel's gradient sums B*H*W = 512
products of O(1) terms whose rounding follows the sum of magnitudes (up to
190 in these cases), while single elements cancel to near 0 (measured: at
most 3.8e-4, 2e-6 of its leaf's largest, over every case). C3GC's gradients
take 20 times that: its GlobalContext's LayerNorm runs over rd = 2 channels,
whose gradient divides by their spread, and the rounding of the sums before
it moves that spread (measured 1.8e-4 at a leaf whose largest is 7e-2; the
32-channel GlobalContext case holds the plain tolerance). Also in this
file: the optimizer-state bridge and the param groups over every fork leaf
kind, and the init kinds against JAX's init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

import spectrogram_yolov11_tpu.nn.modules as J
import spectrogram_yolov11_torch.nn.modules as T
from spectrogram_yolov11_tpu.engine.optim import flatten_tree
from spectrogram_yolov11_tpu.engine.optim import param_groups as jax_param_groups
from spectrogram_yolov11_torch.engine.optim import param_groups
from spectrogram_yolov11_torch.nn.modules import fork as F
from spectrogram_yolov11_torch.nn.tasks import init_weights
from spectrogram_yolov11_torch.utils.jax_compat import (
    opt_state_from_flax,
    opt_state_to_flax,
    sorted_leaves,
    state_dict_to_variables,
    variables_to_state_dict,
)

SHAPE = (2, 16, 16, 32)
ATOL = RTOL = 1e-5
BF16 = torch.bfloat16


def jx(cls, *args, **kwargs):
    """A factory of the JAX module at a dtype (None: f32), for classes that take one."""
    def make(dtype=None):
        kw = dict(kwargs)
        if dtype is not None and "dtype" in cls.__dataclass_fields__:
            kw["dtype"] = dtype
        return cls(*args, **kw)
    return make


# name: (JAX factory, port factory, number of inputs, gradient tolerance scale, bf16 case)
CASES = {
    # conv.py
    "GhostConv": (jx(J.GhostConv, 32, 32), lambda: T.GhostConv(32, 32), 1, 1, False),
    "ChannelAttention": (jx(J.ChannelAttention, 32), lambda: T.ChannelAttention(32), 1, 1, False),
    "SpatialAttention": (jx(J.SpatialAttention, 7), lambda: T.SpatialAttention(7), 1, 1, False),
    "CBAM": (jx(J.CBAM, 32, 7), lambda: T.CBAM(32, 7), 1, 1, False),
    "CBAM_width_as_kernel": (jx(J.CBAM, 32, 64), lambda: T.CBAM(32, 64), 1, 1, False),
    # block.py
    "Bottleneck_fused": (jx(J.Bottleneck, 32, 32, e=1.0), lambda: T.Bottleneck(32, 32, e=1.0), 1, 1, False),
    "C2f": (jx(J.C2f, 32, 32, 1), lambda: T.C2f(32, 32, 1), 1, 1, False),
    "C3": (jx(J.C3, 32, 32, 1), lambda: T.C3(32, 32, 1), 1, 1, False),
    "C3x": (jx(J.C3x, 32, 32, 1), lambda: T.C3x(32, 32, 1), 1, 1, False),
    # fork.py helpers and gates
    "SELayer": (jx(J.SELayer, 32), lambda: T.SELayer(32), 1, 1, True),
    "SaELayer": (jx(J.SaELayer, 32), lambda: T.SaELayer(32), 1, 1, True),
    "GCT": (jx(J.GCT, 32), lambda: T.GCT(32), 1, 1, True),
    "WeightedSpatialAttention": (jx(J.WeightedSpatialAttention, 7), lambda: T.WeightedSpatialAttention(7), 1, 1,
                                 False),
    "SobelConv": (jx(J.SobelConv, 32, 32), lambda: T.SobelConv(32, 32), 1, 1, True),
    "SobelSpatialAttention": (jx(J.SobelSpatialAttention, 7), lambda: T.SobelSpatialAttention(7), 1, 1, False),
    "MSCSpatialAttention": (jx(J.MSCSpatialAttention, 32), lambda: T.MSCSpatialAttention(32), 1, 1, False),
    "ECAAttention": (jx(J.ECAAttention, 32), lambda: T.ECAAttention(32), 1, 1, True),
    # attention
    "CoordAtt": (jx(J.CoordAtt, 32, 32), lambda: T.CoordAtt(32, 32), 1, 1, True),
    "HCoordAtt": (jx(J.HCoordAtt, 32, 32), lambda: T.HCoordAtt(32, 32), 1, 1, False),
    "MaxHCoordAtt": (jx(J.MaxHCoordAtt, 32, 32), lambda: T.MaxHCoordAtt(32, 32), 1, 1, True),
    "GlobalStdPool2d": (jx(J.GlobalStdPool2d), lambda: T.GlobalStdPool2d(), 1, 1, False),
    "LDConv": (jx(J.LDConv, 32, 16, 5), lambda: T.LDConv(32, 16, 5), 1, 1, True),
    "LDConv_stride2": (jx(J.LDConv, 32, 16, 7, 2), lambda: T.LDConv(32, 16, 7, 2), 1, 1, False),
    "AKSpatialAttention": (jx(J.AKSpatialAttention, 7), lambda: T.AKSpatialAttention(7), 1, 1, False),
    "SAKAM": (jx(J.SAKAM, 32), lambda: T.SAKAM(32), 1, 1, False),
    "AKCBAM": (jx(J.AKCBAM, 32), lambda: T.AKCBAM(32), 1, 1, True),
    "Cross_AKConv": (jx(J.Cross_AKConv, 32, 32), lambda: T.Cross_AKConv(32, 32), 1, 1, False),
    # convolution variants
    "FGM": (jx(J.FGM, 32), lambda: T.FGM(32), 1, 1, True),
    "BottleNect": (jx(J.BottleNect, 32), lambda: T.BottleNect(32), 1, 1, True),
    "ConvOMN": (jx(J.ConvOMN, 32, 32), lambda: T.ConvOMN(32, 32), 1, 1, False),
    "DDWConv": (jx(J.DDWConv, 32, 32), lambda: T.DDWConv(32, 32), 1, 1, False),
    "MaxConv": (jx(J.MaxConv, 32, 32), lambda: T.MaxConv(32, 32), 1, 1, False),
    "MaxConvHCA": (jx(J.MaxConvHCA, 32, 32), lambda: T.MaxConvHCA(32, 32), 1, 1, False),
    "FilterMaxConv": (jx(J.FilterMaxConv, 32, 32), lambda: T.FilterMaxConv(32, 32), 1, 1, False),
    "PartialConvMax": (jx(J.PartialConvMax, 32, 32), lambda: T.PartialConvMax(32, 32), 1, 1, False),
    "ConvHCA": (jx(J.ConvHCA, 32, 32), lambda: T.ConvHCA(32, 32), 1, 1, False),
    "GhostConvMax": (jx(J.GhostConvMax, 32, 32), lambda: T.GhostConvMax(32, 32), 1, 1, False),
    "GhostMaxConv": (jx(J.GhostMaxConv, 32, 32), lambda: T.GhostMaxConv(32, 32), 1, 1, False),
    "GhostConvHCA": (jx(J.GhostConvHCA, 32, 32), lambda: T.GhostConvHCA(32, 32), 1, 1, False),
    "RecycleConv": (jx(J.RecycleConv, 32, 32, 3, 1), lambda: T.RecycleConv(32, 32, 3, 1), 1, 1, True),
    "Mix_SPPF": (jx(J.Mix_SPPF, 32, 32), lambda: T.Mix_SPPF(32, 32), 1, 1, True),
    "SAPF": (jx(J.SAPF, 32, 32), lambda: T.SAPF(32, 32), 1, 1, False),
    # necks
    "SelectChannel": (jx(J.SelectChannel, 32), lambda: T.SelectChannel(32), 2, 1, False),
    **{f"Fusion_{mode}": (jx(J.Fusion, (32, 32), mode, 32), (lambda mode=mode: T.Fusion((32, 32), mode, 32)), 2, 1,
                          mode in ("ESChannel", "bifpn"))
       for mode in ("weight", "adaptive", "concat", "bifpn", "SChannel", "SChannel_new", "ESChannel")},
    "BiFPN_WConcat": (jx(J.BiFPN_WConcat, (32, 32)), lambda: T.BiFPN_WConcat((32, 32)), 2, 1, True),
    "BiFPN_WConcat2": (jx(J.BiFPN_WConcat2), lambda: T.BiFPN_WConcat2(n=2), 2, 1, False),
    "BiFPN_WConcat3": (jx(J.BiFPN_WConcat3), lambda: T.BiFPN_WConcat3(n=3), 3, 1, True),
    # CSP blocks
    "GlobalContext": (jx(J.GlobalContext, 32), lambda: T.GlobalContext(32), 1, 1, True),
    "Partial_conv3": (jx(J.fork.Partial_conv3, 32), lambda: T.Partial_conv3(32), 1, 1, False),
    "Faster_Block": (jx(J.Faster_Block, 32, 32), lambda: T.Faster_Block(32, 32), 1, 1, False),
    "Faster_Block_adjust": (jx(J.Faster_Block, 32, 48), lambda: T.Faster_Block(32, 48), 1, 1, False),
    "BottleneckX_CBam": (jx(J.fork.BottleneckX_CBam, 32, 32), lambda: T.BottleneckX_CBam(32, 32), 1, 1, False),
    "DenseCross": (jx(J.DenseCross, 32, 32, e=1.0), lambda: T.DenseCross(32, 32, e=1.0), 1, 1, False),
    "XCBAM2C2f": (jx(J.XCBAM2C2f, 32, 32, 1), lambda: T.XCBAM2C2f(32, 32, 1), 1, 1, False),
    "C3GC": (jx(J.C3GC, 32, 32, 1), lambda: T.C3GC(32, 32, 1), 1, 20, False),
    "C3kGC": (jx(J.fork.C3kGC, 32, 32, 1), lambda: T.C3kGC(32, 32, 1), 1, 1, False),
    "C3k2GC": (jx(J.C3k2GC, 32, 32, 1), lambda: T.C3k2GC(32, 32, 1), 1, 1, False),
    "C3k2GC_c3k": (jx(J.C3k2GC, 32, 32, 1, True), lambda: T.C3k2GC(32, 32, 1, True), 1, 1, False),
    "C3MSCk": (jx(J.fork.C3MSCk, 32, 32, 1), lambda: T.C3MSCk(32, 32, 1), 1, 1, False),
    "C3MSCk2_c3k": (jx(J.C3MSCk2, 32, 32, 1, True), lambda: T.C3MSCk2(32, 32, 1, True), 1, 1, False),
    "MSBottleneck": (jx(J.MSBottleneck, 32, 32), lambda: T.MSBottleneck(32, 32), 1, 1, False),
    "DualChannelHConv": (jx(J.DualChannelHConv, 32, 32), lambda: T.DualChannelHConv(32, 32), 1, 1, False),
}


def _inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(0, 1, SHAPE).astype(np.float32) for _ in range(n)]
    return xs


def _to_torch(xs):
    return [torch.from_numpy(x).permute(0, 3, 1, 2).contiguous() for x in xs]


def _arg(xs, n):
    return xs if n > 1 else xs[0]


def _shapes(tree) -> dict:
    return {"/".join(p): tuple(a.shape) for p, a in sorted_leaves(tree)}


@torch.no_grad()
def _port_module(make, seed: int) -> torch.nn.Module:
    """The port's module with init_weights' draws plus seeded noise on every
    leaf: each parameter + N(0, 0.5 std + 0.05), BN means N(0, 0.1) and
    variances U(0.5, 1.5)."""
    mod = make()
    init_weights(mod, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for name, t in mod.state_dict(keep_vars=True).items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith("running_var"):
            t.copy_(torch.empty(t.shape).uniform_(0.5, 1.5, generator=g))
        elif name.endswith("running_mean"):
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
        else:
            scale = 0.5 * float(t.std()) if t.numel() > 1 else 0.0
            t.add_(torch.randn(t.shape, generator=g) * (scale + 0.05))
    return mod


def _fold(mod):
    for m in mod.modules():
        if isinstance(m, T.Bottleneck) and m.fusable:
            m.fold()


def _close(got, want, scale: float, what: str):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL * scale, rtol=RTOL * scale, err_msg=what)


def _close_grad(got, want, scale: float, what: str):
    want = np.asarray(want)
    atol = ATOL * scale * (1.0 + float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=RTOL * scale, err_msg=what)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_parity(name):
    """The bridge, eval, train (output, BN statistics) and gradients against JAX, in f32."""
    make_jax, make_port, n, scale, _ = CASES[name]
    seed = sum(map(ord, name)) % 1000
    mod = _port_module(make_port, seed)
    xs = _inputs(n, seed)
    jm = make_jax()
    jxs = [jnp.asarray(x) for x in xs]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), _arg(jxs, n), train=False))
    variables = state_dict_to_variables(mod.state_dict())
    assert _shapes(variables["params"]) == _shapes(shapes.get("params", {}))
    assert _shapes(variables["batch_stats"]) == _shapes(shapes.get("batch_stats", {}))
    variables = {k: v for k, v in variables.items() if v}
    # the bridge back gives the state dict
    back = variables_to_state_dict(variables)
    assert set(back) == set(mod.state_dict())
    for k, v in back.items():
        assert torch.equal(v, mod.state_dict()[k]), k

    # eval
    mod.eval()
    _fold(mod)
    want = jm.apply(variables, _arg(jxs, n), train=False)
    with torch.no_grad():
        got = mod(_arg(_to_torch(xs), n))
    _close(_nhwc(got), want, 1, f"{name} eval")

    # train: output, BN statistics, gradients to the parameters and to x
    r = np.random.default_rng(seed + 2).normal(0, 1, np.shape(want)).astype(np.float32)

    def loss(params, xin):
        y, upd = jm.apply({**variables, "params": params}, xin, train=True, mutable=["batch_stats"])
        return (y * r).sum(), (y, upd)

    (_, (jy, jupd)), (jgp, jgx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables.get("params", {}), _arg(jxs, n))
    mod.train()
    txs = [x.clone().requires_grad_(True) for x in _to_torch(xs)]
    ty = mod(_arg(txs, n))
    (ty * torch.from_numpy(r).permute(0, 3, 1, 2) if ty.dim() == 4 else ty * torch.from_numpy(r)).sum().backward()
    _close(_nhwc(ty), jy, 1, f"{name} train output")
    stats = state_dict_to_variables({k: v for k, v in mod.state_dict().items() if "running" in k})["batch_stats"]
    for path, leaf in sorted_leaves(stats):
        want_leaf = jupd["batch_stats"]
        for p in path:
            want_leaf = want_leaf[p]
        _close(leaf, want_leaf, 1, f"{name} BN statistics {path}")
    grads = state_dict_to_variables({k: p.grad for k, p in mod.named_parameters()})["params"]
    assert _shapes(grads) == _shapes(jgp)
    for (path, g), (_, want_g) in zip(sorted_leaves(grads), sorted_leaves(jax.tree_util.tree_map(np.asarray, jgp))):
        _close_grad(g, want_g, scale, f"{name} gradient {'/'.join(path)}")
    for tx, gx in zip(txs, jgx if n > 1 else [jgx]):
        _close_grad(_nhwc(tx.grad), gx, scale, f"{name} gradient to x")


def _bf16_copy(mod):
    """The module as DetectionModel.set_dtype's bf16 copy holds it."""
    for m in mod.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.to(BF16)
    for m in mod.modules():
        if isinstance(m, T.Bottleneck) and m.fusable:
            m.fold(BF16)
    return mod


@pytest.mark.parametrize("name", sorted(k for k, v in CASES.items() if v[4]))
def test_module_bf16(name):
    """Eval at bf16 against JAX's module at dtype=bfloat16: within twice JAX's
    own bf16-to-f32 distance (JAX's output rounded to bf16 for the BiFPN
    sums, which JAX returns in f32)."""
    make_jax, make_port, n, _, _ = CASES[name]
    seed = sum(map(ord, name)) % 1000
    mod = _port_module(make_port, seed).eval()
    variables = {k: v for k, v in state_dict_to_variables(mod.state_dict()).items() if v}
    xs = [torch.from_numpy(x).to(BF16).float().numpy() for x in _inputs(n, seed)]  # bf16 values on both sides
    jm16 = make_jax(jnp.bfloat16)
    j16 = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    mod = _bf16_copy(mod)
    t16 = [x.to(BF16) for x in _to_torch(xs)]
    if name == "ECAAttention":
        with pytest.raises(TypeError):
            jm16.apply(variables, j16[0], train=False)
        with pytest.raises(TypeError):
            mod(t16[0])
        return
    want16 = jm16.apply(variables, _arg(j16, n), train=False)
    want32 = np.asarray(make_jax().apply(variables, _arg([jnp.asarray(x) for x in xs], n), train=False))
    with torch.no_grad():
        got = mod(_arg(t16, n))
    assert got.dtype == BF16
    want16 = np.asarray(want16.astype(jnp.float32))
    if name.startswith("BiFPN") or name == "Fusion_bifpn":
        assert np.asarray(jm16.apply(variables, _arg(j16, n), train=False)).dtype == np.float32
        want16 = torch.from_numpy(want16).to(BF16).float().numpy()
        np.testing.assert_array_equal(_nhwc(got), want16)
        return
    d_jax = float(np.abs(want16 - want32).max())
    err = float(np.abs(_nhwc(got) - want16).max())
    assert err <= 2 * d_jax, f"{name}: port bf16 {err} from JAX's bf16, JAX's own bf16-to-f32 distance {d_jax}"


def test_helpers():
    x = np.random.default_rng(0).normal(0, 3, SHAPE).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    _close(_nhwc(F.h_swish(tx)), J.fork.h_swish(jnp.asarray(x)), 1, "h_swish")
    _close(_nhwc(F.h_sigmoid(tx)), J.fork.h_sigmoid(jnp.asarray(x)), 1, "h_sigmoid")
    for groups in (2, 4):
        np.testing.assert_array_equal(_nhwc(F.channel_shuffle(tx, groups)),
                                      np.asarray(J.fork.channel_shuffle(jnp.asarray(x), groups)))


def test_width_gate():
    """A same-width 3x3 bottleneck is fused at C in CHANNELS and gated at
    16, 20 and 48, where it runs its two convs in eval and matches JAX; the
    kernel's wrapper still refuses those widths on the card's path."""
    from spectrogram_yolov11_torch.ops.fused_conv import CHANNELS, _run_kernel

    for c in (16, 20, 32, 48, 64, 128):
        b = T.Bottleneck(c, c, e=1.0)
        assert (b.fusable, b.gated) == ((True, False) if c in CHANNELS else (False, True)), c
    assert not T.Bottleneck(32, 32).fusable and not T.Bottleneck(32, 32).gated  # e=0.5: two widths
    assert not T.C3(32, 32, 1).m[0].fusable and not T.C3(32, 32, 1).m[0].gated  # 1x1 then 3x3
    mod = _port_module(lambda: T.C3k(16, 16, 2), 3).eval()
    assert all(m.gated and m.w1 is None for m in mod.m)  # nothing folded: the plain path
    x = _inputs(1, 5)[0][..., :16]
    variables = {k: v for k, v in state_dict_to_variables(mod.state_dict()).items() if v}
    want = J.C3k(16, 16, 2).apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = mod(_to_torch([x])[0])
    _close(_nhwc(got), want, 1, "gated C3k")
    with pytest.raises(ValueError, match="C=16 not in"):
        _run_kernel("fused_bottleneck_f32", torch.zeros(1, 4, 4, 16), *([torch.zeros(1)] * 4), (2, 9, "C", "C"))


def _all_leaf_kinds() -> torch.nn.Module:
    """One module holding every leaf kind of the fork: convs, a dense layer,
    BN, LayerNorm and each bare parameter name."""
    return torch.nn.ModuleDict({"se": T.SELayer(32), "gct": T.GCT(32), "sobel": T.SobelConv(2, 2),
                                "eca": T.ECAAttention(32), "fgm": T.FGM(32), "rc": T.RecycleConv(32, 32, 3),
                                "fusion": T.Fusion((32, 32), "bifpn"), "bifpn": T.BiFPN_WConcat2(n=2),
                                "gc": T.GlobalContext(32), "ca": T.CoordAtt(32, 32)})


def test_bridge_round_trips_every_leaf_kind():
    """Weights, optimizer moments in tree and flat form, and the param groups
    of every fork leaf kind cross the bridge and back unchanged."""
    from spectrogram_yolov11_torch.utils.jax_compat import BARE_PARAMS

    mod = _port_module(_all_leaf_kinds, 7)
    sd = mod.state_dict()
    variables = state_dict_to_variables(sd)
    leaf_names = {p[-1] for p, _ in sorted_leaves(variables["params"])}
    assert BARE_PARAMS <= leaf_names and {"kernel", "bias", "scale"} <= leaf_names
    assert variables["params"]["se"]["fc_0"]["kernel"].shape == (32, 2)  # dense (in, out)
    np.testing.assert_array_equal(variables["params"]["se"]["fc_0"]["kernel"], sd["se.fc.0.weight"].numpy().T)
    back = variables_to_state_dict(variables)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    mod.load_state_dict(back, strict=True)

    names, params = zip(*mod.named_parameters())
    g = torch.Generator().manual_seed(1)
    mu = [torch.randn(p.shape, generator=g) for p in params]
    nu = [torch.rand(p.shape, generator=g) for p in params]
    tree = opt_state_to_flax(5, names, mu, nu)
    for form in (tree, {"step": tree["step"], "mu": np.asarray(flatten_tree(tree["mu"])),
                        "nu": np.asarray(flatten_tree(tree["nu"]))}):
        step, mu2, nu2 = opt_state_from_flax(form, names, params)
        assert step == 5
        assert all(torch.equal(a, b) for a, b in zip(mu + nu, mu2 + nu2))

    groups = param_groups(mod)
    code = {"decay": 0, "bias": 1, "norm": 2}
    coded = state_dict_to_variables({n: torch.full(p.shape, code[groups[n]]) for n, p in mod.named_parameters()})
    want = jax_param_groups(variables["params"])
    for (path, leaf), (_, label) in zip(sorted_leaves(coded["params"]), sorted_leaves(want)):
        assert (leaf == code[label]).all(), (path, label)


def test_init_kinds_match_jax():
    """init_weights draws each leaf as JAX's init does: the deterministic
    leaves (equal under two PRNG keys: ones, zeros, the Sobel kernels, zero
    offsets) equal JAX's; every random leaf lies within its initializer's
    bound (U(+-1/sqrt(fan_in)), or lecun's truncation at 2 / 0.8796 /
    sqrt(fan_in)), and the larger ones (64 or more values) have a standard
    deviation within 25 % of JAX's (uniform and lecun differ by sqrt(3))."""
    x = jnp.asarray(_inputs(1, 0)[0])
    for make_jax, make_port in ((jx(J.LDConv, 32, 16, 5), lambda: T.LDConv(32, 16, 5)),
                                (jx(J.SELayer, 32), lambda: T.SELayer(32)),
                                (jx(J.SAKAM, 32), lambda: T.SAKAM(32)),
                                (jx(J.RecycleConv, 32, 32, 3, 1), lambda: T.RecycleConv(32, 32, 3, 1)),
                                (jx(J.GlobalContext, 32), lambda: T.GlobalContext(32)),
                                (jx(J.ECAAttention, 32), lambda: T.ECAAttention(32)),
                                (jx(J.SobelSpatialAttention, 7), lambda: T.SobelSpatialAttention(7)),
                                (jx(J.FGM, 32), lambda: T.FGM(32)),
                                (jx(J.GCT, 32), lambda: T.GCT(32))):
        jv, jv1 = (jax.tree_util.tree_map(np.asarray, make_jax().init(jax.random.PRNGKey(k), x, train=False))
                   for k in (0, 1))
        mod = make_port()
        init_weights(mod, torch.Generator().manual_seed(0))
        pv = state_dict_to_variables(mod.state_dict())
        for (path, want), (_, other), (path2, got) in zip(sorted_leaves(jv["params"]), sorted_leaves(jv1["params"]),
                                                          sorted_leaves(pv["params"])):
            assert path == path2 and want.shape == got.shape
            what = f"{type(mod).__name__} {'/'.join(path)}"
            if np.array_equal(want, other):  # deterministic: the same under another key
                np.testing.assert_array_equal(got, want, err_msg=what)
                continue
            fan_in = int(np.prod(want.shape[:-1]))
            bound = max(np.abs(want).max(), np.abs(got).max())
            assert bound <= 2 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6, what
            if want.size >= 64:
                assert 0.75 <= got.std() / want.std() <= 1.25, (what, got.std(), want.std())
