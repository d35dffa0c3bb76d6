"""Convolution-family modules (NCHW) of the port.

Counterparts of spectrogram_yolov11_tpu/nn/modules/conv.py: autopad, ACTS
(:39), resolve_act_name (:57) and get_act (:79), batch_norm (:169), Conv
(:190), DWConv (:255), GhostConv (:414, the fork's: a 3x3 dilation-2 cheap
branch), RepConv (:436) with its deploy fold (fuse_repconv, :480) as
RepConv.folded, ChannelAttention (:510), SpatialAttention (:523), CBAM
(:536), Concat, Upsample and TorchConvTranspose2d (:641). JAX's MaxPool2d
(:596) and ZeroPad2d (:629) are torch's nn.MaxPool2d and nn.ZeroPad2d (the
same arguments), and its max_pool2d and avg_pool2d (:609-619) are
F.max_pool2d and F.avg_pool2d (both count the pad as flax's: -inf for the
max, in the window for the average). Attribute
names (`conv`, `bn`) match the JAX modules so the weight bridge maps names
mechanically. BN eps is 1e-3, as in the JAX package, not torch's default
1e-5, and in training BN follows flax (BatchNorm below).

In training a Conv computes in its input's dtype (the model casts its input
to its compute dtype, DetectionModel.set_compute_dtype) with f32 parameters,
as flax's Conv with dtype=bfloat16 and param_dtype=float32: the weight is
cast to that dtype for the conv, BN runs in f32 on the conv output upcast,
SiLU on the f32 result, and the output is rounded to the input's dtype. The
casts carry the gradients to the f32 weights. In f32 every cast is a no-op.

The model's default activation: a model YAML's `activation:` key (yolov6's
`nn.ReLU()`) names the activation of every `act=True` (Conv's default). JAX
pins it for each trace of its graph (nn/tasks.py:413-415); the port builds
its modules once, so parse_model sets it, by `default_act`, while it builds
them, and each module holds its activation from then on. The setting lives
in a context variable: two models built in turn, or in two threads, do not
see each other's.

`init_kind` on Conv2d and Linear names the JAX initializer DetectionModel.init
draws them from: "torch" (U(+-1/sqrt(fan_in)) kernel and bias, the conv2d
helper and Conv), "lecun" (flax's default for nn.Conv and nn.Dense: a normal
truncated at 2 standard deviations of sqrt(1 / fan_in) / 0.8796, zero bias)
or "zeros".
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.97  # flax's: running = 0.97 * running + 0.03 * batch (torch's momentum 0.03)


def autopad(k, p=None, d=1):
    """'same'-shape padding for odd kernels."""
    if d > 1:
        k = d * (k - 1) + 1 if isinstance(k, int) else [d * (x - 1) + 1 for x in k]
    if p is None:
        p = k // 2 if isinstance(k, int) else [x // 2 for x in k]
    return p


ACTS = {  # JAX's registry of activation names (conv.py:39)
    "silu": nn.SiLU,
    "relu": nn.ReLU,
    "relu6": nn.ReLU6,
    "elu": nn.ELU,
    "gelu": lambda: nn.GELU(approximate="tanh"),  # jax.nn.gelu's default
    "sigmoid": nn.Sigmoid,
    "tanh": nn.Tanh,
    "hardswish": nn.Hardswish,
    "hardsigmoid": nn.Hardsigmoid,
    "leakyrelu": lambda: nn.LeakyReLU(0.01),
    "identity": nn.Identity,
}
_DEFAULT_ACT = contextvars.ContextVar("default_act", default="silu")


def resolve_act_name(name) -> Optional[str]:
    """An activation spec (a key of ACTS, or a torch spelling such as
    'nn.ReLU()') as its key of ACTS; None when it is empty or unknown (JAX
    conv.py:57)."""
    if not name:
        return None
    key = str(name).lower().removeprefix("nn.").split("(")[0]
    return key if key in ACTS else None


@contextlib.contextmanager
def default_act(name: str):
    """The activation `act=True` builds while inside (a key of ACTS), restored
    on leaving."""
    token = _DEFAULT_ACT.set(name)
    try:
        yield
    finally:
        _DEFAULT_ACT.reset(token)


def get_act(act) -> nn.Module:
    """An activation spec as JAX's get_act reads it: True -> the model's
    default (SiLU unless default_act names another), False or None ->
    identity, a name -> that activation (KeyError for a name JAX does not
    know either)."""
    if act is True:
        return ACTS[_DEFAULT_ACT.get()]()
    if act in (False, None):
        return nn.Identity()
    return ACTS[str(act).lower()]()


class Conv2d(nn.Conv2d):
    """torch's Conv2d that computes in its input's dtype: its weight and bias
    are cast to it (no-ops when they already hold it), as flax's conv2d with
    dtype=bfloat16 casts its f32 parameters: Conv's conv, and the bare convs
    of the attention blocks and the Detect head."""

    def __init__(self, *args, init_kind: str = "torch", **kwargs):
        super().__init__(*args, **kwargs)
        self.init_kind = init_kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch's ConvTranspose2d that computes in its input's dtype, as JAX's
    conv_transpose2d (conv.py:371: flax's ConvTranspose with
    transpose_kernel=True, padding VALID) at dtype=bfloat16; flax's default
    init (lecun, fan_in = out channels x kh x kw, zero bias). flax's kernel
    (kh, kw, out, in) is the torch weight (in, out, kh, kw) by the bridge's
    HWIO -> OIHW transpose, unflipped: both are the gradient of a conv."""

    def __init__(self, *args, init_kind: str = "lecun", **kwargs):
        super().__init__(*args, **kwargs)
        self.init_kind = init_kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class Linear(nn.Linear):
    """torch's Linear that computes in its input's dtype, as flax's nn.Dense
    with dtype=bfloat16 (SELayer, SaELayer); flax's default init (lecun)."""

    def __init__(self, *args, init_kind: str = "lecun", **kwargs):
        super().__init__(*args, **kwargs)
        self.init_kind = init_kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """torch's BatchNorm2d (eps 1e-3) with flax's training semantics, as the
    JAX package's batch_norm(train=True) in f32: the input is normalised with
    its biased batch variance, and the running statistics move as
    ra = 0.97 * ra + 0.03 * batch with the biased variance too (torch's own
    training update takes momentum 0.1 and the unbiased variance). Eval
    normalises with the running statistics, as torch does."""

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def batch_norm(bn: BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """A bare BN as JAX's batch_norm: in training in f32 (the result stays
    f32), in eval in x's dtype."""
    return bn(x.float()) if bn.training else bn(x)


class Conv(nn.Module):
    """conv2d (no bias) + BatchNorm (eps 1e-3) + SiLU (or `act`: False for
    identity, or an activation's name)."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p: Optional[int] = None, g: int = 1, d: int = 1, act=True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.bn = BatchNorm2d(c2)
        self.act = get_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self.act(self.bn(self.conv(x)))
        return self.act(self.bn(self.conv(x).float())).to(x.dtype)

    def folded(self):
        """(weight OIHW, bias) with the eval-mode BN folded into the conv."""
        bn = self.bn
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        w = self.conv.weight * scale[:, None, None, None]
        return w, bn.bias - bn.running_mean * scale


class DWConv(Conv):
    """Depthwise Conv: groups = gcd(c1, c2)."""

    def __init__(self, c1: int, c2: int, k=1, s=1, d: int = 1, act: bool = True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)


class GhostConv(nn.Module):
    """The fork's Ghost convolution: half the channels from a k x k conv, the
    other half from a 3x3 dilation-2 conv of them (JAX conv.py:414)."""

    def __init__(self, c1: int, c2: int, k=1, s=1, g: int = 1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act=act)
        self.cv2 = Conv(c_, c_, 3, 1, None, 1, d=2, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return torch.cat((y, self.cv2(y)), 1)


class RepConv(nn.Module):
    """RepVGG's re-parameterisable conv (JAX conv.py:436): act(conv1(x) +
    conv2(x) + bn(x)), conv1 a 3x3 Conv and conv2 a 1x1 Conv at padding
    p - k // 2, both without activation, and the identity BN `bn` only where
    bn is set, c1 == c2 and s == 1. In training the branches run, BN on batch
    statistics. In eval it runs one biased 3x3 conv, the three branches
    folded into it by `fold()` (exact algebra): JAX folds where it deploys
    (nn/tasks.py:880 fuse_model: its predictor, AutoBackend and exporter)
    and its validator runs the branches; the port folds in every eval."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, p: int = 1, g: int = 1, d: int = 1, act=True,
                 bn: bool = False):
        super().__init__()
        if k != 3 or p != 1:
            raise ValueError(f"RepConv takes k = 3 and p = 1, as JAX's, got k = {k}, p = {p}")
        self.s, self.g = s, g
        self.conv1 = Conv(c1, c2, k, s, p=p, g=g, act=False)
        self.conv2 = Conv(c1, c2, 1, s, p=p - k // 2, g=g, act=False)
        self.bn = BatchNorm2d(c1) if bn and c2 == c1 and s == 1 else None
        self.act = get_act(act)
        for name in ("w", "b"):
            self.register_buffer(name, None, persistent=False)

    def folded(self):
        """(weight OIHW, bias) of the one conv equal to the three branches in
        eval (JAX's fuse_repconv): each branch's BN folded into it, the 1x1
        kernel added at the 3x3's centre, the identity BN as a centred
        per-group eye."""
        (w3, b3), (w1, b1) = self.conv1.folded(), self.conv2.folded()
        w, b = w3 + F.pad(w1, (1, 1, 1, 1)), b3 + b1
        if self.bn is not None:
            bn = self.bn
            s_id = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            out = torch.arange(w.shape[0])
            eye = torch.zeros_like(w)
            eye[out, out % w.shape[1], 1, 1] = s_id  # output channel o reads input o of its group
            w, b = w + eye, b + (bn.bias - bn.running_mean * s_id)
        return w, b

    @torch.no_grad()
    def fold(self, dtype: torch.dtype = torch.float32) -> None:
        """Fold the branches from the f32 weights and keep the conv's weight
        in `dtype`; the bias stays f32, as a fused bottleneck's pack keeps it."""
        w, b = self.folded()
        if w.dtype != torch.float32:
            raise ValueError(f"fold() folds the f32 weights, got {w.dtype}")
        self.w, self.b = w.to(dtype).contiguous(), b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if self.w is None:
                raise RuntimeError("RepConv weights are not folded: call model.fold() after loading weights")
            y = F.conv2d(x, self.w.to(x.dtype), None, self.s, 1, 1, self.g)
            return self.act(y.float() + self.b[:, None, None]).to(x.dtype)  # Conv's epilogue: one rounding
        y = self.conv1(x) + self.conv2(x)
        if self.bn is not None:
            y = y + batch_norm(self.bn, x)
        return self.act(y).to(x.dtype)


def mean_max(x: torch.Tensor) -> torch.Tensor:
    """The channel mean and max maps, (B, 2, H, W), in x's dtype."""
    return torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)


class ChannelAttention(nn.Module):
    """Global average pool -> 1x1 conv (bias) -> sigmoid channel gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """Spatial gate from the channel mean and max maps: k x k conv -> sigmoid."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.cv1 = Conv2d(2, 1, kernel_size, 1, kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.cv1(mean_max(x)))


class CBAM(nn.Module):
    """Channel then spatial attention. parse_model hands the scaled width in
    as kernel_size; like JAX's, any size but 3 and 7 becomes 7."""

    def __init__(self, c1: int, kernel_size: int = 7):
        super().__init__()
        k = kernel_size if kernel_size in {3, 7} else 7
        self.channel_attention = ChannelAttention(c1)
        self.spatial_attention = SpatialAttention(k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial_attention(self.channel_attention(x))


class Concat(nn.Module):
    """Concatenate a list of NCHW tensors along `dimension` (channels)."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.d = dimension

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat(xs, self.d)


class Upsample(nn.Module):
    """Nearest-neighbour upsampling by an integer factor (nn.Upsample in the yamls)."""

    def __init__(self, size=None, scale_factor: float = 2.0, mode: str = "nearest"):
        super().__init__()
        if size is not None or mode != "nearest" or scale_factor != int(scale_factor):
            raise NotImplementedError("only nearest upsampling by an integer factor is ported")
        self.scale = int(scale_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class TorchConvTranspose2d(nn.Module):
    """nn.ConvTranspose2d in the YAMLs (JAX conv.py:641; yolov6's upsampling):
    a transposed conv with bias, no BN and no activation."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0):
        super().__init__()
        self.conv_transpose = ConvTranspose2d(c1, c2, k, s, p, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_transpose(x)
