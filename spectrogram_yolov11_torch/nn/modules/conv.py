"""Convolution-family modules (NCHW) of the port.

Counterparts of spectrogram_yolov11_tpu/nn/modules/conv.py: autopad,
get_act (:86, its "silu" and "relu"), batch_norm (:169), Conv (:190), DWConv (:255),
GhostConv (:414, the fork's: a 3x3 dilation-2 cheap branch), ChannelAttention
(:510), SpatialAttention (:523), CBAM (:536), Concat, Upsample. Attribute
names (`conv`, `bn`) match the JAX modules so the weight bridge maps names
mechanically. BN eps is 1e-3, as in the JAX package, not torch's default
1e-5, and in training BN follows flax (BatchNorm below).

In training a Conv computes in its input's dtype (the model casts its input
to its compute dtype, DetectionModel.set_compute_dtype) with f32 parameters,
as flax's Conv with dtype=bfloat16 and param_dtype=float32: the weight is
cast to that dtype for the conv, BN runs in f32 on the conv output upcast,
SiLU on the f32 result, and the output is rounded to the input's dtype. The
casts carry the gradients to the f32 weights. In f32 every cast is a no-op.

`init_kind` on Conv2d and Linear names the JAX initializer DetectionModel.init
draws them from: "torch" (U(+-1/sqrt(fan_in)) kernel and bias, the conv2d
helper and Conv), "lecun" (flax's default for nn.Conv and nn.Dense: a normal
truncated at 2 standard deviations of sqrt(1 / fan_in) / 0.8796, zero bias)
or "zeros".
"""

from __future__ import annotations

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


ACTS = {"silu": nn.SiLU, "relu": nn.ReLU}  # the names the ported modules pass (DualChannelHConv: "relu")


def get_act(act) -> nn.Module:
    """An activation spec as JAX's get_act reads it: True -> SiLU, False or
    None -> identity, a name -> that activation (KeyError for a name the port
    has no module passing, as JAX's for a name it does not know)."""
    if act is True:
        return nn.SiLU()
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
