"""Convolution-family modules (NCHW) of the port.

Counterparts of spectrogram_yolov11_tpu/nn/modules/conv.py: autopad,
batch_norm (:169), Conv (:190), DWConv (:255), Concat, Upsample. Attribute
names (`conv`, `bn`) match the JAX modules so the weight bridge maps names
mechanically. BN eps is 1e-3, as in the JAX package, not torch's default
1e-5, and in training BN follows flax (BatchNorm below).

In training a Conv computes in its input's dtype (the model casts its input
to its compute dtype, DetectionModel.set_compute_dtype) with f32 parameters,
as flax's Conv with dtype=bfloat16 and param_dtype=float32: the weight is
cast to that dtype for the conv, BN runs in f32 on the conv output upcast,
SiLU on the f32 result, and the output is rounded to the input's dtype. The
casts carry the gradients to the f32 weights. In f32 every cast is a no-op.
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


class Conv2d(nn.Conv2d):
    """torch's Conv2d that computes in its input's dtype: its weight and bias
    are cast to it (no-ops when they already hold it), as flax's conv2d with
    dtype=bfloat16 casts its f32 parameters: Conv's conv, and the bare convs
    of HCoordAtt and the Detect head."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


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


class Conv(nn.Module):
    """conv2d (no bias) + BatchNorm (eps 1e-3) + SiLU (or identity with act=False)."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p: Optional[int] = None, g: int = 1, d: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.bn = BatchNorm2d(c2)
        self.act = nn.SiLU() if act is True else nn.Identity()

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
