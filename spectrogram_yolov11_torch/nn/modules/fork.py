"""The spectrogram fork's module zoo (NCHW).

Counterpart of spectrogram_yolov11_tpu/nn/modules/fork.py, every class of it:
the helpers (:33-41), the squeeze and gate blocks (SELayer :47 to
ECAAttention :176), coordinate attention (:196-257), the deformable LDConv
(:272) and its attention blocks (:341-387), the FFT blocks FGM (:411) and
BottleNect (:430), the conv hybrids (:459-645), RecycleConv, Mix_SPPF and SAPF
(:645-713), the necks (SelectChannel :736, Fusion :750, the BiFPN concats
:799-830) and the CSP blocks (:840-1088). Dropout and DropPath are identity,
as in JAX (:13).

Attribute names follow the JAX modules', so the weight bridge
(utils/jax_compat.py) maps them mechanically: a flax name `fc_0` is the
module `fc` of a Sequential or ModuleDict holding it at `0`. Bare parameters
(JAX's `self.param`) keep JAX's names and shapes, NHWC or HWIO as JAX holds
them, and are permuted where they are used.

Dtypes follow the JAX modules at dtype=bfloat16: each conv and dense layer
computes in its input's dtype (the model's: bf16 in the bf16 copy and in amp
training); GCT, SobelConv, RecycleConv, the FFTs and the LDConv sampling
compute in f32 and round to the input's dtype where JAX does; a bare BN
returns f32 in training (conv.batch_norm), and the next conv rounds to the
input's dtype as JAX's conv with dtype=bfloat16 does. The BiFPN concats and
Fusion's bifpn mode round their f32 weighted sum to the input's dtype where
JAX's returns f32: in the zoo their only consumers are C3k2s, whose first
conv rounds to bf16 first, so the network is the same. ECAAttention raises
for any input but f32, as JAX's conv of a bf16 input with its f32 kernel does.

`init_params(g)` draws a module's bare parameters as JAX's init does (ones,
zeros, the Sobel kernels, or U(+-1/sqrt(fan_in))); DetectionModel.init calls
it.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .block import C3, Bottleneck, C2f
from .conv import Conv, Conv2d, Linear, autopad, batch_norm, BatchNorm2d, mean_max


def h_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3) / 6


def h_swish(x: torch.Tensor) -> torch.Tensor:
    return x * h_sigmoid(x)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Channel shuffle: channel g * (C / groups) + j moves to j * groups + g."""
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


def nhwc_param(p: torch.Tensor) -> torch.Tensor:
    """A JAX-shaped (1, 1, 1, C) parameter as (1, C, 1, 1)."""
    return p.permute(0, 3, 1, 2)


def _uniform_fan_in(p: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))


class SELayer(nn.Module):
    """Squeeze-excite: global mean -> dense -> ReLU -> dense -> sigmoid gate."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(Linear(channel, channel // reduction, bias=False), nn.ReLU(),
                                Linear(channel // reduction, channel, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.fc(x.mean((2, 3))))[:, :, None, None]


class SaELayer(nn.Module):
    """Split-excite with 4 cardinal dense branches, concatenated, then a dense gate."""

    def __init__(self, in_channel: int, reduction: int = 32):
        super().__init__()
        r = in_channel // reduction
        for i in range(1, 5):
            setattr(self, f"fc{i}", nn.Sequential(Linear(in_channel, r, bias=False)))
        self.fc = nn.Sequential(Linear(4 * r, in_channel, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean((2, 3))
        y = torch.cat([F.relu(getattr(self, f"fc{i}")(y)) for i in range(1, 5)], -1)
        return x * torch.sigmoid(self.fc(y))[:, :, None, None]


class GCT(nn.Module):
    """Gated channel transform, l2 mode, in f32 (its parameters are f32 and
    JAX builds it without a dtype), rounded to x's dtype."""

    def __init__(self, num_channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        for name in ("alpha", "gamma", "beta"):
            self.register_parameter(name, nn.Parameter(torch.empty(1, 1, 1, num_channels)))
        self.init_params(None)

    @torch.no_grad()
    def init_params(self, g) -> None:
        self.alpha.fill_(1.0)
        self.gamma.zero_()
        self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        embedding = torch.sqrt(xf.pow(2).sum((2, 3), keepdim=True) + self.epsilon) * nhwc_param(self.alpha)
        norm = nhwc_param(self.gamma) / torch.sqrt(embedding.pow(2).mean(1, keepdim=True) + self.epsilon)
        gate = 1.0 + torch.tanh(embedding * norm + nhwc_param(self.beta))
        return (xf * gate).to(x.dtype)


class WeightedSpatialAttention(nn.Module):
    """Mean + max spatial gate through a k x k conv."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.cv1 = Conv2d(2, 1, kernel_size, 1, kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.cv1(mean_max(x)))


SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32)


class SobelConv(nn.Module):
    """Three trainable depthwise 3x3 convs initialised to Sobel kernels (0,
    ~45 and 90 degrees), summed; in f32, rounded to x's dtype. Each kernel is
    the bare parameter `convs_<i>`, HWIO (3, 3, 1, out_channels)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 16):
        super().__init__()
        self.out_channels = out_channels
        for i in range(3):
            self.register_parameter(f"convs_{i}", nn.Parameter(torch.empty(3, 3, 1, out_channels)))
        self.init_params(None)

    @torch.no_grad()
    def init_params(self, g) -> None:
        for i, k0 in enumerate((SOBEL_X, SOBEL_X + SOBEL_Y, SOBEL_Y)):
            getattr(self, f"convs_{i}").copy_(torch.from_numpy(k0)[:, :, None, None].expand(3, 3, 1, self.out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        out = 0
        for i in range(3):
            w = getattr(self, f"convs_{i}").permute(3, 2, 0, 1)
            out = out + F.conv2d(xf, w, padding=1, groups=self.out_channels)
        return out.to(x.dtype)


class SobelSpatialAttention(nn.Module):
    """Spatial gate from the Sobel-filtered mean and max maps."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.sobel = SobelConv(2, 2)
        self.cv1 = Conv2d(2, 1, 1, 1, 0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.cv1(self.sobel(mean_max(x))))


class MSCSpatialAttention(nn.Module):
    """Multi-scale (31x31 and 3x3) spatial gates and a shared channel gate, with
    the identity residual."""

    def __init__(self, c1: int, kernel_size: int = 7):
        super().__init__()
        self.cv1 = nn.Sequential(Conv2d(2, 1, 31, 1, 15, bias=False))
        self.cv2 = nn.Sequential(Conv2d(2, 1, 3, 1, 1, bias=False))
        self.fc = Conv2d(c1, c1, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stat = mean_max(x)
        x4 = x * F.relu(self.cv1(stat))
        x5 = x * F.relu(self.cv2(stat))
        g = F.relu(self.fc((x4 + x5).mean((2, 3), keepdim=True)))
        return x4 * g + x5 * g + x


class ECAAttention(nn.Module):
    """Efficient channel attention: a 1-D conv over the pooled channels, then
    ReLU (the fork's, not a sigmoid); returns the (B, C, 1, 1) gate alone.
    The kernel is the bare parameter `conv`, (k, 1, 1)."""

    def __init__(self, c1: int, k_size: int = 3):
        super().__init__()
        self.k_size = k_size
        self.conv = nn.Parameter(torch.empty(k_size, 1, 1))
        self.init_params(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_params(self, g) -> None:
        _uniform_fan_in(self.conv, self.k_size, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != self.conv.dtype:
            raise TypeError(f"ECAAttention convolves a {x.dtype} input with its {self.conv.dtype} kernel, "
                            "which JAX's lax.conv_general_dilated refuses as well")
        y = F.conv1d(x.mean((2, 3))[:, None, :], self.conv.permute(2, 1, 0), padding=self.k_size // 2)
        return F.relu(y[:, 0])[:, :, None, None]


class CoordAtt(nn.Module):
    """Coordinate attention: pooled rows and columns -> shared 1x1 + BN +
    h_swish -> per-axis sigmoid gates."""

    def __init__(self, inp: int, oup: int, reduction: int = 32):
        super().__init__()
        mip = max(8, inp // reduction)
        self.conv1 = Conv2d(inp, mip, 1, bias=True)
        self.bn1 = BatchNorm2d(mip)
        self.conv_h = Conv2d(mip, oup, 1, bias=True)
        self.conv_w = Conv2d(mip, oup, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[2]
        y = torch.cat([x.mean(3), x.mean(2)], 2)[..., None]  # (B, C, H + W, 1)
        y = h_swish(batch_norm(self.bn1, self.conv1(y))).to(x.dtype)
        a_h = torch.sigmoid(self.conv_h(y[:, :, :h]))  # (B, oup, H, 1)
        a_w = torch.sigmoid(self.conv_w(y[:, :, h:])).transpose(2, 3)  # (B, oup, 1, W)
        return x * a_w * a_h


class HCoordAtt(nn.Module):
    """Per-column (time-axis) gate for spectrograms: the channel mean and max
    maps -> bare 3x3 conv -> sigmoid -> average over H -> multiply each column.

    `cv1` is a bare conv (no BN, no bias), as in the JAX module. The mean and
    max, the conv, the sigmoid and the gate run in x's dtype (bf16 in amp
    training and in the bf16 copy), as the JAX module at dtype=bfloat16."""

    def __init__(self, inp: int, oup: int, reduction: int = 32):
        super().__init__()
        self.cv1 = Conv2d(2, 1, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.cv1(mean_max(x))).mean(2, keepdim=True)  # (B, 1, 1, W)
        return x * gate


class MaxHCoordAtt(nn.Module):
    """Max over H -> 1x1 + BN + h_swish -> 1x1 -> sigmoid gate per column and channel."""

    def __init__(self, inp: int, oup: int, reduction: int = 32):
        super().__init__()
        mip = max(8, inp // reduction)
        self.conv1 = Conv2d(inp, mip, 1, bias=True)
        self.bn1 = BatchNorm2d(mip)
        self.conv_m = Conv2d(mip, oup, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = h_swish(batch_norm(self.bn1, self.conv1(x.amax(2, keepdim=True)))).to(x.dtype)
        return x * torch.sigmoid(self.conv_m(y))


class GlobalStdPool2d(nn.Module):
    """Standard deviation over H, keeping W: (B, C, 1, W)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(2, keepdim=True)
        return torch.sqrt((x - mean).pow(2).mean(2, keepdim=True) + 1e-5)


def _clip(t: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip, with its gradient: min(max(t, lo), hi), where a tie passes half."""
    return torch.minimum(torch.maximum(t, t.new_tensor(lo)), t.new_tensor(hi))


class LDConv(nn.Module):
    """Deformable conv with `num_param` sampling points: a 3x3 conv (zero
    init) gives each point's offset from its place on the initial grid; x is
    sampled bilinearly there (JAX's clamping to the map and its four corner
    weights, in f32), the samples are stacked along H and reduced by a
    (num_param, 1) conv of stride (num_param, 1), then a sigmoid. The
    gradient reaches x through the gather and the offsets through the
    weights."""

    def __init__(self, inc: int, outc: int, num_param: int, stride: int = 1):
        super().__init__()
        self.num_param, self.stride = num_param, stride
        self.p_conv = Conv2d(inc, 2 * num_param, 3, stride, 1, bias=True, init_kind="zeros")
        self.conv = nn.Sequential(Conv2d(inc, outc, (num_param, 1), (num_param, 1), bias=False, init_kind="lecun"))
        self.register_buffer("p_n", torch.from_numpy(self._p_n()), persistent=False)

    def _p_n(self) -> np.ndarray:
        """The initial grid's (row offsets, column offsets), (2N,)."""
        n = self.num_param
        base = round(math.sqrt(n))
        rows, mod = n // base, n % base
        gx, gy = np.meshgrid(np.arange(rows), np.arange(base), indexing="ij")
        px, py = gx.reshape(-1), gy.reshape(-1)
        if mod > 0:
            mx, my = np.meshgrid(np.arange(rows, rows + 1), np.arange(mod), indexing="ij")
            px = np.concatenate([px, mx.reshape(-1)])
            py = np.concatenate([py, my.reshape(-1)])
        return np.concatenate([px, py]).astype(np.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s = self.num_param, self.stride
        b, c, h, w = x.shape
        offset = self.p_conv(x).permute(0, 2, 3, 1).float()  # (B, H', W', 2N)
        hp, wp = offset.shape[1:3]
        gy0, gx0 = torch.meshgrid(torch.arange(hp, device=x.device) * s, torch.arange(wp, device=x.device) * s,
                                  indexing="ij")
        p0 = torch.cat([gy0[..., None].expand(hp, wp, n), gx0[..., None].expand(hp, wp, n)], -1).float()
        p = p0 + self.p_n + offset
        pr, pc = _clip(p[..., :n], 0, h - 1), _clip(p[..., n:], 0, w - 1)
        r0, c0 = _clip(torch.floor(pr), 0, h - 1), _clip(torch.floor(pc), 0, w - 1)
        r1, c1 = _clip(r0 + 1, 0, h - 1), _clip(c0 + 1, 0, w - 1)
        flat = x.reshape(b, c, h * w)

        def gather(rows, cols):  # (B, C, H', W', N)
            # a NaN position (from a NaN input) gathers index 0, as XLA converts NaN to the integer 0 in
            # JAX's; its corner weights are NaN, so the output is NaN in both, and no index leaves the map
            idx = (rows * w + cols).nan_to_num(0.0).long().reshape(b, 1, -1).expand(b, c, -1)
            return torch.gather(flat, 2, idx).view(b, c, hp, wp, n)

        g_lt = (1 + (r0 - pr)) * (1 + (c0 - pc))
        g_rb = (1 - (r1 - pr)) * (1 - (c1 - pc))
        g_lb = (1 + (r0 - pr)) * (1 - (c1 - pc))
        g_rt = (1 - (r1 - pr)) * (1 + (c0 - pc))
        xo = (g_lt[:, None] * gather(r0, c0) + g_rb[:, None] * gather(r1, c1)
              + g_lb[:, None] * gather(r0, c1) + g_rt[:, None] * gather(r1, c0)).to(x.dtype)
        xo = xo.permute(0, 1, 2, 4, 3).reshape(b, c, hp * n, wp)  # the points stacked along H
        return torch.sigmoid(self.conv(xo))


class AKSpatialAttention(nn.Module):
    """LDConv spatial gate over the mean and max maps."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.cv1 = LDConv(2, 1, 7, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.cv1(mean_max(x))


class SAKAM(nn.Module):
    """Two LDConv spatial gates (7 and 15 points), a shared pooled channel
    gate (flax's nn.Conv, default init) on both, and the identity residual."""

    def __init__(self, c1: int, kernel_size: int = 7):
        super().__init__()
        self.cv1 = LDConv(2, 1, 7, 1)
        self.cv2 = LDConv(2, 1, 15, 1)
        self.fc = Conv2d(c1, c1, 1, bias=True, init_kind="lecun")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stat = mean_max(x)
        x4, x5 = x * self.cv1(stat), x * self.cv2(stat)
        g = F.relu(self.fc((x4 + x5).mean((2, 3), keepdim=True)))
        return x4 * g + x5 * g + x


class AKCBAM(nn.Module):
    """CBAM variant whose attention is SAKAM."""

    def __init__(self, c1: int, kernel_size: int = 7):
        super().__init__()
        self.spatial_attention = SAKAM(c1, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial_attention(x)


class Cross_AKConv(nn.Module):
    """Bottleneck whose first conv is a 5-point LDConv."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = LDConv(c1, c_, 5, 1)
        self.cv2 = Conv(c_, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


def _fft_modulate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|ifft2(a * fft2(b))| over H and W, in f32 (complex64), as JAX's on f32."""
    return torch.fft.ifft2(a.float() * torch.fft.fft2(b.float(), dim=(2, 3)), dim=(2, 3)).abs()


class FGM(nn.Module):
    """Frequency-gated modulation: |ifft2(x1 * fft2(x2))| * alpha + x * beta,
    the FFTs in f32 under bf16 too, as JAX casts to f32 before its FFT;
    alpha and beta are bare (1, 1, 1, dim) parameters."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv1 = Conv2d(dim, dim, 1, bias=True)
        self.dwconv2 = Conv2d(dim, dim, 1, bias=True)
        self.alpha = nn.Parameter(torch.empty(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.empty(1, 1, 1, dim))
        self.init_params(None)

    @torch.no_grad()
    def init_params(self, g) -> None:
        self.alpha.zero_()
        self.beta.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _fft_modulate(self.dwconv1(x), self.dwconv2(x))
        return (out * nhwc_param(self.alpha) + x.float() * nhwc_param(self.beta)).to(x.dtype)


class BottleNect(nn.Module):
    """FFT channel attention: 1x1 + GELU -> FFT gated by the pooled channels ->
    channel gate -> FGM -> ReLU."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_conv = nn.Sequential(Conv2d(dim, dim, 1, bias=True))
        self.fac_conv = Conv2d(dim, dim, 1, bias=True)
        self.conv = Conv2d(dim, dim, 1, bias=True)
        self.fgm = FGM(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.gelu(self.in_conv(x))
        x_att = self.fac_conv(out.mean((2, 3), keepdim=True))
        x_fca = _fft_modulate(x_att, out).to(out.dtype)
        x_sca = self.conv(x_fca.mean((2, 3), keepdim=True)) * x_fca
        return F.relu(self.fgm(x_sca))


class ConvOMN(nn.Module):
    """Conv, then BottleNect's FFT attention."""

    def __init__(self, c1: int, c2: int, k=3, s=2, d: int = 1, act=True):
        super().__init__()
        self.conv = Conv(c1, c2, k, s, d=d, act=act)
        self.omn = BottleNect(c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.omn(self.conv(x))


class DDWConv(nn.Module):
    """Grouped conv (8 groups) + pointwise Conv."""

    def __init__(self, c1: int, c2: int, k=3, s=2, d: int = 1, act=True):
        super().__init__()
        self.conv1 = Conv(c1, c2, k, s, g=8, d=d, act=act)
        self.conv2 = Conv(c2, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class MaxConv(nn.Module):
    """Grouped downsample + pointwise, beside its vertical (k, 1) max filter."""

    def __init__(self, c1: int, c2: int, k=3, s=2, d: int = 1, act=True):
        super().__init__()
        self.k = k
        self.conv2 = Conv(c1, c2 // 2, k, s, g=8)
        self.conv3 = Conv(c2 // 2, c2 // 2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv3(self.conv2(x))
        return torch.cat([x1, F.max_pool2d(x1, (self.k, 1), 1, (self.k // 2, 0))], 1)


class MaxConvHCA(nn.Module):
    """Time-axis (1, k) max-pool downsample + pointwise Conv + HCoordAtt."""

    def __init__(self, c1: int, c2: int, k=3, s=2, d: int = 1, act=True):
        super().__init__()
        self.k, self.s = k, s
        self.conv2 = Conv(c1, c2, 1, 1)
        self.msc = HCoordAtt(c2, c2, 32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.msc(self.conv2(F.max_pool2d(x, (1, self.k), self.s, (0, self.k // 2))))


class FilterMaxConv(nn.Module):
    """Conv downsample + horizontal (1, k) max filter + HCoordAtt."""

    def __init__(self, c1: int, c2: int, k=3, s=2, d: int = 1, act=True):
        super().__init__()
        self.k = k
        self.conv2 = Conv(c1, c2, k, s)
        self.msc = HCoordAtt(c2, c2, 32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.msc(F.max_pool2d(self.conv2(x), (1, self.k), 1, (0, self.k // 2)))


class PartialConvMax(nn.Module):
    """Conv beside its horizontal max filter -> squeeze (8) and expand 1x1s with ReLU."""

    def __init__(self, c1: int, c2: int, k=3, s=2, d: int = 1, act=True):
        super().__init__()
        self.k = k
        self.conv2 = Conv(c1, c1, k, s)
        self.fc = nn.Sequential(Conv2d(2 * c1, 8, 1, bias=True))
        self.fc1 = nn.Sequential(Conv2d(8, c2, 1, bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv2(x)
        x3 = torch.cat([x1, F.max_pool2d(x1, (1, self.k), 1, (0, self.k // 2))], 1)
        return F.relu(self.fc1(F.relu(self.fc(x3))))


class ConvHCA(nn.Module):
    """Conv + Sobel spatial attention."""

    def __init__(self, c1: int, c2: int, k=3, s=2, d: int = 1, act=True):
        super().__init__()
        self.conv2 = Conv(c1, c2, k, s)
        self.hca = SobelSpatialAttention(7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.hca(self.conv2(x))


class GhostConvMax(nn.Module):
    """Conv beside its vertical max filter -> pointwise Conv -> HCoordAtt."""

    def __init__(self, c1: int, c2: int, k=3, s=2, d: int = 1, act=True):
        super().__init__()
        self.k = k
        self.conv2 = Conv(c1, c1, k, s)
        self.conv3 = Conv(c1 * 2, c2, 1, 1)
        self.hca = HCoordAtt(c2, c2, 32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv2(x)
        x3 = torch.cat([x1, F.max_pool2d(x1, (self.k, 1), 1, (self.k // 2, 0))], 1)
        return self.hca(self.conv3(x3))


class GhostMaxConv(nn.Module):
    """Grouped downsample + pointwise, beside its vertical max filter, -> HCoordAtt."""

    def __init__(self, c1: int, c2: int, k=3, s=2, d: int = 1, act=True):
        super().__init__()
        self.k = k
        self.conv2 = Conv(c1, c2 // 2, k, s, g=8)
        self.conv3 = Conv(c2 // 2, c2 // 2, 1, 1)
        self.hca = HCoordAtt(c2, c2, 32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv3(self.conv2(x))
        return self.hca(torch.cat([x1, F.max_pool2d(x1, (self.k, 1), 1, (self.k // 2, 0))], 1))


class GhostConvHCA(nn.Module):
    """The fork's GhostConv (3x3 dilation-2 cheap branch) + HCoordAtt."""

    def __init__(self, c1: int, c2: int, k=1, s=1, g: int = 1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act=act)
        self.cv2 = Conv(c_, c_, 3, 1, None, 1, d=2, act=act)
        self.hca = HCoordAtt(c2, c2, 32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return self.hca(torch.cat([y, self.cv2(y)], 1))


class RecycleConv(nn.Module):
    """Weight-recycling chunked conv: x in 8 channel chunks; the first uses
    the kernel, the other 7 the kernel times a learned per-input-channel
    scale; one BN (f32, its statistics updated once per chunk in training,
    as flax's) + SiLU shared by all. In f32, each chunk's result rounded to
    x's dtype. The kernel is the bare parameter `conv`, HWIO (k, k, c1/8,
    c2/8), and `trainable_scale` (1, 1, c1/8, 1)."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1, d: int = 1, act=True):
        super().__init__()
        c_in, c_ = c1 // 8, c2 // 8
        self.s, self.d, self.p = s, d, autopad(k, p, d)
        kk = (k, k) if isinstance(k, int) else tuple(k)
        self.conv = nn.Parameter(torch.empty(kk[0], kk[1], c_in, c_))
        self.trainable_scale = nn.Parameter(torch.empty(1, 1, c_in, 1))
        self.bn_silu = nn.Sequential(BatchNorm2d(c_))
        self.init_params(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_params(self, g) -> None:
        kh, kw, c_in, _ = self.conv.shape
        _uniform_fan_in(self.conv, kh * kw * c_in, g)
        self.trainable_scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for i, ch in enumerate(x.chunk(8, 1)):
            kern = self.conv if i == 0 else self.conv * self.trainable_scale
            y = F.conv2d(ch.float(), kern.permute(3, 2, 0, 1), stride=self.s, padding=self.p, dilation=self.d)
            outs.append(F.silu(self.bn_silu[0](y)).to(x.dtype))
        return torch.cat(outs, 1)


class Mix_SPPF(nn.Module):
    """SPPF variant: SE-gated 1x1, a pointwise + depthwise branch beside an
    avg -> max pool branch resized back bilinearly (jax.image.resize
    'linear' upsamples as half-pixel bilinear does), concat, 1x1. Dropout is
    identity."""

    def __init__(self, c1: int, c2: int, k: int = 5, dropout_rate: float = 0.3):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.se_layer_after_cv1 = SELayer(c_)
        self.conv1x1_se = Conv(c_, c_, 1, 1)
        self.conv1x1_after_branch1 = Conv(c_, c_, 1, 1)
        self.dwconv = Conv(c_, c_, 3, 1, g=c_)
        self.conv1x1_final = Conv(c_ * 2, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.se_layer_after_cv1(self.cv1(x))
        b1 = self.dwconv(self.conv1x1_after_branch1(self.conv1x1_se(x)))
        b2 = F.max_pool2d(F.avg_pool2d(x, 2, 1, 0), 2, 1, 0)
        b2 = F.interpolate(b2, size=b1.shape[2:], mode="bilinear", align_corners=False)
        return self.conv1x1_final(torch.cat([b1, b2], 1))


class SAPF(nn.Module):
    """SPPF with stacked dilated 3x3 convs (dilation 1, then 2)."""

    def __init__(self, c1: int, c2: int, k: int = 3):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.dilated_conv1 = Conv(c_, c_, k, 1, d=1)
        self.dilated_conv2 = Conv(c_, c_, k, 1, d=2)
        self.cv2 = Conv(c_ * 3, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y0 = self.cv1(x)
        y1 = self.dilated_conv1(y0)
        return self.cv2(torch.cat([y0, y1, self.dilated_conv2(y1)], 1))


class SelectChannel(nn.Module):
    """One channel gate (flax's nn.Conv, default init) shared by two inputs:
    x0 * g(x0) + x1 * g(x1)."""

    def __init__(self, c1: int):
        super().__init__()
        self.fc = Conv2d(c1, c1, 1, bias=True, init_kind="lecun")

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        g0, g1 = (F.relu(self.fc(x.mean((2, 3), keepdim=True))) for x in xs[:2])
        return xs[0] * g0 + xs[1] * g1


def _normalised_weights(w: torch.Tensor, relu: bool) -> torch.Tensor:
    w = F.relu(w) if relu else w
    return w / (w.sum() + 1e-4)


class Fusion(nn.Module):
    """Multi-input feature fusion, every mode of JAX's: weight, adaptive,
    concat, bifpn, SChannel, SChannel_new and ESChannel (the one parse_model
    builds): GCT over the concat, chunked back, plus a spatial gate of each
    input. GCT is sized by the concatenated width, as JAX's (the reference
    sizes it c1 * n). Only the chosen mode's parameters exist."""

    def __init__(self, inc_list: Sequence[int], fusion: str = "ESChannel", c1: int = 128):
        super().__init__()
        self.inc_list, self.mode = tuple(inc_list), fusion
        n = len(self.inc_list)
        if fusion in ("weight", "adaptive"):
            self.fusion_conv = nn.ModuleList(Conv(c, c, 1) for c in self.inc_list)
            if fusion == "adaptive":
                self.fusion_adaptive = Conv(sum(self.inc_list), n, 1)
        elif fusion == "bifpn":
            self.fusion_weight = nn.Parameter(torch.ones(n))
        elif fusion == "SChannel":
            self.fc = Conv2d(self.inc_list[0], c1, 1, bias=True, init_kind="lecun")
        elif fusion == "SChannel_new":
            self.fc = nn.Sequential(Conv2d(self.inc_list[0], 8, 1, bias=True, init_kind="lecun"))
            self.fc1 = nn.Sequential(Conv2d(8, c1, 1, bias=True, init_kind="lecun"))
        elif fusion != "concat":
            if fusion != "ESChannel":
                raise ValueError(f"unknown Fusion mode {fusion!r}")
            setattr(self, f"gsc{n}", GCT(sum(self.inc_list)))
            self.sab = WeightedSpatialAttention(3)

    @torch.no_grad()
    def init_params(self, g) -> None:
        if self.mode == "bifpn":
            self.fusion_weight.fill_(1.0)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        xs, mode, n = list(xs), self.mode, len(xs)
        if mode in ("weight", "adaptive"):
            xs = [conv(x) for conv, x in zip(self.fusion_conv, xs)]
            if mode == "weight":
                return sum(xs)
            w = self.fusion_adaptive(torch.cat(xs, 1)).softmax(1)
            return sum(w[:, i : i + 1] * xs[i] for i in range(n))
        if mode == "concat":
            return torch.cat(xs, 1)
        if mode == "bifpn":
            fw = _normalised_weights(self.fusion_weight, relu=True)
            return sum(fw[i] * xs[i].float() for i in range(n)).to(xs[0].dtype)
        if mode == "SChannel":
            return sum(x * F.relu(self.fc(x.mean((2, 3), keepdim=True))) for x in xs)
        if mode == "SChannel_new":
            return sum(x * F.relu(self.fc1(F.relu(self.fc(x.mean((2, 3), keepdim=True))))) for x in xs)
        chunks = getattr(self, f"gsc{n}")(torch.cat(xs, 1)).chunk(n, 1)
        return sum(chunk + self.sab(x) for chunk, x in zip(chunks, xs))


class _BiFPNWConcat(nn.Module):
    """Learnable-weight concat of `n` inputs and a 4-group channel shuffle; the
    weights (bare parameter `w`, ones) normalised by their sum (+1e-4), after
    a ReLU unless `relu_weights` is False."""

    relu_weights = True

    def __init__(self, n: int):
        super().__init__()
        self.w = nn.Parameter(torch.ones(n))

    @torch.no_grad()
    def init_params(self, g) -> None:
        self.w.fill_(1.0)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        w = _normalised_weights(self.w, self.relu_weights)
        cat = torch.cat([w[i] * x.float() for i, x in enumerate(xs)], 1)
        return channel_shuffle(cat, 4).to(xs[0].dtype)


class BiFPN_WConcat(_BiFPNWConcat):
    """The first form: inc_list given, raw weights (no ReLU)."""

    relu_weights = False

    def __init__(self, inc_list: Sequence[int] = (), dimension: int = 1):
        super().__init__(len(inc_list))


class BiFPN_WConcat2(_BiFPNWConcat):
    """ReLU'd weights; the reference's signature is (dimension) only, so the
    input count `n` comes from parse_model."""

    def __init__(self, dimension: int = 1, n: int = 2):
        super().__init__(n)


class BiFPN_WConcat3(BiFPN_WConcat2):
    """The same as BiFPN_WConcat2."""


class GlobalContext(nn.Module):
    """GCNet-style global context: a softmax over positions pools x (in f32),
    then 1x1 -> LayerNorm (flax's: f32, eps 1e-6, its variance formula) ->
    ReLU -> 1x1 -> sigmoid scale."""

    def __init__(self, channels: int, rd_ratio: float = 1.0 / 8):
        super().__init__()
        rd = max(1, int(channels * rd_ratio))
        self.conv_attn = Conv2d(channels, 1, 1, bias=True)
        self.mlp_scale_fc1 = Conv2d(channels, rd, 1, bias=True)
        self.mlp_scale_norm = nn.LayerNorm(rd, eps=1e-6)
        self.mlp_scale_fc2 = Conv2d(rd, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        attn = self.conv_attn(x).reshape(b, h * w).softmax(1)
        ctx = torch.einsum("bcn,bn->bc", x.reshape(b, c, h * w).float(), attn.float())[:, :, None, None].to(x.dtype)
        m = self.mlp_scale_fc1(ctx).float()
        # flax's LayerNorm over the channels: the variance as E[m^2] - E[m]^2, clamped at 0
        mean = m.mean(1, keepdim=True)
        var = torch.clamp(m.pow(2).mean(1, keepdim=True) - mean.pow(2), min=0.0)
        norm = self.mlp_scale_norm
        m = (m - mean) * (torch.rsqrt(var + norm.eps) * norm.weight[:, None, None]) + norm.bias[:, None, None]
        return x * torch.sigmoid(self.mlp_scale_fc2(F.relu(m).to(x.dtype)))


class Partial_conv3(nn.Module):
    """Partial conv: a 3x3 and then a 3x3 dilation-2 conv on the first
    dim / n_div channels, both kept, and the rest passed through."""

    def __init__(self, dim: int, n_div: int = 4):
        super().__init__()
        self.dc = dc = dim // n_div
        self.partial_conv3 = nn.ModuleDict({"1": Conv2d(dc, dc, 3, 1, 1, bias=False),
                                            "2": Conv2d(dc, dc, 3, 1, 2, dilation=2, bias=False)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x[:, : self.dc], x[:, self.dc :]
        x1_1 = self.partial_conv3["1"](x1)
        return torch.cat([x1_1, self.partial_conv3["2"](x1_1), x2], 1)


class Faster_Block(nn.Module):
    """FasterNet block: partial conv mixing + a 2-layer MLP, residual. DropPath is identity."""

    def __init__(self, inc: int, dim: int, n_div: int = 4, mlp_ratio: int = 2):
        super().__init__()
        if inc != dim:
            self.adjust_channel = Conv(inc, dim, 1)
        dc = dim // n_div
        self.spatial_mixing = Partial_conv3(dim, n_div)
        self.mlp = nn.Sequential(Conv(dc * 2 + (dim - dc), dim * mlp_ratio, 1),
                                 Conv2d(dim * mlp_ratio, dim, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "adjust_channel"):
            x = self.adjust_channel(x)
        return x + self.mlp(self.spatial_mixing(x))


class BottleneckX_CBam(nn.Module):
    """Faster_Block bottleneck."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3), e: float = 0.5):
        super().__init__()
        self.cv1 = Faster_Block(c1, c2)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return x + y if self.add else y


class DenseCross(nn.Module):
    """Dense cross-shaped conv: (k, 1) then (1, k) on its sum with x. With
    e < 1 and c1 == c2 the sum's widths differ, and it raises as JAX's does."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k: int = 3, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.ModuleDict({"1": Conv(c1, c_, (k, 1), 1), "2": Conv(c_, c2, (1, k), 1)})
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1_1 = self.cv1["1"](x)
        y = x1_1 + self.cv1["2"](x1_1 + x)
        return x + y if self.add else y


class XCBAM2C2f(nn.Module):
    """R-ELAN-style block: Faster_Block bottlenecks grown from cv1, merged, residual."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = nn.ModuleList(nn.Sequential(BottleneckX_CBam(c_, c_, shortcut, g, k=3, e=1.0)) for _ in range(n))
        self.cv2 = Conv((1 + n) * c_, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cv1(x)]
        for m in self.m:
            ys.append(m(ys[-1]))
        return x + self.cv2(torch.cat(ys, 1))


class C3GC(C3):
    """C3 (1x1 -> 3x3 bottlenecks) with a GlobalContext on cv2's half."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.gc = GlobalContext(int(c2 * e))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.gc(self.cv2(x))), 1))


class C3kGC(C3GC):
    """C3GC whose inner blocks are BottleNect."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 0, shortcut, g, e)
        self.m = nn.Sequential(*(BottleNect(int(c2 * e)) for _ in range(n)))


class C3k2GC(C2f):
    """C3k2 whose inner block is C3kGC (c3k=True) or BottleNect."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5, g: int = 1,
                 shortcut: bool = True):
        nn.Module.__init__(self)
        self._csp(c1, c2, n, e, lambda c: C3kGC(c, c, 2, shortcut, g) if c3k else BottleNect(c))


class C3MSCk(C3):
    """C3 with DenseCross inner blocks (e=1.0)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 0, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(DenseCross(c_, c_, shortcut, g, k=3, e=1.0) for _ in range(n)))


class C3MSCk2(C2f):
    """C3k2 whose inner block is C3MSCk (c3k=True) or DenseCross (e=0.5,
    which raises at any width, as in JAX and the reference: the SMSC family
    builds at m, l and x, where parse_model sets c3k)."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5, g: int = 1,
                 shortcut: bool = True):
        nn.Module.__init__(self)
        self._csp(c1, c2, n, e, lambda c: C3MSCk(c, c, 2, shortcut, g) if c3k else DenseCross(c, c, shortcut, g))


class MSBottleneck(Bottleneck):
    """Bottleneck with an MSCSpatialAttention in front."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3), e: float = 0.5):
        super().__init__(c1, c2, shortcut, g, k, e)
        self.fusable = self.gated = False  # the attention runs first: not the fused kernel's block
        self.msc = MSCSpatialAttention(c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(self.msc(x)))
        return x + y if self.add else y


class DualChannelHConv(nn.Module):
    """Two (3, 1) conv branches, concatenated, a two-step ReLU squeeze and
    HCoordAtt."""

    def __init__(self, c1: int, c2: int, shortcut: bool = False, g: int = 1, k: int = 3, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv3 = nn.ModuleDict({"1": Conv(c1, c_, (3, 1), 1)})
        self.cv7 = nn.ModuleDict({"1": Conv(c1, c_, (3, 1), 1)})
        self.se = nn.Sequential(Conv(2 * c_, c_, 1, act="relu"), Conv(c_, c2, 1, act="relu"))
        self.hca = HCoordAtt(c2, c2, 32)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.hca(self.se(torch.cat([self.cv3["1"](x), self.cv7["1"](x)], 1)))
        return x + y if self.add else y
