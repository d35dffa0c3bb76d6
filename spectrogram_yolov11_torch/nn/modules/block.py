"""Building blocks (NCHW) of the port: Bottleneck, C3k, C3k2, SPPF, the YOLO11
attention stack and the DFL decode.

Counterparts of spectrogram_yolov11_tpu/nn/modules/block.py: dfl_decode (:35),
Bottleneck (:69), C2f (:126), C3 (:151), C3k (:173), _c2f_forward (:195) as
C2f.forward, C3k2 (:204), SPPF (:246), Attention / PSABlock / C2PSA
(:264-357), Proto (:522, the segment head's mask prototypes), the fork's
C3x (:788), and _ResNetBasicBlock (:812) and TorchVision (:836), JAX's
from-scratch ResNet-18/34 stand-in for the torchvision backbone of
yolo11-cls-resnet18.yaml. The YOLOv8 and YOLOv10 families' blocks: C2
(:105, the p6 configs), GhostBottleneck (:449) and C3Ghost (:872, the ghost
configs), ResNetBlock (:916) and ResNetLayer (:938, yolov8-cls-resnet50 and
-101), and v10's SCDown (:377), PSA (:318), RepVGGDW (:392, its two
depthwise branches kept apart, not re-parameterised), CIB (:405) and C2fCIB
(:429). C2's inner bottlenecks are same-width 3x3 blocks and take the fused
kernel as C2f's do. The YOLOv3/v5 SPP (:230) and the YOLOv9 blocks:
RepBottleneck (:590) and RepCSP (:611), RepNCSPELAN4 (:632), ELAN1 (:657),
AConv (:677), ADown (:692), SPPELAN (:712), CBLinear (:729) and CBFuse
(:746). A RepBottleneck is a Bottleneck whose cv1 is a RepConv: once the
RepConv is folded it computes silu(conv3x3(silu(conv3x3(x) + b1)) + b2) + x,
the fused kernel's block, and RepCSP's (e=1.0) take the kernel at its
widths.

The inner bottlenecks of C3k (and C2f) are same-width 3x3 -> 3x3 residual
blocks. In the inference forward they run as one fused CUDA kernel
(ops/fused_conv.py:fused_bottleneck) on weights with BN folded in and packed
for the kernel once, by `fold()` after the weights are loaded or the model is
put in eval mode, in the dtype the network runs in (f32 or bf16). In training
BN uses batch statistics, so nothing can be folded: they run their two Convs
(cuDNN), as the JAX trainer does. C3k2's own Bottleneck keeps e=0.5, so its
two convs differ in width and it stays on the plain path, as do C3's (1x1
then 3x3).

The width gate: the kernel takes C in ops/fused_conv.py:CHANNELS. A
same-width 3x3 bottleneck of another width (C = 16, 20 or 48 in the fork's
zoo) is `gated`, decided by its shape when the model is built: it runs its
two convs in eval too, as JAX's production graph runs every bottleneck
through XLA's convs. The kernel itself still raises for such a width, and
nothing catches a failure to build or launch it.

In bf16 the rounding points are the JAX package's: the DFL decode's exp runs
in the logits' dtype with an f32 projection, and attention takes QK^T and AV
with f32 results, cast to v's dtype after the softmax and after AV. This holds
in amp training too: every block computes in its input's dtype (bf16), its
Convs casting their f32 weights (conv.py), its residual adds, concats and max
pools in bf16, as the JAX blocks at dtype=bfloat16 with train=True.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.fused_conv import CHANNELS, fused_bottleneck, pack_bottleneck_weights, pack_bottleneck_weights_bf16
from .conv import BatchNorm2d, Conv, Conv2d, ConvTranspose2d, DWConv, GhostConv, RepConv, autopad


@functools.lru_cache(maxsize=8)
def _dfl_proj(reg_max: int, device: torch.device) -> torch.Tensor:
    proj = torch.zeros(4 * reg_max, 8, dtype=torch.float32)
    for g in range(4):
        proj[g * reg_max : (g + 1) * reg_max, g] = torch.arange(reg_max, dtype=torch.float32)
        proj[g * reg_max : (g + 1) * reg_max, 4 + g] = 1.0
    return proj.to(device)


def dfl_decode(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """DFL integral decode: (..., 4*reg_max) logits -> (..., 4) LTRB distances.

    A copy of the JAX form: exp of the logits clamped to +-80 (no max
    subtraction) in the logits' dtype, then one (4*reg_max -> 8) projection in
    f32 whose first four columns are the bin-weighted sums and last four the
    normalisers. The projection's entries are small integers, so projecting
    bf16 exps in f32 is what JAX's bf16 matmul with an f32 result gives; the
    distances are f32 either way."""
    z = torch.exp(box_logits.clamp(-80.0, 80.0))
    # a trace makes the projection in its graph: a cached tensor made under it would be a fake one
    proj = (_dfl_proj.__wrapped__ if torch.compiler.is_exporting() else _dfl_proj)(reg_max, z.device)
    s = z.float() @ proj
    return s[..., :4] / s[..., 4:]


def _is_3x3(k) -> bool:
    return tuple(k) == (3, 3) if isinstance(k, (tuple, list)) else k == 3


class Bottleneck(nn.Module):
    """cv1 -> cv2 (+ residual); k holds each conv's kernel, an int or a pair.
    Same-width 3x3 residual instances whose width the kernel takes and whose
    activations are SiLU (the kernel's) are `fusable`: in eval they run the
    fused kernel on BN-folded weights set by `fold()`, in training their two
    convs. Those of another width or activation (a ReLU model's) are `gated`
    and run their two convs in both modes."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = self._first(c1, c_, k[0])
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2
        same_width_3x3 = self.add and c_ == c2 and _is_3x3(k[0]) and _is_3x3(k[1]) and g == 1
        silu = all(isinstance(m.act, nn.SiLU) for m in (self.cv1, self.cv2))
        self.fusable = same_width_3x3 and silu and c2 in CHANNELS
        self.gated = same_width_3x3 and not self.fusable
        for name in ("w1", "b1", "w2", "b2"):
            self.register_buffer(name, None, persistent=False)

    def _first(self, c1: int, c2: int, k) -> nn.Module:
        """The first conv, cv1."""
        return Conv(c1, c2, k, 1)

    @torch.no_grad()
    def fold(self, dtype: torch.dtype = torch.float32) -> None:
        """Fold both BNs into the weights in f32 and pack them for the kernel
        of `dtype`: f32 (ops/fused_conv.py:pack_bottleneck_weights) stored
        (18, C, C), bf16 (pack_bottleneck_weights_bf16) stored (9, C, C); 3-D,
        so a channels_last conversion of the model leaves them alone. The
        biases stay f32, as the kernel takes them. The convs' weights must
        still be f32."""
        (w1, b1), (w2, b2) = self.cv1.folded(), self.cv2.folded()
        if w1.dtype != torch.float32:
            raise ValueError(f"fold() folds the f32 weights, got {w1.dtype}")
        c = w1.shape[0]
        if dtype == torch.bfloat16:
            self.w1, self.w2 = (pack_bottleneck_weights_bf16(w.permute(2, 3, 1, 0)) for w in (w1, w2))
        elif dtype == torch.float32:
            self.w1, self.w2 = (pack_bottleneck_weights(w.permute(2, 3, 1, 0)).view(18, c, c) for w in (w1, w2))
        else:
            raise ValueError(f"the fused bottleneck runs in float32 or bfloat16, not {dtype}")
        self.b1, self.b2 = b1.contiguous(), b2.contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fusable or self.training:
            y = self.cv2(self.cv1(x))
            return x + y if self.add else y
        if self.w1 is None:
            raise RuntimeError("fused bottleneck weights are not folded: call model.fold() after loading weights")
        # NCHW -> NHWC: a view when the network runs channels_last (the pipeline
        # on the card), else one copy of x in and one of y out. The f32 pack is
        # stored (18, C, C), the bf16 one is its own shape (9, C, C)
        c = x.shape[1]
        w1, w2 = (w.view(2, 9, c, c) if w.dtype == torch.float32 else w for w in (self.w1, self.w2))
        y = fused_bottleneck(x.permute(0, 2, 3, 1).contiguous(), w1, self.b1, w2, self.b2)
        return y.permute(0, 3, 1, 2)


class C2f(nn.Module):
    """CSP block with dense growth: cv1 split in two, each of the `n` inner
    blocks grows from the last piece, cv2 merges them all (JAX's C2f and its
    shared _c2f_forward). Subclasses build it by `_csp` with their own inner
    block."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__()
        self._csp(c1, c2, n, e, lambda c: Bottleneck(c, c, shortcut, g, k=((3, 3), (3, 3)), e=1.0))

    def _csp(self, c1: int, c2: int, n: int, e: float, inner) -> None:
        """cv1, cv2 and the n blocks inner(c) at the hidden width c."""
        self.c = c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.cv2 = Conv((2 + n) * c, c2, 1)
        self.m = nn.ModuleList(inner(c) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C2(nn.Module):
    """CSP block with 2 convs (JAX block.py:105): cv1 split in two, `n`
    same-width 3x3 bottlenecks (e=1.0) on the first half, cv2 merging both."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.cv2 = Conv(2 * c, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c, c, shortcut, g, k=((3, 3), (3, 3)), e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).chunk(2, 1)
        return self.cv2(torch.cat((self.m(a), b), 1))


class C3(nn.Module):
    """CSP block with 3 convs: `n` inner bottlenecks (e=1.0, kernels `k`) on
    cv1's half, cv2's half beside them, cv3 merging. Subclasses replace `m`."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 k=((1, 1), (3, 3))):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, k=k, e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class C3k(C3):
    """C3 with `n` inner k x k bottlenecks (e=1.0, same width)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5, k: int = 3):
        super().__init__(c1, c2, n, shortcut, g, e, k=(k, k))


class C3x(C3):
    """The fork's C3x: C3 whose inner stack is one MSCSpatialAttention over
    the hidden channels (not the stock cross-conv C3x)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        from .fork import MSCSpatialAttention  # fork.py builds on this module

        super().__init__(c1, c2, 0, shortcut, g, e)
        self.m = MSCSpatialAttention(int(c2 * e))


class GhostBottleneck(nn.Module):
    """Ghost bottleneck (JAX block.py:449) on the fork's GhostConv: conv.0
    GhostConv 1x1 to c2 / 2, conv.1 a k x k depthwise conv at stride 2 (no
    activation; the identity at stride 1), conv.2 GhostConv 1x1 to c2 (no
    activation), plus the shortcut: at stride 2 a depthwise conv and a 1x1
    Conv (no activations), at stride 1 x itself, which needs c1 == c2 (JAX
    raises ValueError otherwise)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(GhostConv(c1, c_, 1, 1),
                                  DWConv(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
                                  GhostConv(c_, c2, 1, 1, act=False))
        if s == 2:
            self.shortcut = nn.Sequential(DWConv(c1, c1, k, s, act=False), Conv(c1, c2, 1, 1, act=False))
        elif c1 == c2:
            self.shortcut = nn.Identity()
        else:
            raise ValueError("GhostBottleneck s=1 requires c1 == c2")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + self.shortcut(x)


class C3Ghost(C3):
    """C3 whose `n` inner blocks are GhostBottleneck(c_, c_) (JAX block.py:872)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 0, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))


class C3k2(C2f):
    """YOLO11 block: C2f whose inner block is C3k (c3k=True) or a Bottleneck with e=0.5."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5, g: int = 1, shortcut: bool = True):
        nn.Module.__init__(self)
        self._csp(c1, c2, n, e, lambda c: C3k(c, c, 2, shortcut, g) if c3k else Bottleneck(c, c, shortcut, g, k=(3, 3), e=0.5))


class SPP(nn.Module):
    """Spatial pyramid pooling (JAX block.py:230): cv1 to c1 / 2, beside it a
    stride-1 max pool of each size in k over a -inf pad of k // 2, cv2
    merging them."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.k], 1))


class SPPF(nn.Module):
    """SPP-Fast: three stacked k x k stride-1 max pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(ys, 1))


class Attention(nn.Module):
    """Position-sensitive multi-head self-attention with a depthwise conv positional term.

    The JAX module reshapes `qkv` from NHWC channel order into (B, N, heads,
    2*key_dim + head_dim); in NCHW the map is flattened to (B, N, C) first, and
    `out` and `pe`'s input are taken back the same way."""

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim**-0.5
        h = dim + self.key_dim * num_heads * 2
        self.qkv = Conv(dim, h, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        N = H * W
        kd = self.key_dim
        qkv = self.qkv(x).flatten(2).transpose(1, 2).reshape(B, N, self.num_heads, 2 * kd + self.head_dim)
        q, k, v = qkv[..., :kd], qkv[..., kd : 2 * kd], qkv[..., 2 * kd :]
        # f32 results of both products, cast to v's dtype after the softmax and
        # after AV, as the JAX module's preferred_element_type (no-ops in f32)
        attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * self.scale
        attn = attn.softmax(dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn.float(), v.float()).to(v.dtype)

        def to_nchw(t):
            return t.reshape(B, N, C).transpose(1, 2).reshape(B, C, H, W)

        return self.proj(to_nchw(out) + self.pe(to_nchw(v)))


class PSABlock(nn.Module):
    """Attention + 2-layer conv FFN, both residual."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4, shortcut: bool = True):
        super().__init__()
        self.attn = Attention(c, num_heads=num_heads, attn_ratio=attn_ratio)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))
        self.add = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.attn(x)
        x = x + a if self.add else a
        f = self.ffn(x)
        return x + f if self.add else f


class PSA(nn.Module):
    """v10's position-sensitive attention block (JAX block.py:318): cv1 split
    in two, the second half through Attention (c // 64 heads, attn_ratio 0.5)
    and a 2-layer FFN, both residual, cv2 merging. c1 must equal c2; where c
    < 64 the head count is 0 and Attention raises ZeroDivisionError, as
    JAX's does at init."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"PSA needs c1 == c2, got {c1} and {c2}")
        self.c = c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.cv2 = Conv(2 * c, c1, 1)
        self.attn = Attention(c, attn_ratio=0.5, num_heads=c // 64)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).chunk(2, 1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat((a, b), 1))


class SCDown(nn.Module):
    """v10's separable downsample (JAX block.py:377): a 1x1 Conv to c2, then
    a k x k depthwise Conv at stride s with no activation."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv2(self.cv1(x))


class RepVGGDW(nn.Module):
    """silu(7x7 depthwise Conv + 3x3 depthwise Conv), both without
    activation (JAX block.py:392). The two branches stay apart, as JAX's:
    nothing is re-parameterised into one 7x7 kernel."""

    def __init__(self, ed: int):
        super().__init__()
        self.conv = Conv(ed, ed, 7, 1, 3, g=ed, act=False)
        self.conv1 = Conv(ed, ed, 3, 1, 1, g=ed, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """v10's conditional identity block (JAX block.py:405): cv1 is 3x3
    depthwise, 1x1 to 2 c_, 3x3 depthwise (RepVGGDW with `lk`), 1x1 to c2,
    3x3 depthwise; residual where shortcut and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(Conv(c1, c1, 3, g=c1), Conv(c1, 2 * c_, 1),
                                 RepVGGDW(2 * c_) if lk else Conv(2 * c_, 2 * c_, 3, g=2 * c_),
                                 Conv(2 * c_, c2, 1), Conv(c2, c2, 3, g=c2))
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f whose inner blocks are CIB(c, c, shortcut, e=1.0, lk) (JAX block.py:429)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False, g: int = 1,
                 e: float = 0.5):
        nn.Module.__init__(self)
        self._csp(c1, c2, n, e, lambda c: CIB(c, c, shortcut, e=1.0, lk=lk))


class C2PSA(nn.Module):
    """Stacked PSABlocks on one half of a split, then a 1x1 merge."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"C2PSA needs c1 == c2, got {c1} and {c2}")
        self.c = c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.cv2 = Conv(2 * c, c1, 1)
        self.m = nn.Sequential(*(PSABlock(c, attn_ratio=0.5, num_heads=max(c // 64, 1)) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).chunk(2, 1)
        return self.cv2(torch.cat((a, self.m(b)), 1))


class Proto(nn.Module):
    """The segment head's mask prototypes (JAX block.py:522): cv1 3x3 ->
    `upsample`, a 2x2 stride-2 transposed conv with bias (JAX's
    conv_transpose2d) -> cv2 3x3 -> cv3 1x1 to c2 channels; (B, c1, H, W) ->
    (B, c2, 2H, 2W)."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def _bn(bn: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """A bare BN as the JAX package's batch_norm: in training in f32 on the
    conv output upcast, rounded back to its dtype; in eval in its dtype."""
    return bn(y) if not bn.training else bn(y.float()).to(y.dtype)


class _ResNetBasicBlock(nn.Module):
    """ResNet's BasicBlock (JAX block.py:812): relu(bn2(conv2(relu(bn1(conv1(x)))))
    + identity), the identity a 1x1 conv and BN (`downsample`) where the
    stride or the width changes. Its ReLU after the add is not the fused
    kernel's silu(...) + x form, so it runs cuDNN's convolutions."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = (nn.Sequential(Conv2d(cin, cout, 1, stride, 0, bias=False), BatchNorm2d(cout))
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_bn(self.bn1, self.conv1(x)))
        y = _bn(self.bn2, self.conv2(y))
        idn = x if self.downsample is None else _bn(self.downsample[1], self.downsample[0](x))
        return F.relu(y + idn)


class TorchVision(nn.Module):
    """JAX's stand-in for the torchvision backbone (block.py:836): a ResNet-18
    or -34 built from scratch with random weights (nothing is downloaded):
    conv 7x7/2 (64), BN, ReLU, a 3x3/2 max-pool over a -inf pad of 1, four
    stages of basic blocks (64, 128, 256, 512 wide; the first block of
    stages 2-4 strides 2). With unwrap and truncate >= 2 (the YAML's) it
    returns the last stage's map (B, 512, H / 32, W / 32); otherwise its
    mean over H and W (B, 512). `weights` and `split` are read and ignored,
    as in JAX; resnet50 and resnet101 raise NotImplementedError, as JAX's.
    `c1` is the input's width (the parser passes it)."""

    def __init__(self, model: str = "resnet18", weights: str = "DEFAULT", unwrap: bool = True, truncate: int = 2,
                 split: bool = False, c1: int = 3):
        super().__init__()
        blocks = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}.get(str(model))
        if blocks is None:
            raise NotImplementedError(f"TorchVision native stand-in supports resnet18/34, got {model}")
        self.pool = bool(not unwrap or truncate < 2)
        self.conv1 = Conv2d(c1, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for si, (n, cout) in enumerate(zip(blocks, (64, 128, 256, 512))):
            stage = []
            for bi in range(n):
                stage.append(_ResNetBasicBlock(cin, cout, stride=2 if (bi == 0 and si > 0) else 1))
                cin = cout
            setattr(self, f"layer{si + 1}", nn.ModuleList(stage))
        self.n_stages = len(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_bn(self.bn1, self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, 1)
        for si in range(self.n_stages):
            for block in getattr(self, f"layer{si + 1}"):
                y = block(y)
        return y.mean((2, 3)) if self.pool else y


class ResNetBlock(nn.Module):
    """ResNet's bottleneck block of expansion e (JAX block.py:916):
    relu(cv3(cv2(cv1(x))) + shortcut), cv1 1x1 to c2, cv2 3x3 at stride s,
    cv3 1x1 to e * c2 without activation; the shortcut a 1x1 Conv at stride
    s without activation where the stride or the width changes, else x."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: int = 4):
        super().__init__()
        c3 = e * c2
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, 3, s, p=1)
        self.cv3 = Conv(c2, c3, 1, act=False)
        self.shortcut = nn.Sequential(Conv(c1, c3, 1, s, act=False)) if s != 1 or c1 != c3 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.cv3(self.cv2(self.cv1(x))) + self.shortcut(x))


class ResNetLayer(nn.Module):
    """A stage of ResNet blocks (JAX block.py:938): with is_first the stem, a
    7x7 stride-2 Conv then a 3x3 stride-2 max pool over a -inf pad of 1;
    otherwise n ResNetBlocks, the first at stride s, the rest at width e * c2
    and stride 1. Its output width is c2 for the stem, e * c2 otherwise (the
    parser's rule, JAX nn/tasks.py:341-344)."""

    def __init__(self, c1: int, c2: int, s: int = 1, is_first: bool = False, n: int = 1, e: int = 4):
        super().__init__()
        self.is_first = is_first
        if is_first:
            self.layer = nn.Sequential(Conv(c1, c2, 7, 2, p=3))
        else:
            self.layer = nn.Sequential(ResNetBlock(c1, c2, s, e=e), *(ResNetBlock(e * c2, c2, 1, e=e)
                                                                      for _ in range(1, n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.layer(x)
        return F.max_pool2d(y, 3, 2, 1) if self.is_first else y


class RepBottleneck(Bottleneck):
    """Bottleneck whose cv1 is a RepConv (JAX block.py:590). Inside RepCSP
    (e=1.0, same width, SiLU) it is the fused kernel's block once the
    RepConv's branches are folded: `fold()` folds them, then cv2's BN, and
    packs both for the kernel."""

    def _first(self, c1: int, c2: int, k) -> nn.Module:
        return RepConv(c1, c2, k[0] if isinstance(k, (tuple, list)) else k, 1)


class RepCSP(C3):
    """C3 whose `n` inner blocks are RepBottleneck(c_, c_, e=1.0) (JAX block.py:611)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 0, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(RepBottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))


class RepNCSPELAN4(nn.Module):
    """v9's CSP-ELAN (JAX block.py:632): cv1 to c3 split in two, the second
    half through cv2 (RepCSP to c4, then a 3x3 Conv), that through cv3 (the
    same at c4), cv4 merging the four pieces."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1):
        super().__init__()
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = nn.Sequential(RepCSP(c3 // 2, c4, n), Conv(c4, c4, 3, 1))
        self.cv3 = nn.Sequential(RepCSP(c4, c4, n), Conv(c4, c4, 3, 1))
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).chunk(2, 1))
        ys.append(self.cv2(ys[-1]))
        ys.append(self.cv3(ys[-1]))
        return self.cv4(torch.cat(ys, 1))


class ELAN1(RepNCSPELAN4):
    """v9's ELAN with plain convs (JAX block.py:657): RepNCSPELAN4's layout
    with a 3x3 Conv in place of each RepCSP + Conv pair."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int):
        nn.Module.__init__(self)
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = Conv(c3 // 2, c4, 3, 1)
        self.cv3 = Conv(c4, c4, 3, 1)
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)


class AConv(nn.Module):
    """v9's downsample (JAX block.py:677): a 2x2 stride-1 average pool, then
    a 3x3 stride-2 Conv."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3, 2, p=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv1(F.avg_pool2d(x, 2, 1, 0))


class ADown(nn.Module):
    """v9's two-branch downsample (JAX block.py:692): a 2x2 stride-1 average
    pool split in two; the first half through a 3x3 stride-2 Conv, the
    second through a 3x3 stride-2 max pool (pad 1) and a 1x1 Conv; each to
    c2 / 2, concatenated."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        c = c2 // 2
        self.cv1 = Conv(c1 // 2, c, 3, 2, p=1)
        self.cv2 = Conv(c1 // 2, c, 1, 1, p=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = F.avg_pool2d(x, 2, 1, 0).chunk(2, 1)
        return torch.cat((self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))), 1)


class SPPELAN(nn.Module):
    """v9's SPP-ELAN (JAX block.py:712): cv1 to c3, three stacked k x k
    stride-1 max pools, cv5 merging the four."""

    def __init__(self, c1: int, c2: int, c3: int, k: int = 5):
        super().__init__()
        self.k = k
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv5 = Conv(4 * c3, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv5(torch.cat(ys, 1))


class CBLinear(nn.Module):
    """v9's multi-branch projection (JAX block.py:729): one conv with bias to
    sum(c2s) channels, returned split into pieces of widths c2s (a tuple:
    the layer's output is a list, which CBFuse reads)."""

    def __init__(self, c1: int, c2s, k: int = 1, s: int = 1, g: int = 1):
        super().__init__()
        self.c2s = [int(c) for c in c2s]
        self.conv = Conv2d(c1, sum(self.c2s), k, s, autopad(k), groups=g, bias=True)

    def forward(self, x: torch.Tensor):
        return tuple(self.conv(x).split(self.c2s, 1))


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """x (B, C, H, W) resized to (h, w) by jax.image.resize's nearest rule:
    output row i reads input row floor((i + 0.5) * H / h), in float32, and
    columns likewise. F.interpolate's "nearest" reads floor(i * H / h)
    instead, which differs wherever the ratio is not an integer upscale."""
    def index(n_in: int, n_out: int) -> torch.Tensor:
        pos = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * n_in / n_out
        return pos.floor().long().clamp_(max=n_in - 1)

    return x.index_select(2, index(x.shape[2], h)).index_select(3, index(x.shape[3], w))


class CBFuse(nn.Module):
    """v9's cross-branch fusion (JAX block.py:746): from each input but the
    last (a CBLinear's list), its piece idx[i], resized to the last input's
    size where it differs (resize_nearest); their sum plus the last input."""

    def __init__(self, idx=()):
        super().__init__()
        self.idx = [int(i) for i in idx]

    def forward(self, xs):
        h, w = xs[-1].shape[-2:]
        out = None
        for i, x in enumerate(xs[:-1]):
            t = x[self.idx[i]]
            if tuple(t.shape[-2:]) != (h, w):
                t = resize_nearest(t, h, w)
            out = t if out is None else out + t
        return xs[-1] if out is None else out + xs[-1]
