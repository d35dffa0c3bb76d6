"""Building blocks (NCHW) of the port: Bottleneck, C3k, C3k2, SPPF, the YOLO11
attention stack and the DFL decode.

Counterparts of spectrogram_yolov11_tpu/nn/modules/block.py: dfl_decode (:35),
Bottleneck (:69), C3k (:173), C3k2 (:204), SPPF (:246), Attention / PSABlock /
C2PSA (:264-357).

C3k's inner bottlenecks are same-width 3x3 -> 3x3 residual blocks. In the
inference forward they run as one fused CUDA kernel
(ops/fused_conv.py:fused_bottleneck) on weights with BN folded in and packed
for the kernel once, by `fold()` after the weights are loaded or the model is
put in eval mode, in the dtype the network runs in (f32 or bf16). In training
BN uses batch statistics, so nothing can be folded: they run their two Convs
(cuDNN), as the JAX trainer does. C3k2's own Bottleneck keeps e=0.5, so its
two convs differ in width and it stays on the plain path.

In bf16 the rounding points are the JAX package's: the DFL decode's exp runs
in the logits' dtype with an f32 projection, and attention takes QK^T and AV
with f32 results, cast to v's dtype after the softmax and after AV. This holds
in amp training too: every block computes in its input's dtype (bf16), its
Convs casting their f32 weights (conv.py), its residual adds, concats and max
pools in bf16, as the JAX blocks at dtype=bfloat16 with train=True.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.fused_conv import fused_bottleneck, pack_bottleneck_weights, pack_bottleneck_weights_bf16
from .conv import Conv


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
    s = z.float() @ _dfl_proj(reg_max, z.device)
    return s[..., :4] / s[..., 4:]


class Bottleneck(nn.Module):
    """cv1 -> cv2 (+ residual). Same-width 3x3 residual instances are `fusable`:
    in eval they run the fused kernel on BN-folded weights set by `fold()`, in
    training their two Convs."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k: Tuple[int, int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2
        self.fusable = self.add and c_ == c2 and tuple(k) == (3, 3) and g == 1
        for name in ("w1", "b1", "w2", "b2"):
            self.register_buffer(name, None, persistent=False)

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


class C3k(nn.Module):
    """CSP block with `n` inner k x k bottlenecks (e=1.0, same width)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5, k: int = 3):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, k=(k, k), e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class C3k2(nn.Module):
    """YOLO11 block: C2f whose inner block is C3k (c3k=True) or a Bottleneck with e=0.5."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5, g: int = 1, shortcut: bool = True):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c, 1, 1)
        self.cv2 = Conv((2 + n) * c, c2, 1)
        self.m = nn.ModuleList(
            C3k(c, c, 2, shortcut, g) if c3k else Bottleneck(c, c, shortcut, g, k=(3, 3), e=0.5) for _ in range(n)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


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
