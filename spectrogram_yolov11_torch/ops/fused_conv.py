"""Fused 3x3 -> 3x3 residual bottleneck: the CUDA kernel
(csrc/fused_bottleneck.cu), its wrapper and its plain PyTorch version.

Replaces spectrogram_yolov11_tpu/ops/pallas_fused_conv.py:67 fused_bottleneck
(kernel body `_bottleneck_kernel` :55, helper `_conv_acc` :44); the JAX
reference it is held against is `xla_bottleneck` (:96). It runs the six
same-width bottlenecks inside C3k of the BN-folded inference forward
(nn/modules/block.py:Bottleneck).

    out = silu(conv3x3(silu(conv3x3(x) + b1)) + b2) + x

What bounds it on the H100: 2 * 2 * 9 * H * W * C^2 FLOPs per image (59 MFLOP
at 40x40x32 and at 20x20x64) against 8 * H * W * C bytes of activations in
and out, so it is bound by operations on the f32 CUDA cores. The kernel keeps
the intermediate activation in shared memory (one CTA per 8x8 output tile with
a 2-pixel recomputed halo), so it never reaches device memory; see the source
for the tiling. The public functions keep the JAX layout: x (B, H, W, C) NHWC,
w (3, 3, C, C) HWIO with BN folded, b (C,).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import kernels

CHANNELS = (32, 64)


def bottleneck_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version: two conv2d(padding=1) + bias + SiLU, then the residual."""
    xc = x.permute(0, 3, 1, 2)
    y = F.silu(F.conv2d(xc, w1.permute(3, 2, 0, 1), b1, padding=1))
    y = F.silu(F.conv2d(y, w2.permute(3, 2, 0, 1), b2, padding=1)) + xc
    return y.permute(0, 2, 3, 1).contiguous()


def fused_bottleneck(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused bottleneck. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (f32, C in {32, 64}, contiguous NHWC) or raises."""
    if x.device.type == "cpu":
        return bottleneck_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"fused_bottleneck: x must be contiguous float32 NHWC, got {x.dtype} {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if c not in CHANNELS:
        raise ValueError(f"fused_bottleneck: C={c} not in {CHANNELS}")
    for name, t, shape in (("w1", w1, (3, 3, c, c)), ("b1", b1, (c,)), ("w2", w2, (3, 3, c, c)), ("b2", b2, (c,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"fused_bottleneck: {name} must be contiguous float32 {shape} on {x.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = kernels.load("fused_bottleneck")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_bottleneck_f32(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                                   out.data_ptr(), bsz, h, w, c, stream)
    kernels.check(err, "fused_bottleneck_f32")
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
