"""Fused 3x3 -> 3x3 residual bottleneck: the CUDA kernel
(csrc/fused_bottleneck.cu), its wrapper, its weight pack and its plain
PyTorch version.

Replaces spectrogram_yolov11_tpu/ops/pallas_fused_conv.py:67 fused_bottleneck
(kernel body `_bottleneck_kernel` :55, helper `_conv_acc` :44); the JAX
reference it is held against is `xla_bottleneck` (:96). It runs the same-width
bottlenecks inside C3k of the BN-folded inference forward
(nn/modules/block.py:Bottleneck).

    out = silu(conv3x3(silu(conv3x3(x) + b1)) + b2) + x

What bounds it on the H100: 2 * 2 * 9 * H * W * C^2 FLOPs per image against
8 * H * W * C bytes of activations in and out, so operations. The kernel runs
them on the tensor cores (wgmma) in 3xTF32: each operand split into a TF32 hi
and lo, three products summed in f32, which keeps f32 accuracy. The weights
stream to shared memory by TMA; the intermediate activation stays in shared
memory; see the source for the tiling. C is 32, 64 or 128 (scales n to l);
the scale-x widths 48, 96 and 192 raise. The public functions keep the JAX
layout: x (B, H, W, C) NHWC, w (3, 3, C, C) HWIO with BN folded, b (C,). The
kernel takes its weights as the pack of `pack_bottleneck_weights`, made once
by `Bottleneck.fold()`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import full_f32, kernels

CHANNELS = (32, 64, 128)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero: what `cvt.rna.tf32.f32` gives, the low 13 bits cleared."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def pack_bottleneck_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, C_in, C_out) f32 -> the kernel's pack (2, 9, C_out, C_in):
    [0] hi = tf32_round(w), [1] lo = w - hi (exact in f32), K-major per tap
    (C_in contiguous), as the tensor cores' B operand is read."""
    k = w.permute(0, 1, 3, 2).reshape(9, w.shape[3], w.shape[2]).float()
    hi = tf32_round(k)
    return torch.stack((hi, k - hi)).contiguous()


def unpack_bottleneck_weights(p: torch.Tensor) -> torch.Tensor:
    """The pack back to HWIO (3, 3, C_in, C_out): hi + lo is w exactly."""
    _, _, c_out, c_in = p.shape
    return (p[0] + p[1]).reshape(3, 3, c_out, c_in).permute(0, 1, 3, 2).contiguous()


@full_f32()
def bottleneck_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version: two conv2d(padding=1) + bias + SiLU, then the residual,
    in full f32."""
    xc = x.permute(0, 3, 1, 2)
    y = F.silu(F.conv2d(xc, w1.permute(3, 2, 0, 1), b1, padding=1))
    y = F.silu(F.conv2d(y, w2.permute(3, 2, 0, 1), b2, padding=1)) + xc
    return y.permute(0, 2, 3, 1).contiguous()


def _is_pack(w: torch.Tensor) -> bool:
    return w.dim() == 4 and w.shape[0] == 2 and w.shape[1] == 9


def fused_bottleneck(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused bottleneck. w1, w2 are HWIO (3, 3, C, C) or their packs
    (2, 9, C, C). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (f32, C in CHANNELS, contiguous 16-byte aligned NHWC), packing
    HWIO weights first, or raises."""
    if x.device.type == "cpu":
        w1, w2 = (unpack_bottleneck_weights(w) if _is_pack(w) else w for w in (w1, w2))
        return bottleneck_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"fused_bottleneck: x must be contiguous 16-byte aligned float32 NHWC, "
                         f"got {x.dtype} {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if c not in CHANNELS:
        raise ValueError(f"fused_bottleneck: C={c} not in {CHANNELS}")
    w1, w2 = (w if _is_pack(w) else pack_bottleneck_weights(w) for w in (w1, w2))
    for name, t, shape in (("w1", w1, (2, 9, c, c)), ("b1", b1, (c,)), ("w2", w2, (2, 9, c, c)), ("b2", b2, (c,))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device
                or t.data_ptr() % 16):
            raise ValueError(f"fused_bottleneck: {name} must be contiguous 16-byte aligned float32 {shape} on {x.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = kernels.load("fused_bottleneck")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_bottleneck_f32(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                                       out.data_ptr(), bsz, h, w, c, stream)
    kernels.check(err, "fused_bottleneck_f32")
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
