"""Fused 3x3 -> 3x3 residual bottleneck: the CUDA kernel
(csrc/fused_bottleneck.cu) in f32 and in bf16, its wrappers, its weight packs
and its plain PyTorch versions.

Replaces spectrogram_yolov11_tpu/ops/pallas_fused_conv.py:67 fused_bottleneck
(kernel body `_bottleneck_kernel` :55, helper `_conv_acc` :44); the JAX
reference it is held against is `xla_bottleneck` (:96). It runs the same-width
bottlenecks inside C3k of the BN-folded inference forward
(nn/modules/block.py:Bottleneck).

    out = silu(conv3x3(silu(conv3x3(x) + b1)) + b2) + x

What bounds it on the H100: 2 * 2 * 9 * H * W * C^2 FLOPs per image against
8 * H * W * C bytes of activations in and out in f32 (half that in bf16), so
operations. The kernel runs them on the tensor cores (wgmma). In f32 it runs
3xTF32: each operand split into a TF32 hi and lo, three products summed in
f32, which keeps f32 accuracy. In bf16 it does what the Pallas kernel does in
bf16: bf16 products summed in f32, the intermediate rounded to bf16 after its
bias and SiLU, the residual added to the bf16-rounded conv2 output and the sum
rounded to bf16. The weights stream to shared memory by TMA; the intermediate
activation stays in shared memory; see the source for the tiling. C is 32, 64
or 128 (scales n to l); the scale-x widths 48, 96 and 192 raise. The public
functions keep the JAX layout: x (B, H, W, C) NHWC, w (3, 3, C, C) HWIO with
BN folded, b (C,) f32. The kernel takes its weights as the pack of
`pack_bottleneck_weights` (f32) or `pack_bottleneck_weights_bf16`, made once
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


def pack_bottleneck_weights_bf16(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, C_in, C_out) -> the bf16 kernel's pack (9, C_out, C_in)
    bf16, K-major per tap: one product per weight, so no hi/lo split."""
    return w.permute(0, 1, 3, 2).reshape(9, w.shape[3], w.shape[2]).to(torch.bfloat16).contiguous()


def unpack_bottleneck_weights_bf16(p: torch.Tensor) -> torch.Tensor:
    """The bf16 pack back to HWIO (3, 3, C_in, C_out) bf16."""
    _, c_out, c_in = p.shape
    return p.reshape(3, 3, c_out, c_in).permute(0, 1, 3, 2).contiguous()


@full_f32()
def bottleneck_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version: two conv2d(padding=1) + bias + SiLU, then the residual,
    in full f32."""
    xc = x.permute(0, 3, 1, 2)
    y = F.silu(F.conv2d(xc, w1.permute(3, 2, 0, 1), b1, padding=1))
    y = F.silu(F.conv2d(y, w2.permute(3, 2, 0, 1), b2, padding=1)) + xc
    return y.permute(0, 2, 3, 1).contiguous()


@full_f32()
def bottleneck_reference_bf16(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version of the bf16 form, the Pallas kernel's arithmetic in bf16:
    each conv in full f32 on the bf16 values of its input and weights (every
    product is exact in f32), + b in f32, SiLU in f32, rounded to bf16
    (Pallas :60); then the residual added in f32 and the sum rounded to bf16
    (:64). x (B, H, W, C) and w HWIO are rounded to bf16 first; b is f32."""
    bf = torch.bfloat16
    xc = x.to(bf).permute(0, 3, 1, 2).float()

    def conv_silu(a, w, b):
        return F.silu(F.conv2d(a, w.to(bf).float().permute(3, 2, 0, 1), b.float(), padding=1)).to(bf).float()

    y = conv_silu(conv_silu(xc, w1, b1), w2, b2)
    return (y + xc).to(bf).permute(0, 2, 3, 1).contiguous()


def _run_kernel(entry: str, x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                pack_shape: tuple) -> torch.Tensor:
    """Check what the C entry point `entry` takes (x contiguous 16-byte aligned
    NHWC with C in CHANNELS, packs of `pack_shape` in x's dtype, f32 biases,
    all on x's card), raise on anything else, then launch it."""
    if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{entry}: x must be contiguous 16-byte aligned {x.dtype} NHWC, got {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if c not in CHANNELS:
        raise ValueError(f"{entry}: C={c} not in {CHANNELS}")
    shape = tuple(c if d == "C" else d for d in pack_shape)
    for name, t, want, dtype in (("w1", w1, shape, x.dtype), ("b1", b1, (c,), torch.float32),
                                 ("w2", w2, shape, x.dtype), ("b2", b2, (c,), torch.float32)):
        if tuple(t.shape) != want or t.dtype != dtype or not t.is_contiguous() or t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"{entry}: {name} must be contiguous 16-byte aligned {dtype} {want} on {x.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = kernels.load("fused_bottleneck")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                                  out.data_ptr(), bsz, h, w, c, stream)
    kernels.check(err, entry)
    return out


def _is_hwio(w: torch.Tensor) -> bool:
    return w.dim() == 4 and w.shape[:2] == (3, 3)


def _check_device(x: torch.Tensor, name: str) -> None:
    """Raise unless x is on the CPU (the plain version) or a CUDA card (the kernel)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def fused_bottleneck(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused bottleneck in x's dtype: bf16 goes to `fused_bottleneck_bf16`;
    f32 runs the operator `syt::fused_bottleneck_f32`, with w1, w2 HWIO (3, 3,
    C, C) or their packs (2, 9, C, C). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (C in CHANNELS, contiguous 16-byte aligned
    NHWC), packing HWIO weights first, or raises. Any other dtype raises."""
    if x.dtype == torch.bfloat16:
        return fused_bottleneck_bf16(x, w1, b1, w2, b2)
    if x.dtype != torch.float32:
        raise ValueError(f"fused_bottleneck: x must be float32 or bfloat16, got {x.dtype}")
    _check_device(x, "fused_bottleneck")
    return torch.ops.syt.fused_bottleneck_f32(x, w1, b1, w2, b2)


def fused_bottleneck_bf16(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The bf16 form, the operator `syt::fused_bottleneck_bf16`: x bf16 NHWC;
    w1, w2 HWIO (3, 3, C, C), rounded to bf16, or their bf16 packs (9, C, C);
    b1, b2 f32. A CPU tensor takes `bottleneck_reference_bf16`; a CUDA tensor
    launches the bf16 kernel (C in CHANNELS, contiguous 16-byte aligned NHWC),
    packing HWIO weights first, or raises."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_bottleneck_bf16: x must be bfloat16, got {x.dtype}")
    _check_device(x, "fused_bottleneck_bf16")
    return torch.ops.syt.fused_bottleneck_bf16(x, w1, b1, w2, b2)


def _bottleneck_f32_cpu(x, w1, b1, w2, b2):
    w1, w2 = (w if _is_hwio(w) else unpack_bottleneck_weights(w) for w in (w1, w2))
    return bottleneck_reference(x, w1, b1, w2, b2)


def _bottleneck_f32_cuda(x, w1, b1, w2, b2):
    w1, w2 = (pack_bottleneck_weights(w) if _is_hwio(w) else w for w in (w1, w2))
    out = _run_kernel("fused_bottleneck_f32", x, w1, b1, w2, b2, (2, 9, "C", "C"))
    kernels.count(fused_bottleneck)
    return out


def _bottleneck_bf16_cpu(x, w1, b1, w2, b2):
    w1, w2 = (w if _is_hwio(w) else unpack_bottleneck_weights_bf16(w) for w in (w1, w2))
    return bottleneck_reference_bf16(x, w1, b1, w2, b2)


def _bottleneck_bf16_cuda(x, w1, b1, w2, b2):
    w1, w2 = (pack_bottleneck_weights_bf16(w) if _is_hwio(w) else w for w in (w1, w2))
    out = _run_kernel("fused_bottleneck_bf16", x, w1, b1, w2, b2, (9, "C", "C"))
    kernels.count(fused_bottleneck_bf16)
    return out


def _bottleneck_fake(x, w1, b1, w2, b2):
    return x.new_empty(x.shape)


# The operators the wrappers above call, so that an eager forward and a
# torch.export program of it (engine/exporter.py) run the same code: the plain
# version for a CPU tensor, the kernel for a CUDA one, and for the fake
# tensors of a trace an output of x's shape and dtype. They are registered
# with the dispatcher directly (torch.library.Library), which calls each
# implementation with no Python layer between: torch.library.custom_op's
# took 20-60 us more of host time per call on an H100's host, enough to
# leave the card idle between bf16 launches (tools/op_dispatch_cost.py).
_LIB = torch.library.Library("syt", "FRAGMENT")
for _name, _cpu, _cuda in (("fused_bottleneck_f32", _bottleneck_f32_cpu, _bottleneck_f32_cuda),
                           ("fused_bottleneck_bf16", _bottleneck_bf16_cpu, _bottleneck_bf16_cuda)):
    _LIB.define(f"{_name}(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor")
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"syt::{_name}", _bottleneck_fake, lib=_LIB)

fused_bottleneck.launches = 0
fused_bottleneck_bf16.launches = 0
