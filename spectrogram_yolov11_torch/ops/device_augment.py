"""Train-time image augmentation on the card: the image half of the train pipeline.

Counterpart of spectrogram_yolov11_tpu/ops/device_augment.py:284
augment_batch, in its exact general formulation (_augment_one :131 with
_canvas_sample :64 and _hsv_jitter_u8 :87). The host builds each sample's
labels and these parameters (data/augment.py: TrainTransform); the trainer
assembles the batch's images here, inside the train step:

    out[y, x] = bilerp(canvas, A @ (x, y, 1))       A = inv(M) @ F_flip
    canvas(xi, yi) = src[t][yi - padh_t, xi - padw_t]  for the first tile t
                                                      whose rect holds (xi, yi)
                   = 114                              where no tile does

then rounded to uint8 values, jittered in HSV with cv2's uint8 arithmetic
(BGR -> HSV, the gains' LUTs, HSV -> BGR) and turned to RGB. Since both the
mosaic canvas and the warp's border are 114, "uncovered" and "outside" sample
alike and the 2S x 2S canvas is never built. One formulation, per-pixel
gathers, serves every warp: the separable one of the default hyps (degrees =
shear = perspective = 0, where w = 1 and the cross terms are 0) and the
general affine or perspective one. The JAX package's bf16 matmul form of the
separable warp exists for the TPU's matrix unit and misses the exact bilinear
by one grey level at 0.15-0.45 % of pixels; it is not ported.

Rounding: every step is its own elementwise op in f32, in JAX's order, each
multiply and add rounded on its own (no fused multiply-add) and u / w an IEEE
division, so the CPU and the card give the same values, and those of JAX's
_augment_one run op by op (tests/test_torch_device_augment.py). PyTorch on
CUDA divides by a host scalar as a product with its reciprocal, so the
divisors that are not powers of two are tensors on the device. The rounding
before HSV matters: the hue quantisation turns a one-level difference into a
hue step. torch.round, as jnp.round, rounds halves to even; the remainders are
of non-negative values, where fmod is exact.

Plain PyTorch on purpose: it is not one of the JAX package's Pallas kernels.
"""

from __future__ import annotations

import torch

FILL = 114.0


def _canvas_sample(flat_src: torch.Tensor, regions: torch.Tensor, pads: torch.Tensor, s: int, xi: torch.Tensor,
                   yi: torch.Tensor) -> torch.Tensor:
    """Canvas values at integer coords xi, yi (B, H, W) int64 -> (B, H, W, 3)
    f32: the first tile whose rect [x1a, x2a) x [y1a, y2a) holds the point,
    read at the point less the tile's (padw, padh), clipped into the source;
    114 where no tile holds it. flat_src is the (B * 4 * s * s, 3) tiles."""
    b = xi.shape[0]
    r = regions.view(b, 4, 4, 1, 1)
    inside = (xi[:, None] >= r[:, :, 0]) & (xi[:, None] < r[:, :, 2]) & (yi[:, None] >= r[:, :, 1]) & (
        yi[:, None] < r[:, :, 3])  # (B, 4, H, W)
    tid = torch.full_like(xi, 3)
    for t in (2, 1, 0):  # the first covering tile wins
        tid = torch.where(inside[:, t], t, tid)
    flat_tid = tid.view(b, -1)
    padw = torch.gather(pads[..., 0], 1, flat_tid).view_as(tid)
    padh = torch.gather(pads[..., 1], 1, flat_tid).view_as(tid)
    sx = (xi - padw).clamp(0, s - 1)
    sy = (yi - padh).clamp(0, s - 1)
    base = torch.arange(b, device=xi.device).view(b, 1, 1) * 4
    idx = ((base + tid) * s + sy) * s + sx
    val = flat_src[idx.view(-1)].view(*xi.shape, 3).float()
    return torch.where(inside.any(1)[..., None], val, FILL)


def _select(conds, choices, default: torch.Tensor) -> torch.Tensor:
    """jnp.select: the choice of the first true condition, else default."""
    out = default
    for c, v in zip(reversed(conds), reversed(choices)):
        out = torch.where(c, v, out)
    return out


def hsv_jitter_u8(img_bgr: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """cv2's uint8 HSV gain jitter on (B, H, W, 3) BGR images of integer values
    in [0, 255], gains r (B, 3) (JAX _hsv_jitter_u8 :87, op for op): H =
    round(deg / 2) in [0, 180), S = round(255 (V - min) / V), V = max, ties V == R
    first, then V == G; the LUTs truncate after the gain, hue wrapping mod 180;
    then HSV -> BGR by sector of 30 hue units."""
    b, g, rr = img_bgr[..., 0], img_bgr[..., 1], img_bgr[..., 2]
    r0, r1, r2 = (r[:, i].view(-1, 1, 1) for i in range(3))
    v = torch.maximum(torch.maximum(b, g), rr)
    mn = torch.minimum(torch.minimum(b, g), rr)
    diff = v - mn
    safe_v = v.clamp_min(1.0)
    safe_d = diff.clamp_min(1.0)
    s_ = torch.where(v > 0, torch.round(255.0 * diff / safe_v), 0.0)
    h_deg = torch.where(v == rr, 60.0 * (g - b) / safe_d,
                        torch.where(v == g, 120.0 + 60.0 * (b - rr) / safe_d, 240.0 + 60.0 * (rr - g) / safe_d))
    h_deg = torch.where(h_deg < 0, h_deg + 360.0, h_deg)
    h_ = torch.where(diff == 0, 0.0, torch.round(h_deg / 2.0))
    h2 = torch.floor(torch.fmod(h_ * r0, 180.0))
    s2 = torch.floor((s_ * r1).clamp(0.0, 255.0))
    v2 = torch.floor((v * r2).clamp(0.0, 255.0))
    h30 = h2 / h2.new_full((), 30.0)  # a divisor on the device: CUDA multiplies by the reciprocal of a host scalar
    sector = torch.floor(h30)
    f = h30 - sector
    sec = torch.fmod(sector, 6.0).to(torch.int32)
    sf = s2 / s2.new_full((), 255.0)
    p = v2 * (1.0 - sf)
    q = v2 * (1.0 - sf * f)
    t = v2 * (1.0 - sf * (1.0 - f))
    conds = [sec == 0, sec == 1, sec == 2, sec == 3, sec == 4]
    r_out = _select(conds, [v2, q, p, p, t], v2)
    g_out = _select(conds, [t, v2, v2, q, p], p)
    b_out = _select(conds, [p, p, t, v2, v2], q)
    return torch.round(torch.stack([b_out, g_out, r_out], dim=-1).clamp(0.0, 255.0))


def augment_batch(src: torch.Tensor, regions: torch.Tensor, pads: torch.Tensor, inv: torch.Tensor,
                  hsv_r: torch.Tensor) -> torch.Tensor:
    """The batch's images from their tiles and parameters, on src's device.

    src (B, 4, s, s, 3) uint8 BGR tiles (unused tiles arbitrary); regions
    (B, 4, 4) int canvas rects [x1a, y1a, x2a, y2a); pads (B, 4, 2) int
    (padw, padh) canvas-to-source offsets; inv (B, 3, 3) float32
    output-index-to-canvas matrices; hsv_r (B, 3) float32 gains. Returns
    (B, s, s, 3) float32 RGB of integer values in [0, 255]."""
    bsz, _, s = src.shape[:3]
    dev = src.device
    regions, pads, inv, hsv_r = regions.long(), pads.long(), inv.float(), hsv_r.float()
    grid = torch.arange(s, dtype=torch.float32, device=dev)
    X, Y = grid.view(1, 1, s), grid.view(1, s, 1)

    def row(i: int) -> torch.Tensor:  # inv[:, i, 0] * X + inv[:, i, 1] * Y + inv[:, i, 2], each op rounded
        a, b, c = (inv[:, i, j].view(bsz, 1, 1) for j in range(3))
        return a * X + b * Y + c

    u, v, w = row(0), row(1), row(2)
    u, v = u / w, v / w
    x0f, y0f = torch.floor(u), torch.floor(v)
    fx, fy = (u - x0f)[..., None], (v - y0f)[..., None]
    x0 = x0f.clamp(-2, 2 * s + 2).long()  # far outside is 114 whatever the tap
    y0 = y0f.clamp(-2, 2 * s + 2).long()
    flat = src.reshape(-1, 3)
    c00 = _canvas_sample(flat, regions, pads, s, x0, y0)
    c10 = _canvas_sample(flat, regions, pads, s, x0 + 1, y0)
    c01 = _canvas_sample(flat, regions, pads, s, x0, y0 + 1)
    c11 = _canvas_sample(flat, regions, pads, s, x0 + 1, y0 + 1)
    bil = (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy
    warped = torch.round(bil.clamp(0.0, 255.0))  # the warp's output is uint8
    return hsv_jitter_u8(warped, hsv_r).flip(-1)  # BGR -> RGB
