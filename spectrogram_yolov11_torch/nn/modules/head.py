"""Detection head (NCHW) of the port.

Counterpart of spectrogram_yolov11_tpu/nn/modules/head.py:29 Detect in its
non-legacy form (the YOLO11 head: a depthwise-separable class branch). As in
the JAX head, each level returns a (box, cls) pair of raw logits; decode and
NMS live in ops/. Each branch's last conv (with bias) computes in its input's
dtype, as the JAX head's conv2d at the model's dtype.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from .conv import Conv, Conv2d, DWConv


class Detect(nn.Module):
    """Anchor-free decoupled head over P3/P4/P5.

    Level i returns (box (B, 4*reg_max, Hi, Wi), cls (B, nc, Hi, Wi))."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), legacy: bool = False, reg_max: int = 16):
        super().__init__()
        if legacy:
            raise NotImplementedError("only the non-legacy (YOLO11) Detect head is ported")
        self.nc, self.reg_max = nc, reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), Conv2d(c2, 4 * reg_max, 1)) for x in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(
                nn.Sequential(DWConv(x, x, 3), Conv(x, c3, 1)),
                nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)),
                Conv2d(c3, nc, 1),
            )
            for x in ch
        )

    @torch.no_grad()
    def bias_init(self, strides: Sequence[float]) -> None:
        """JAX's detect_bias_init (nn/modules/head.py:192): each level's box
        branch ends in bias 1.0, its class branch in log(5 / nc / (640 / s)^2)."""
        for box, cls, s in zip(self.cv2, self.cv3, strides):
            box[-1].bias.fill_(1.0)
            cls[-1].bias.fill_(math.log(5 / self.nc / (640 / float(s)) ** 2))

    def forward(self, xs: List[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [(self.cv2[i](x), self.cv3[i](x)) for i, x in enumerate(xs)]
