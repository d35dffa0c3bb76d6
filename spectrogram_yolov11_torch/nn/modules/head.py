"""Detection, segmentation, pose, OBB and classification heads (NCHW) of the port.

Counterparts of spectrogram_yolov11_tpu/nn/modules/head.py:29 Detect (the
YOLO11 head's depthwise-separable class branch, the legacy v8 one, and the
end2end form of v10Detect with its one2one branches), :86
Segment, :114 Pose, :141 OBB and :168 Classify. As in
the JAX head, each level returns a (box, cls) pair of raw logits; decode and
NMS live in ops/. Each branch's last conv (with bias) computes in its input's
dtype, as the JAX head's conv2d at the model's dtype.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from .block import Proto
from .conv import Conv, Conv2d, DWConv, Linear


class Detect(nn.Module):
    """Anchor-free decoupled head over the levels of `ch` (3, or 4 for the p2
    and p6 configs).

    Level i returns (box (B, 4*reg_max, Hi, Wi), cls (B, nc, Hi, Wi)). Its box
    branch cv2[i] is Conv 3x3 to c2, Conv 3x3, conv 1x1 with bias; its class
    branch cv3[i] the YOLO11 form (DWConv 3x3, Conv 1x1, twice, then conv 1x1
    with bias) or, with `legacy` (the v3/v5/v8/v9 heads, JAX head.py:61-64),
    Conv 3x3 to c3, Conv 3x3, conv 1x1 with bias. With `end2end` (v10Detect,
    JAX head.py:78-82) a second pair of branches, one2one_cv2 and
    one2one_cv3, runs on the inputs detached (JAX's stop_gradient), and the
    head returns {"one2many": the pairs of cv2 / cv3, "one2one": those of the
    second pair}."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), legacy: bool = False, reg_max: int = 16,
                 end2end: bool = False):
        super().__init__()
        self.nc, self.reg_max, self.legacy, self.end2end = nc, reg_max, legacy, end2end
        self.c2, self.c3 = max(16, ch[0] // 4, reg_max * 4), max(ch[0], min(nc, 100))
        self.cv2, self.cv3 = self._box_branches(ch), self._cls_branches(ch)
        if end2end:
            self.one2one_cv2, self.one2one_cv3 = self._box_branches(ch), self._cls_branches(ch)

    def _box_branches(self, ch: Sequence[int]) -> nn.ModuleList:
        c2 = self.c2
        return nn.ModuleList(nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), Conv2d(c2, 4 * self.reg_max, 1))
                             for x in ch)

    def _cls_branches(self, ch: Sequence[int]) -> nn.ModuleList:
        c3, nc = self.c3, self.nc
        if self.legacy:
            return nn.ModuleList(nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), Conv2d(c3, nc, 1)) for x in ch)
        return nn.ModuleList(
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
        branch ends in bias 1.0, its class branch in log(5 / nc / (640 / s)^2),
        in both pairs of branches of an end2end head (head.py:199)."""
        pairs = [(self.cv2, self.cv3)] + ([(self.one2one_cv2, self.one2one_cv3)] if self.end2end else [])
        for cv2, cv3 in pairs:
            for box, cls, s in zip(cv2, cv3, strides):
                box[-1].bias.fill_(1.0)
                cls[-1].bias.fill_(math.log(5 / self.nc / (640 / float(s)) ** 2))

    @staticmethod
    def _branches(xs: List[torch.Tensor], cv2: nn.ModuleList, cv3: nn.ModuleList):
        return [(cv2[i](x), cv3[i](x)) for i, x in enumerate(xs)]

    def forward(self, xs: List[torch.Tensor]):
        one2many = self._branches(xs, self.cv2, self.cv3)
        if not self.end2end:
            return one2many
        return {"one2many": one2many,
                "one2one": self._branches([x.detach() for x in xs], self.one2one_cv2, self.one2one_cv3)}


class Segment(nn.Module):
    """Detect, the mask coefficient branches and Proto (JAX head.py:86):
    forward(xs) -> (Detect's per-level pairs, coefficients (B, A, nm) in the
    anchor order (level, h, w), prototypes (B, nm, H0 * 2, W0 * 2) from
    xs[0]). The JAX head gives its prototypes NHWC; the port's stay NCHW.
    Level i's coefficient branch is cv4[i]: Conv 3x3 to c4 = max(ch[0] // 4,
    nm), Conv 3x3, conv 1x1 with bias to nm."""

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256, ch: Sequence[int] = (), legacy: bool = False,
                 reg_max: int = 16):
        super().__init__()
        self.nc, self.nm, self.npr = nc, nm, npr
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), Conv2d(c4, nm, 1)) for x in ch)
        self.detect = Detect(nc, ch, legacy, reg_max)

    def forward(self, xs: List[torch.Tensor]):
        p = self.proto(xs[0])
        mc = torch.cat([self.cv4[i](x).flatten(2) for i, x in enumerate(xs)], 2).transpose(1, 2)
        return self.detect(xs), mc, p


class Pose(nn.Module):
    """Detect and the keypoint branches (JAX head.py:114): forward(xs) ->
    (Detect's per-level pairs, raw keypoints (B, A, nk) in the anchor order
    (level, h, w)), nk = kpt_shape[0] * kpt_shape[1]. Level i's keypoint
    branch is cv4[i]: Conv 3x3 to c4 = max(ch[0] // 4, nk), Conv 3x3, conv
    1x1 with bias to nk (c4 is 51 for 17 x 3 keypoints at scale n)."""

    def __init__(self, nc: int = 80, kpt_shape: Sequence[int] = (17, 3), ch: Sequence[int] = (),
                 legacy: bool = False, reg_max: int = 16):
        super().__init__()
        self.nc, self.kpt_shape = nc, tuple(kpt_shape)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        c4 = max(ch[0] // 4, nk)
        self.cv4 = nn.ModuleList(nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), Conv2d(c4, nk, 1)) for x in ch)
        self.detect = Detect(nc, ch, legacy, reg_max)

    def forward(self, xs: List[torch.Tensor]):
        k = torch.cat([self.cv4[i](x).flatten(2) for i, x in enumerate(xs)], 2).transpose(1, 2)
        return self.detect(xs), k


class OBB(nn.Module):
    """Detect and the angle branches (JAX head.py:141): forward(xs) ->
    (Detect's per-level pairs, raw angles (B, A, ne) in the anchor order
    (level, h, w)); ops/decode.py:decode_obb turns them into radians. Level
    i's angle branch is cv4[i]: Conv 3x3 to c4 = max(ch[0] // 4, ne), Conv
    3x3, conv 1x1 with bias to ne."""

    def __init__(self, nc: int = 80, ne: int = 1, ch: Sequence[int] = (), legacy: bool = False, reg_max: int = 16):
        super().__init__()
        self.nc, self.ne = nc, ne
        c4 = max(ch[0] // 4, ne)
        self.cv4 = nn.ModuleList(nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), Conv2d(c4, ne, 1)) for x in ch)
        self.detect = Detect(nc, ch, legacy, reg_max)

    def forward(self, xs: List[torch.Tensor]):
        a = torch.cat([self.cv4[i](x).flatten(2) for i, x in enumerate(xs)], 2).transpose(1, 2)
        return self.detect(xs), a


class Classify(nn.Module):
    """The classification head (JAX head.py:168): Conv(c1 -> 1280, k, s, p,
    g) -> the mean over H and W -> Linear(1280 -> c2), flax's Dense with its
    default init. forward(x, or a list of maps concatenated on channels) ->
    logits (B, c2): the softmax is the predictor's, the cross-entropy the
    trainer's."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1):
        super().__init__()
        self.conv = Conv(c1, 1280, k, s, p, g)
        self.linear = Linear(1280, c2)

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x = torch.cat(x, 1)
        return self.linear(self.conv(x).mean((2, 3)))
