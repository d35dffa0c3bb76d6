"""The spectrogram fork's modules on the port's path (NCHW).

Counterpart of spectrogram_yolov11_tpu/nn/modules/fork.py:220 HCoordAtt only.
"""

from __future__ import annotations

import torch
from torch import nn

from .conv import Conv2d


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
        stat = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        gate = torch.sigmoid(self.cv1(stat)).mean(2, keepdim=True)  # (B, 1, 1, W)
        return x * gate
