"""The spectrogram fork's modules on the port's path (NCHW).

Counterpart of spectrogram_yolov11_tpu/nn/modules/fork.py:220 HCoordAtt only.
"""

from __future__ import annotations

import torch
from torch import nn


class HCoordAtt(nn.Module):
    """Per-column (time-axis) gate for spectrograms: the channel mean and max
    maps -> bare 3x3 conv -> sigmoid -> average over H -> multiply each column.

    `cv1` is a bare conv (no BN, no bias), as in the JAX module."""

    def __init__(self, inp: int, oup: int, reduction: int = 32):
        super().__init__()
        self.cv1 = nn.Conv2d(2, 1, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stat = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        gate = torch.sigmoid(self.cv1(stat)).mean(2, keepdim=True)  # (B, 1, 1, W)
        return x * gate
