"""GMFlow CNN encoder — 1/8-resolution feature extractor, NCHW.

Counterpart of ``igs_tpu/models/backbone.py``: 7×7 s2 conv → 3 residual
stages (strides 1, 2, 2) → 1×1 conv; affine-free InstanceNorm (eps 1e-5),
ReLU. Keys follow GMFlow's ``backbone.*`` names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=dilation,
                               dilation=dilation, bias=False)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride),
                nn.InstanceNorm2d(planes))

    def forward(self, x):
        y = F.relu(F.instance_norm(self.conv1(x), eps=1e-5))
        y = F.relu(F.instance_norm(self.conv2(y), eps=1e-5))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class CNNEncoder(nn.Module):
    def __init__(self, output_dim: int = 128):
        super().__init__()
        dims = [64, 96, 128]
        self.conv1 = nn.Conv2d(3, dims[0], 7, stride=2, padding=3, bias=False)
        self.layer1 = nn.Sequential(ResidualBlock(dims[0], dims[0], 1),
                                    ResidualBlock(dims[0], dims[0], 1))
        self.layer2 = nn.Sequential(ResidualBlock(dims[0], dims[1], 2),
                                    ResidualBlock(dims[1], dims[1], 1))
        self.layer3 = nn.Sequential(ResidualBlock(dims[1], dims[2], 2),
                                    ResidualBlock(dims[2], dims[2], 1))
        self.conv2 = nn.Conv2d(dims[2], output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) → (B, C, H/8, W/8)."""
        x = F.relu(F.instance_norm(self.conv1(x), eps=1e-5))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)
