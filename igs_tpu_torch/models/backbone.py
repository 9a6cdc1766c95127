"""GMFlow CNN encoder — 1/8-resolution feature extractor, NCHW.

Counterpart of ``igs_tpu/models/backbone.py``: 7×7 s2 conv → 3 residual
stages (strides 1, 2, 2) → 1×1 conv; affine-free InstanceNorm (eps 1e-5),
ReLU. Keys follow GMFlow's ``backbone.*`` names.

``dtype`` (the ``cnn_bf16`` flag): the input is cast once and the convs
compute in it; the InstanceNorm statistics are always float32, its output
returns to the conv's type, and the encoder's output is float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from igs_tpu_torch.models.networks import Conv


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Affine-free InstanceNorm with float32 statistics, in ``x``'s type."""
    return F.instance_norm(x.float(), eps=1e-5).to(x.dtype)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dilation: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride=stride,
                          padding=dilation, dilation=dilation, bias=False,
                          dtype=dtype)
        self.conv2 = Conv(planes, planes, 3, padding=dilation,
                          dilation=dilation, bias=False, dtype=dtype)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                Conv(in_planes, planes, 1, stride=stride, dtype=dtype),
                InstanceNorm())

    def forward(self, x):
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class CNNEncoder(nn.Module):
    def __init__(self, output_dim: int = 128,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = [64, 96, 128]
        self.dtype = dtype
        self.conv1 = Conv(3, dims[0], 7, stride=2, padding=3, bias=False,
                          dtype=dtype)
        self.layer1 = nn.Sequential(
            ResidualBlock(dims[0], dims[0], 1, dtype=dtype),
            ResidualBlock(dims[0], dims[0], 1, dtype=dtype))
        self.layer2 = nn.Sequential(
            ResidualBlock(dims[0], dims[1], 2, dtype=dtype),
            ResidualBlock(dims[1], dims[1], 1, dtype=dtype))
        self.layer3 = nn.Sequential(
            ResidualBlock(dims[1], dims[2], 2, dtype=dtype),
            ResidualBlock(dims[2], dims[2], 1, dtype=dtype))
        self.conv2 = Conv(dims[2], output_dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) → (B, C, H/8, W/8), float32."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.relu(instance_norm(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x).float()
