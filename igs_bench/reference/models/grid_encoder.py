"""GridEncoder — anchor feature lifting (counterpart of
``igs_tpu/models/grid_encoder.py``): project the anchors into every input
view's motion-feature map, average over views, then a Transformer1D over
the anchor tokens (computing in ``dtype``, the ``encoder_bf16`` flag)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from igs_bench.reference.core.camera import fov2focal
from igs_bench.reference.models.transformer1d import Transformer1D
from igs_bench.reference.ops.grid_sample import perspective_project_features


class GridEncoder(nn.Module):
    def __init__(self, in_channels: int = 128, num_attention_heads: int = 8,
                 attention_head_dim: int = 64, num_layers: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Transformer1D(in_channels, num_attention_heads,
                                  attention_head_dim, num_layers, dtype=dtype)

    def forward(self, motion_feature: torch.Tensor,  # (B·V, C, h, w)
                anchor_points: torch.Tensor,  # (B, A, 3)
                fov: torch.Tensor,  # (B, 2)
                c2w_input: torch.Tensor,  # (B, V, 4, 4)
                ) -> torch.Tensor:  # (B, A, C)
        b, v = c2w_input.shape[:2]
        _, c, h, w = motion_feature.shape
        intr = torch.zeros((b, 3, 3), dtype=torch.float32,
                           device=motion_feature.device)
        intr[:, 0, 0] = fov2focal(fov[:, 0], w)
        intr[:, 1, 1] = fov2focal(fov[:, 1], h)
        intr[:, 0, 2] = w / 2.0
        intr[:, 1, 2] = h / 2.0
        intr[:, 2, 2] = 1.0
        feats = motion_feature.reshape(b, v, c, h, w)
        proj = perspective_project_features(anchor_points, c2w_input, intr,
                                            feats).mean(dim=1)  # (B, A, C)
        return self.conv(proj.transpose(1, 2)).transpose(1, 2)
