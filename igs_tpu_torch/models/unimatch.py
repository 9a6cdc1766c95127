"""UniMatch/GMFlow in backbone mode (counterpart of
``igs_tpu/models/unimatch.py``): ImageNet-normalize → shared CNNEncoder
over (cur, next) → sine PE in split windows → FeatureTransformer.
``cnn_dtype`` and ``ft_dtype`` are the compute types of the encoder and
the transformer (the ``cnn_bf16`` and ``ft_bf16`` flags)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from igs_tpu_torch.models.backbone import CNNEncoder
from igs_tpu_torch.models.swin import FeatureTransformer, feature_add_position

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_img(img0, img1):
    """Inputs in [0, 255] (the reference's convention). The constants
    follow the input's type, so bf16 inputs of a mixed-precision step stay
    bf16."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img0.dtype,
                        device=img0.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=img0.dtype,
                       device=img0.device).reshape(1, 3, 1, 1)
    return (img0 / 255.0 - mean) / std, (img1 / 255.0 - mean) / std


class UniMatch(nn.Module):
    def __init__(self, feature_channels: int = 128,
                 num_transformer_layers: int = 6, ffn_dim_expansion: int = 4,
                 attn_splits: int = 2,
                 cnn_dtype: Optional[torch.dtype] = None,
                 ft_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.feature_channels = feature_channels
        self.attn_splits = attn_splits
        self.backbone = CNNEncoder(feature_channels, dtype=cnn_dtype)
        self.transformer = FeatureTransformer(
            num_layers=num_transformer_layers, d_model=feature_channels,
            ffn_dim_expansion=ffn_dim_expansion, dtype=ft_dtype)

    def forward(self, img0, img1, img0_tile: int = 1):
        """(B, 3, H, W) ×2 → two (B, C, H/8, W/8).

        ``img0_tile > 1``: img0 holds B/img0_tile unique images whose CNN
        features are computed once and tiled back to B (a streaming
        window's candidates all share the key frame as ``cur``).
        """
        img0, img1 = normalize_img(img0, img1)
        feats = self.backbone(torch.cat([img0, img1], 0))
        n0 = img0.shape[0]
        feature0, feature1 = feats[:n0], feats[n0:]
        if img0_tile > 1:
            feature0 = feature0.repeat(img0_tile, 1, 1, 1)
        feature0, feature1 = feature_add_position(
            feature0, feature1, self.attn_splits, self.feature_channels)
        return self.transformer(feature0, feature1,
                                attn_num_splits=self.attn_splits)
