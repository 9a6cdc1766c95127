"""The blend's constants, its outputs and the untiling, as the tile
renderer (``render_tiles.py``) reads them."""

from __future__ import annotations

from typing import NamedTuple

import torch

from igs_bench.reference.ops.projection import TILE_X, TILE_Y

LOG_TERM = -9.210340371976182  # log(1e-4)
MIN_ALPHA = 1.0 / 255.0


class RenderOutputs(NamedTuple):
    """Rendered views, each with a leading (V,) axis."""

    color: torch.Tensor  # (V, 3, H, W), bg-composited
    alpha: torch.Tensor  # (V, H, W)   Σ αT
    coord: torch.Tensor  # (V, 3, H, W) expected camera-space coord
    mcoord: torch.Tensor  # (V, 3, H, W) median coord
    depth: torch.Tensor  # (V, H, W)   expected depth
    mdepth: torch.Tensor  # (V, H, W)   median depth
    normal: torch.Tensor  # (V, 3, H, W) blended unit normal
    accum_coord: torch.Tensor  # (V, 3, H, W)
    accum_depth: torch.Tensor  # (V, H, W)
    n_contrib: torch.Tensor  # (V, H, W) int32 last contributor position
    max_contrib: torch.Tensor  # (V, H, W) int32 median contributor position


def untile(raw: torch.Tensor, views: int, grid_x: int, grid_y: int,
           height: int, width: int) -> torch.Tensor:
    """(V·T, 256, c) → (V, c, H, W)."""
    c = raw.shape[-1]
    img = raw.reshape(views, grid_y, grid_x, TILE_Y, TILE_X, c)
    img = img.permute(0, 5, 1, 3, 2, 4).reshape(
        views, c, grid_y * TILE_Y, grid_x * TILE_X)
    return img[:, :, :height, :width]
