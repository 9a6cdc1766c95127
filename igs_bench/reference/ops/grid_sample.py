"""Bilinear point sampling with ``F.grid_sample(align_corners=False,
padding_mode='zeros')`` semantics (counterpart of
``igs_tpu/ops/grid_sample.py``), batched over feature maps."""

from __future__ import annotations

import torch


def grid_sample_points(features: torch.Tensor,
                       coords: torch.Tensor) -> torch.Tensor:
    """features (M, C, H, W), coords (M, N, 2) normalized [-1, 1] (x, y)
    → (M, N, C); zeros outside the map."""
    m, c, h, w = features.shape
    x = ((coords[..., 0] + 1.0) * w - 1.0) * 0.5
    y = ((coords[..., 1] + 1.0) * h - 1.0) * 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    flat = features.reshape(m, c, h * w)
    n = coords.shape[1]

    def tap(xi, yi, weight):
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xi_c = torch.clamp(xi, 0, w - 1).to(torch.int64)
        yi_c = torch.clamp(yi, 0, h - 1).to(torch.int64)
        lin = (yi_c * w + xi_c)[:, None, :].expand(m, c, n)
        vals = torch.gather(flat, 2, lin)  # (M, C, N)
        return vals * (weight * inside)[:, None, :]

    out = (tap(x0, y0, (1 - wx) * (1 - wy))
           + tap(x0 + 1, y0, wx * (1 - wy))
           + tap(x0, y0 + 1, (1 - wx) * wy)
           + tap(x0 + 1, y0 + 1, wx * wy))
    return out.transpose(1, 2)


def perspective_project_features(points: torch.Tensor, c2w: torch.Tensor,
                                 intrinsics: torch.Tensor,
                                 features: torch.Tensor) -> torch.Tensor:
    """Project points into views and sample their feature maps.

    points (B, N, 3), c2w (B, V, 4, 4), intrinsics (B, 3, 3), features
    (B, V, C, h, w) → (B, V, N, C). Image coords are normalized by
    2·u/W − 1 (align_corners=False), with no eps on the depth divide, as
    the reference's ``perspective_projection``.
    """
    b, v, c, h, w = features.shape
    w2c = torch.linalg.inv(c2w)  # (B, V, 4, 4)
    pc = (torch.einsum("bvij,bnj->bvni", w2c[..., :3, :3], points)
          + w2c[..., None, :3, 3])
    pi = torch.einsum("bij,bvnj->bvni", intrinsics, pc)
    uv = pi[..., :2] / pi[..., 2:3]
    grid = torch.stack([2.0 * uv[..., 0] / w - 1.0,
                        2.0 * uv[..., 1] / h - 1.0], -1)
    out = grid_sample_points(features.reshape(b * v, c, h, w),
                             grid.reshape(b * v, -1, 2))
    return out.reshape(b, v, -1, c)
