"""Quaternion math, wxyz (counterpart of ``igs_tpu/core/quaternion.py``)."""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """(..., 4) wxyz quaternion → (..., 3, 3) rotation matrix.

    ``normalize=False`` matches the raster preprocess, which builds R from
    the already-activated quaternion without re-normalizing.
    """
    if normalize:
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2, both (..., 4) wxyz."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        -1,
    )


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize with a clamped norm (F.normalize semantics)."""
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    ok = n2 > 0
    n = torch.sqrt(torch.where(ok, n2, torch.ones_like(n2)))
    return q / torch.where(ok, n, torch.zeros_like(n)).clamp_min(eps)
