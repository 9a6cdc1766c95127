"""Anchor selection for AGM-Net: bbox mask → FPS anchors → KNN weights.

Counterpart of ``igs_tpu/ops/anchors.py``. The dynamic subset stays a
boolean mask over the full (padded) Gaussian rows; KNN indices address the
anchor array, weights are softmax(−10·distance) over the K nearest.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from igs_tpu_torch.core.gaussians import select_points_bbox
from igs_tpu_torch.core.quaternion import quat_normalize
from igs_tpu_torch.ops.knn import farthest_point_sampling, knn


class AnchorState(NamedTuple):
    """Anchor precompute carried through a streaming window."""

    anchor_points: torch.Tensor  # (A, 3)
    anchor_idx: torch.Tensor  # (A,) indices into the Gaussian rows
    mask: torch.Tensor  # (N,) dynamic-region (in-bbox ∧ valid) mask
    weights: torch.Tensor  # (N, K) interpolation weights
    neighbor_idx: torch.Tensor  # (N, K) anchor indices per point


def select_anchors(xyz: torch.Tensor, bbox: torch.Tensor,
                   valid: torch.Tensor | None = None, anchor_size: int = 8192,
                   k: int = 8, temperature: float = 10.0,
                   fps_buckets: int = 64) -> AnchorState:
    """Full anchor precompute for one scene/frame.

    ``fps_buckets=1`` runs exact sequential greedy FPS; the default 64
    Morton buckets match the reference's bucketed kd-line FPS.
    """
    if valid is None:
        valid = torch.ones(xyz.shape[0], dtype=torch.bool, device=xyz.device)
    mask = select_points_bbox(xyz, bbox) & valid
    idx = farthest_point_sampling(xyz, anchor_size, valid=mask,
                                  num_buckets=fps_buckets)
    anchors = xyz[idx]
    dist, nbr = knn(anchors, xyz, k, points_valid=mask[idx])
    return AnchorState(
        anchor_points=anchors,
        anchor_idx=idx,
        mask=mask,
        weights=torch.softmax(-temperature * dist, dim=-1),
        neighbor_idx=nbr,
    )


def _take_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (..., A, D) rows at idx (..., N) → (..., N, D)."""
    if feats.dim() == 2:
        return feats[idx]
    return torch.gather(
        feats, -2, idx.unsqueeze(-1).expand(idx.shape + feats.shape[-1:]))


def interpolate_anchor_features(anchor_feats: torch.Tensor,
                                weights: torch.Tensor,
                                neighbor_idx: torch.Tensor) -> torch.Tensor:
    """Per-point feature Σₖ wₖ · feat[anchorₖ], one neighbour at a time so
    the (N, K, D) gather never materializes."""
    out = None
    for j in range(neighbor_idx.shape[-1]):
        term = weights[..., j:j + 1] * _take_rows(anchor_feats,
                                                  neighbor_idx[..., j])
        out = term if out is None else out + term
    return out


def interpolate_anchor_rotations(anchor_quats: torch.Tensor,
                                 weights: torch.Tensor,
                                 neighbor_idx: torch.Tensor) -> torch.Tensor:
    """Rotation residual blend: normalize per anchor, then weight-sum."""
    return interpolate_anchor_features(quat_normalize(anchor_quats), weights,
                                       neighbor_idx)
