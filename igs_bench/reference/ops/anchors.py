"""Anchor selection for AGM-Net: bbox mask → FPS anchors → KNN weights.

Counterpart of ``igs_tpu/ops/anchors.py``. The dynamic subset stays a
boolean mask over the full (padded) Gaussian rows; KNN indices address the
anchor array, weights are softmax(−10·distance) over the K nearest.
``select_anchors_no_fps`` is the reference's ablation without FPS or KNN.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from igs_bench.reference.core.gaussians import select_points_bbox
from igs_bench.reference.core.quaternion import quat_normalize
from igs_bench.reference.ops.knn import farthest_point_sampling, knn


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


def select_anchors_no_fps(xyz: torch.Tensor, bbox: torch.Tensor,
                          valid: torch.Tensor | None = None,
                          anchor_size: int = 8192, k: int = 8) -> AnchorState:
    """Ablation precompute: every in-bbox point is its own anchor (the
    reference's get_mask_no_fpsample, gs.py:1013-1053).

    In-bbox points compact, in index order, into the ``anchor_size``
    budget (unused slots hold point 0); each self-anchors in neighbour
    slot 0 with weight 1 (the other K−1 slots repeat it at weight 0).
    Points past the budget leave the mask and stay static.
    """
    n = xyz.shape[0]
    dev = xyz.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    mask = select_points_bbox(xyz, bbox) & valid
    idx = torch.nonzero(mask).reshape(-1)[:anchor_size]
    idx = torch.cat([idx, torch.zeros(anchor_size - idx.shape[0],
                                      dtype=idx.dtype, device=dev)])
    rank = torch.cumsum(mask.to(torch.int32), 0) - 1  # in-bbox rank
    self_slot = torch.clamp(rank, 0, anchor_size - 1)
    weights = torch.zeros((n, k), dtype=torch.float32, device=dev)
    weights[:, 0] = 1.0
    return AnchorState(
        anchor_points=xyz[idx],
        anchor_idx=idx,
        mask=mask & (rank < anchor_size),
        weights=weights,
        neighbor_idx=self_slot[:, None].expand(n, k).long(),
    )
