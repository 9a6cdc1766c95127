"""Fixed-capacity Gaussian splats (counterpart of ``igs_tpu/core/gaussians.py``).

Rows past the live count are dead padding marked by ``valid``; ``mask`` is
the dynamic-region (in-bbox) mask that AGM-Net deformation gates on. Every
field may carry leading batch axes (one row set per candidate frame).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Callable, Optional

import numpy as np
import torch

from igs_bench.reference.core.quaternion import quat_multiply, quat_normalize


@dataclass
class Gaussians:
    """Raw (pre-activation) parameters.

    xyz (N, 3); opacity (N, 1) logit; rotation (N, 4) wxyz; scaling (N, 3)
    log-scale; shs (N, 16, 3); valid (N,) bool; mask (N,) bool or None;
    resi_xyz / resi_rotation: residuals of the last deform.
    """

    xyz: torch.Tensor
    opacity: torch.Tensor
    rotation: torch.Tensor
    scaling: torch.Tensor
    shs: torch.Tensor
    valid: torch.Tensor
    mask: Optional[torch.Tensor] = None
    resi_xyz: Optional[torch.Tensor] = None
    resi_rotation: Optional[torch.Tensor] = None

    # -- activations -------------------------------------------------------
    @property
    def get_scaling(self):
        return torch.exp(self.scaling)

    @property
    def get_rotation(self):
        return quat_normalize(self.rotation)

    @property
    def get_xyz(self):
        return self.xyz

    @property
    def get_opacity(self):
        op = torch.sigmoid(self.opacity)
        # dead padding rows must never contribute
        return torch.where(self.valid.unsqueeze(-1), op, torch.zeros_like(op))

    @property
    def num_capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def num_valid(self):
        return torch.sum(self.valid.to(torch.int64), dim=-1)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Gaussians":
        """Apply ``fn`` to every tensor field (None stays None)."""
        return replace(self, **{
            f.name: (None if getattr(self, f.name) is None
                     else fn(getattr(self, f.name)))
            for f in fields(self)})

    @staticmethod
    def stack(items) -> "Gaussians":
        """Stack row sets along a new leading axis."""
        return replace(items[0], **{
            f.name: (None if getattr(items[0], f.name) is None
                     else torch.stack([getattr(g, f.name) for g in items]))
            for f in fields(items[0])})

    def to(self, device) -> "Gaussians":
        return self.map(lambda x: x.to(device))

    # -- deformation -------------------------------------------------------
    def deform(self, res_xyz: torch.Tensor,
               res_rotation: Optional[torch.Tensor] = None,
               res_shs: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None) -> "Gaussians":
        """Apply dense per-Gaussian residuals gated by ``mask``."""
        if mask is None:
            mask = torch.ones(self.xyz.shape[:-1], dtype=torch.bool,
                              device=self.xyz.device)
        m = mask.unsqueeze(-1)
        new = {"mask": mask,
               "resi_xyz": torch.where(m, res_xyz, torch.zeros_like(res_xyz)),
               "xyz": torch.where(m, self.xyz + res_xyz, self.xyz)}
        if res_rotation is not None:
            rot = quat_multiply(self.rotation, res_rotation)
            new["rotation"] = torch.where(m, rot, self.rotation)
            new["resi_rotation"] = torch.where(
                m, res_rotation, torch.zeros_like(res_rotation))
        if res_shs is not None:
            shs = self.shs + res_shs.reshape(self.shs.shape)
            new["shs"] = torch.where(m.unsqueeze(-1), shs, self.shs)
        return replace(self, **new)

    # -- construction ------------------------------------------------------
    @classmethod
    def create(cls, xyz, opacity, rotation, scaling, shs, valid=None,
               device=None) -> "Gaussians":
        def t(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        xyz = t(xyz)
        if valid is None:
            valid = torch.ones(xyz.shape[0], dtype=torch.bool, device=device)
        else:
            valid = torch.tensor(np.asarray(valid, bool), device=device)
        return cls(
            xyz=xyz,
            opacity=t(opacity).reshape(xyz.shape[0], 1),
            rotation=t(rotation),
            scaling=t(scaling),
            shs=t(shs),
            valid=valid,
        )

    def pad_to(self, capacity: int) -> "Gaussians":
        """Grow to ``capacity`` rows with dead padding (unbatched only)."""
        n = self.num_capacity
        if capacity < n:
            raise ValueError(f"capacity {capacity} < current {n}")
        if capacity == n:
            return self
        extra = capacity - n
        dev = self.xyz.device

        def pad(x):
            if x is None:
                return None
            return torch.cat(
                [x, torch.zeros((extra,) + x.shape[1:], dtype=x.dtype,
                                device=dev)])

        return Gaussians(
            xyz=pad(self.xyz),
            # padded rows numerically tame: opacity logit -10 → σ≈0
            opacity=torch.cat([self.opacity, torch.full(
                (extra, 1), -10.0, device=dev)]),
            rotation=torch.cat([self.rotation, torch.tensor(
                [[1.0, 0.0, 0.0, 0.0]], device=dev).expand(extra, 4)]),
            scaling=torch.cat([self.scaling, torch.full(
                (extra, 3), -10.0, device=dev)]),
            shs=pad(self.shs),
            valid=pad(self.valid),
            mask=pad(self.mask),
            resi_xyz=pad(self.resi_xyz),
            resi_rotation=pad(self.resi_rotation),
        )


def inverse_sigmoid(x):
    """logit; a Python number gives a float32 scalar tensor."""
    if not isinstance(x, torch.Tensor):
        return torch.log(torch.tensor(x / (1 - x), dtype=torch.float32))
    return torch.log(x / (1 - x))


def fuse_3d_filter(scaling: torch.Tensor, opacity: torch.Tensor,
                   filter_3d: torch.Tensor):
    """Fuse the RaDe-GS 3D smoothing filter into scale and opacity.

    Raw inputs (log-scale, logit opacity) → ACTIVATED (scales, opacity):
    scales² + filter², opacity · √(det before / det after).
    """
    opacity = torch.sigmoid(opacity)
    scales_sq = torch.square(torch.exp(scaling))
    det1 = torch.prod(scales_sq, dim=1)
    scales_after = scales_sq + torch.square(filter_3d)
    det2 = torch.prod(scales_after, dim=1)
    coef = torch.sqrt(det1 / det2)
    return torch.sqrt(scales_after), opacity * coef[..., None]


def select_points_bbox(points: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    """Boolean in-bbox mask (N,); bbox (2, 3) = [min, max]."""
    ge = torch.all(points >= bbox[0], dim=-1)
    le = torch.all(points <= bbox[1], dim=-1)
    return ge & le
