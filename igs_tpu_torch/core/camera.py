"""Camera model and projection matrices (3DGS conventions).

Counterpart of ``igs_tpu/core/camera.py``. ``world_view_transform`` and
``full_proj_transform`` are stored TRANSPOSED (row-vector convention,
``p_row @ M``) like the reference. A camera may hold a leading batch axis
(``Camera.stack``) so several views project in one pass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Sequence, Tuple

import numpy as np
import torch


def fov2focal(fov, pixels):
    if isinstance(fov, torch.Tensor):
        return pixels / (2 * torch.tan(fov / 2))
    return pixels / (2 * math.tan(fov / 2))


def get_projection_matrix(znear: float, zfar: float, fovx: torch.Tensor,
                          fovy: torch.Tensor) -> torch.Tensor:
    """Perspective matrix, math convention (column-vector), z∈[0,1]."""
    p = torch.zeros(fovx.shape + (4, 4), dtype=torch.float32,
                    device=fovx.device)
    p[..., 0, 0] = 1.0 / torch.tan(fovx / 2)
    p[..., 1, 1] = 1.0 / torch.tan(fovy / 2)
    p[..., 2, 2] = zfar / (zfar - znear)
    p[..., 2, 3] = -(zfar * znear) / (zfar - znear)
    p[..., 3, 2] = 1.0
    return p


# the fields that carry the leading view axis of a stack
_PER_VIEW = ("world_view_transform", "full_proj_transform", "camera_center",
             "tanfovx", "tanfovy")


@dataclass
class Camera:
    """Transposed w2c / full projection, center and half-fov tangents.

    Tensor fields are (4, 4) / (3,) / () for one camera, with a leading
    (V,) axis for a stack of views that share ``height`` × ``width``.
    """

    world_view_transform: torch.Tensor
    full_proj_transform: torch.Tensor
    camera_center: torch.Tensor
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor
    height: int = 512
    width: int = 512
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tanfovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tanfovy)

    @property
    def device(self) -> torch.device:
        return self.world_view_transform.device

    @classmethod
    def from_w2c(cls, w2c, fovx, fovy, height: int, width: int,
                 znear: float = 0.01, zfar: float = 100.0,
                 device=None) -> "Camera":
        w2c = torch.as_tensor(np.asarray(w2c, np.float32) if not isinstance(
            w2c, torch.Tensor) else w2c, dtype=torch.float32, device=device)
        dev = w2c.device
        fovx = torch.as_tensor(fovx, dtype=torch.float32, device=dev)
        fovy = torch.as_tensor(fovy, dtype=torch.float32, device=dev)
        wvt = w2c.transpose(-1, -2)
        proj = get_projection_matrix(znear, zfar, fovx, fovy).transpose(-1, -2)
        full = wvt @ proj
        cam_center = torch.linalg.inv(wvt)[..., 3, :3]
        return cls(
            world_view_transform=wvt.contiguous(),
            full_proj_transform=full,
            camera_center=cam_center,
            tanfovx=torch.tan(fovx / 2),
            tanfovy=torch.tan(fovy / 2),
            height=int(height),
            width=int(width),
            znear=znear,
            zfar=zfar,
        )

    @classmethod
    def from_c2w(cls, c2w, fov: Tuple, resolution: Tuple[int, int],
                 device=None) -> "Camera":
        c2w = torch.as_tensor(np.asarray(c2w, np.float32) if not isinstance(
            c2w, torch.Tensor) else c2w, dtype=torch.float32, device=device)
        w2c = torch.linalg.inv(c2w)
        return cls.from_w2c(w2c, fov[0], fov[1], height=int(resolution[0]),
                            width=int(resolution[1]))

    @staticmethod
    def stack(cams: Sequence["Camera"]) -> "Camera":
        """Stack single cameras of one resolution along a new view axis."""
        return replace(cams[0], **{
            f: torch.stack([getattr(c, f) for c in cams]) for f in _PER_VIEW})

    def view(self, i: int) -> "Camera":
        """View ``i`` of a stack, as a single camera."""
        return replace(self, **{f: getattr(self, f)[i] for f in _PER_VIEW})

    def batched(self) -> "Camera":
        """This camera with a leading view axis (a single camera gets V=1)."""
        if self.world_view_transform.dim() == 3:
            return self
        return Camera.stack([self])


def ray_to_plucker(rays: torch.Tensor) -> torch.Tensor:
    """[origin | dir] (..., 6) → Plücker [unit dir | moment o×d] (..., 6)."""
    origin, direction = rays[..., :3], rays[..., 3:6]
    direction = direction / torch.linalg.norm(
        direction, dim=-1, keepdim=True).clamp_min(1e-12)
    moment = torch.cross(origin, direction, dim=-1)
    return torch.cat([direction, moment], dim=-1)
