"""Real spherical harmonics up to degree 3 (``igs_tpu/core/sh.py``)."""

from __future__ import annotations

import torch

from igs_bench.reference.utils.safe_math import safe_normalize

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis(dirs: torch.Tensor, deg: int) -> torch.Tensor:
    """SH basis for unit directions (..., 3) → (..., (deg+1)²), 3DGS order."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if deg > 0:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if deg > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def eval_sh_color(shs: torch.Tensor, means: torch.Tensor,
                  campos: torch.Tensor, deg: int = 3) -> torch.Tensor:
    """SH → RGB as the rasterizer's preprocess, clamped ≥ 0.

    shs (..., N, M, 3), means (..., N, 3), campos (..., 3) → (..., N, 3).
    """
    dirs = safe_normalize(means - campos.unsqueeze(-2))
    basis = sh_basis(dirs, deg)
    k = basis.shape[-1]
    result = torch.einsum("...nk,...nkc->...nc", basis, shs[..., :k, :]) + 0.5
    return torch.clamp_min(result, 0.0)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the DC term (the reference's RGB2SH)."""
    return (rgb - 0.5) / SH_C0


def rsh_cart_3(xyz: torch.Tensor) -> torch.Tensor:
    """All real SH up to degree 3, torch-spherical-harmonics ordering."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    x2, y2, z2 = x**2, y**2, z**2
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.full_like(x, 0.282094791773878),
            -0.48860251190292 * y,
            0.48860251190292 * z,
            -0.48860251190292 * x,
            1.09254843059208 * xy,
            -1.09254843059208 * yz,
            0.94617469575756 * z2 - 0.31539156525252,
            -1.09254843059208 * xz,
            0.54627421529604 * x2 - 0.54627421529604 * y2,
            -0.590043589926644 * y * (3.0 * x2 - y2),
            2.89061144264055 * xy * z,
            0.304697199642977 * y * (1.5 - 7.5 * z2),
            1.24392110863372 * z * (1.5 * z2 - 0.5) - 0.497568443453487 * z,
            0.304697199642977 * x * (1.5 - 7.5 * z2),
            1.44530572132028 * z * (x2 - y2),
            -0.590043589926644 * x * (x2 - 3.0 * y2),
        ],
        -1,
    )
