"""Per-Gaussian projection ("preprocess") in plain PyTorch.

Counterpart of ``igs_tpu/ops/projection.py``: view/pixel positions, EWA 2D
covariance and conic, the opacity-aware tile rectangle, SH color and the
RaDe-GS geometry extras (camera planes, ray plane, camera-space normal).
Elementwise work over N Gaussians; no kernel of its own.

Every output carries a leading view axis: ``project`` takes a camera with
a (V,) axis (``Camera.batched``) and Gaussians shaped (N, ...) (shared by
all views) or (V, N, ...) (one row set per view).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from igs_bench.reference.core.quaternion import quat_to_rotmat
from igs_bench.reference.core.sh import eval_sh_color
from igs_bench.reference.utils.safe_math import safe_norm, safe_normalize

NEAR_PLANE = 0.2
TILE_X = 16
TILE_Y = 16


class ProjectedGaussians(NamedTuple):
    """Per-Gaussian raster inputs, all shaped (V, N, ...)."""

    means2d: torch.Tensor  # (V, N, 2) pixel coords
    conic: torch.Tensor  # (V, N, 3) upper-tri inverse 2D cov
    opacity: torch.Tensor  # (V, N) opacity * mip coef
    color: torch.Tensor  # (V, N, 3)
    depth: torch.Tensor  # (V, N) view z (sort key)
    view_point: torch.Tensor  # (V, N, 3) camera-space position
    t_center: torch.Tensor  # (V, N) ray distance ‖p_view‖
    camera_plane: torch.Tensor  # (V, N, 6)
    ray_plane: torch.Tensor  # (V, N, 2)
    normal: torch.Tensor  # (V, N, 3) camera-space
    radius: torch.Tensor  # (V, N) int32 pixel radius
    rect_min: torch.Tensor  # (V, N, 2) int32 tile rect (x, y)
    rect_max: torch.Tensor  # (V, N, 2) int32
    tiles_touched: torch.Tensor  # (V, N) int32
    visible: torch.Tensor  # (V, N) bool


def _sym_outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_k a[..., i, k] · b[..., j, k] → (..., 3, 3)."""
    return torch.sum(a.unsqueeze(-2) * b.unsqueeze(-3), dim=-1)


def compute_cov3d(scaling, rotation, modifier: float = 1.0):
    """Σ = R S² Rᵀ (world) from activated scales and normalized quats."""
    r = quat_to_rotmat(rotation, normalize=False)
    s2 = torch.square(modifier * scaling)
    return _sym_outer(r * s2.unsqueeze(-2), r)


def _sandwich(r_view: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """R m Rᵀ for view rotations (V, 3, 3) and matrices (..., N, 3, 3)."""
    rv = r_view[:, None]  # (V, 1, 3, 3)
    tmp = torch.sum(rv.unsqueeze(-1) * m.unsqueeze(-3), dim=-2)  # R m
    return torch.sum(tmp.unsqueeze(-2) * rv.unsqueeze(-3), dim=-1)


def project(
    means3d: torch.Tensor,
    scaling: torch.Tensor,
    rotation: torch.Tensor,
    opacity: torch.Tensor,
    camera,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    sh_degree: int = 3,
    kernel_size: float = 0.0,
    scale_modifier: float = 1.0,
    valid: Optional[torch.Tensor] = None,
    geometry: bool = True,
) -> ProjectedGaussians:
    camera = camera.batched()
    f32 = torch.float32
    means3d = means3d.to(f32)
    if opacity.dim() == means3d.dim():  # (..., N, 1) → (..., N)
        opacity = opacity[..., 0]
    w, h = camera.width, camera.height
    fx = camera.focal_x[:, None]  # (V, 1)
    fy = camera.focal_y[:, None]
    tanfovx = camera.tanfovx[:, None]
    tanfovy = camera.tanfovy[:, None]
    wvt = camera.world_view_transform  # (V, 4, 4)
    fpt = camera.full_proj_transform

    # frustum / projection (preprocessCUDA)
    p_view = means3d @ wvt[:, :3, :3] + wvt[:, None, 3, :3]  # (V, N, 3)
    p_hom = means3d @ fpt[:, :3, :] + fpt[:, None, 3, :]
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    p_proj = p_hom[..., :3] * p_w.unsqueeze(-1)
    in_front = p_view[..., 2] > NEAR_PLANE

    cov3d = compute_cov3d(scaling, rotation, scale_modifier)

    # cov2D: EWA with fov clamp (computeCov2D)
    tz = p_view[..., 2]
    tz_safe = torch.where(torch.abs(tz) > 1e-8, tz, torch.full_like(tz, 1e-8))
    limx, limy = 1.3 * tanfovx, 1.3 * tanfovy
    txtz = torch.maximum(torch.minimum(p_view[..., 0] / tz_safe, limx), -limx)
    tytz = torch.maximum(torch.minimum(p_view[..., 1] / tz_safe, limy), -limy)
    tx, ty = txtz * tz, tytz * tz

    r_view = wvt[:, :3, :3].transpose(-1, -2)  # w2c rotation (V, 3, 3)
    s = _sandwich(r_view, cov3d)

    inv_tz = 1.0 / tz_safe
    inv_tz2 = inv_tz * inv_tz
    j00 = fx * inv_tz
    j02 = -fx * tx * inv_tz2
    j11 = fy * inv_tz
    j12 = -fy * ty * inv_tz2
    a_xx = (j00 * (j00 * s[..., 0, 0] + j02 * s[..., 2, 0])
            + j02 * (j00 * s[..., 0, 2] + j02 * s[..., 2, 2]))
    a_xy = (j11 * (j00 * s[..., 0, 1] + j02 * s[..., 2, 1])
            + j12 * (j00 * s[..., 0, 2] + j02 * s[..., 2, 2]))
    a_yy = (j11 * (j11 * s[..., 1, 1] + j12 * s[..., 2, 1])
            + j12 * (j11 * s[..., 1, 2] + j12 * s[..., 2, 2]))

    det0 = torch.clamp_min(a_xx * a_yy - a_xy * a_xy, 1e-6)
    det1 = torch.clamp_min(
        (a_xx + kernel_size) * (a_yy + kernel_size) - a_xy * a_xy, 1e-6)
    coef = torch.sqrt(det0 / (det1 + 1e-6) + 1e-6)
    raw_det0 = a_xx * a_yy - a_xy * a_xy
    raw_det1 = (a_xx + kernel_size) * (a_yy + kernel_size) - a_xy * a_xy
    coef = torch.where((raw_det0 <= 1e-6) | (raw_det1 <= 1e-6),
                       torch.zeros_like(coef), coef)

    if geometry:
        camera_plane, ray_plane, normal = _geometry_extras(
            rotation, scaling, scale_modifier, r_view, txtz, tytz,
            tx, ty, tz, inv_tz, inv_tz2, fx, fy)
    else:
        shape = p_view.shape[:-1]
        camera_plane = torch.zeros(shape + (6,), dtype=f32, device=tz.device)
        ray_plane = torch.zeros(shape + (2,), dtype=f32, device=tz.device)
        normal = torch.zeros(shape + (3,), dtype=f32, device=tz.device)

    # conic, radius, tile rect
    det = raw_det0
    det_ok = det != 0.0
    det_inv = torch.where(
        det_ok, 1.0 / torch.where(det_ok, det, torch.ones_like(det)),
        torch.zeros_like(det))
    conic = torch.stack([a_yy * det_inv, -a_xy * det_inv, a_xx * det_inv], -1)

    mid = 0.5 * (a_xx + a_yy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    sqrt_l1 = torch.sqrt(torch.maximum(mid + disc, mid - disc))
    radius_f = torch.ceil(3.0 * sqrt_l1)

    # opacity-aware rect: pixels beyond d* = √(2·ln(255·o_eff))·√λ₁ can
    # never pass the α ≥ 1/255 skip; bin to min(3σ, d*)
    o_eff = opacity * coef
    ln_t = torch.log(255.0 * torch.clamp_min(o_eff, 1e-12))
    aware_f = torch.ceil(torch.sqrt(2.0 * torch.clamp_min(ln_t, 0.0)) * sqrt_l1)
    rect_radius = torch.minimum(radius_f, aware_f)
    dead = o_eff < 1.0 / 255.0

    def ndc2pix(x, size):
        return ((x + 1.0) * size - 1.0) * 0.5

    px = ndc2pix(p_proj[..., 0], w)
    py = ndc2pix(p_proj[..., 1], h)
    means2d = torch.stack([px, py], -1)

    grid_x = (w + TILE_X - 1) // TILE_X
    grid_y = (h + TILE_Y - 1) // TILE_Y

    def tile_idx(v, tile, grid):
        # int truncation toward zero then clamp (getRect); pre-clamped in
        # float so the integer conversion is always defined
        v = torch.clamp(v / tile, -1.0, grid + 1.0)
        return torch.clamp(v.to(torch.int32), 0, grid)

    x0 = tile_idx(px - radius_f, TILE_X, grid_x)
    y0 = tile_idx(py - radius_f, TILE_Y, grid_y)
    x1 = tile_idx(px + radius_f + TILE_X - 1, TILE_X, grid_x)
    y1 = tile_idx(py + radius_f + TILE_Y - 1, TILE_Y, grid_y)
    # the aware rect rounds its max side outward and intersects the 3σ one
    ax_max = tile_idx(px + rect_radius + TILE_X, TILE_X, grid_x)
    ay_max = tile_idx(py + rect_radius + TILE_Y, TILE_Y, grid_y)
    ax_min = tile_idx(px - rect_radius, TILE_X, grid_x)
    ay_min = tile_idx(py - rect_radius, TILE_Y, grid_y)
    rxmin = torch.maximum(x0, ax_min)
    rymin = torch.maximum(y0, ay_min)
    rxmax = torch.minimum(x1, ax_max)
    rymax = torch.minimum(y1, ay_max)
    rxmax = torch.where(dead, rxmin, torch.maximum(rxmax, rxmin))
    rymax = torch.where(dead, rymin, torch.maximum(rymax, rymin))
    tiles = (rxmax - rxmin) * (rymax - rymin)

    tiles3 = (x1 - x0) * (y1 - y0)
    visible = in_front & det_ok & (tiles3 > 0)
    if valid is not None:
        visible = visible & valid

    if colors_precomp is not None:
        color = colors_precomp.to(f32).expand(p_view.shape[:-1] + (3,))
    else:
        color = eval_sh_color(shs.to(f32), means3d, camera.camera_center,
                              sh_degree)

    radius = torch.where(visible, radius_f, torch.zeros_like(radius_f))
    tiles = torch.where(visible, tiles, torch.zeros_like(tiles))

    return ProjectedGaussians(
        means2d=means2d,
        conic=conic,
        opacity=opacity * coef,
        color=color,
        depth=p_view[..., 2],
        view_point=p_view,
        t_center=safe_norm(p_view),
        camera_plane=camera_plane,
        ray_plane=ray_plane,
        normal=normal,
        radius=radius.to(torch.int32),
        rect_min=torch.stack([rxmin, rymin], -1),
        rect_max=torch.stack([rxmax, rymax], -1),
        tiles_touched=tiles,
        visible=visible,
    )


def _geometry_extras(rotation, scaling, scale_modifier, r_view, txtz, tytz,
                     tx, ty, tz, inv_tz, inv_tz2, fx, fy):
    """Camera/ray plane + normal chain (forward.cu:135-262)."""
    r_mat = quat_to_rotmat(rotation, normalize=False)  # columns = axes
    s2 = torch.square(scale_modifier * scaling)
    well = torch.amin(s2, dim=-1) > 1e-8
    inv_s2 = 1.0 / torch.clamp_min(s2, 1e-30)
    vrk_inv_full = _sym_outer(r_mat * inv_s2.unsqueeze(-2), r_mat)
    min_idx = torch.argmin(s2, dim=-1)
    e_min = torch.gather(
        r_mat, -1, min_idx[..., None, None].expand(r_mat.shape[:-1] + (1,))
    )[..., 0]
    vrk_inv_rank1 = e_min.unsqueeze(-1) * e_min.unsqueeze(-2)
    vrk_inv = torch.where(well[..., None, None], vrk_inv_full, vrk_inv_rank1)

    cov_cam_inv = _sandwich(r_view, vrk_inv)
    uvh = torch.stack([txtz, tytz, torch.ones_like(txtz)], dim=-1)
    uvh_m = torch.sum(cov_cam_inv * uvh.unsqueeze(-2), dim=-1)
    geom_ok = safe_norm(uvh_m) > 1e-30
    uvh_mn = safe_normalize(uvh_m)

    u, v = txtz, tytz
    u2, v2, uv = u * u, v * v, u * v
    nl = u2 + v2 + 1.0
    length_t = safe_norm(torch.stack([tx, ty, tz], -1))
    vbn = torch.sum(uvh_mn * uvh, dim=-1)
    denom = torch.clamp_min(vbn, 1e-7)
    q0 = uvh_mn[..., 0] / denom
    q1 = uvh_mn[..., 1] / denom
    q2 = uvh_mn[..., 2] / denom
    plane0 = (v2 + 1.0) * q0 - uv * q1 - u * q2
    plane1 = -uv * q0 + (u2 + 1.0) * q1 - v * q2

    cpx = torch.stack([(-(v2 + 1.0) * tz + plane0 * tx) / nl / fx,
                       (uv * tz + plane1 * tx) / nl / fy], -1)
    cpy = torch.stack([(uv * tz + plane0 * ty) / nl / fx,
                       (-(u2 + 1.0) * tz + plane1 * ty) / nl / fy], -1)
    cpz = torch.stack([(tx + plane0 * tz) / nl / fx,
                       (ty + plane1 * tz) / nl / fy], -1)
    camera_plane = torch.cat([cpx, cpy, cpz], dim=-1)  # (V, N, 6)
    ray_plane = torch.stack([plane0 * length_t / nl / fx,
                             plane1 * length_t / nl / fy], -1)

    factor_normal = length_t / nl
    rnv0 = -plane0 * factor_normal
    rnv1 = -plane1 * factor_normal
    inv_l = 1.0 / torch.clamp_min(length_t, 1e-12)
    cn0 = rnv0 * inv_tz - tx * inv_l
    cn1 = rnv1 * inv_tz - ty * inv_l
    cn2 = -(rnv0 * tx + rnv1 * ty) * inv_tz2 - tz * inv_l
    normal = safe_normalize(torch.stack([cn0, cn1, cn2], -1))

    ok = geom_ok.unsqueeze(-1)
    camera_plane = torch.where(ok, camera_plane, torch.zeros_like(camera_plane))
    ray_plane = torch.where(ok, ray_plane, torch.zeros_like(ray_plane))
    normal = torch.where(ok, normal, torch.zeros_like(normal))
    return camera_plane, ray_plane, normal
