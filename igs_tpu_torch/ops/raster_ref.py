"""The O(N·P) per-pixel renderer: the ``impl="reference"`` oracle.

Counterpart of ``igs_tpu/ops/raster_ref.py``: every pixel against every
Gaussian in depth order (ties by original index), with the reference's
blending semantics and the tile-coverage constraint applied as a mask (a
Gaussian reaches only the pixels whose tile lies inside its tile
rectangle, as the binning routes give it). Plain PyTorch, differentiable
by autograd. It builds (N, H·W) intermediates per view, so it is for small
scenes only (a few thousand Gaussians at ~100² pixels).
"""

from __future__ import annotations

import torch

from igs_tpu_torch.ops.blend import LOG_TERM, MIN_ALPHA, RenderOutputs
from igs_tpu_torch.ops.projection import ProjectedGaussians, TILE_X, TILE_Y
from igs_tpu_torch.utils.safe_math import safe_norm


def _render_view(proj: ProjectedGaussians, height: int, width: int,
                 focal_x, focal_y, bg: torch.Tensor) -> RenderOutputs:
    """One view: ``proj`` fields (N, ...), focal scalars, bg (3,)."""
    n = proj.depth.shape[0]
    dev = proj.depth.device
    depth_key = torch.where(proj.visible, proj.depth,
                            torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(depth_key, stable=True)
    xy, conic = proj.means2d[order], proj.conic[order]
    opac, color = proj.opacity[order], proj.color[order]
    vp, tc = proj.view_point[order], proj.t_center[order]
    cp, rp, nrm = (proj.camera_plane[order], proj.ray_plane[order],
                   proj.normal[order])
    rmin, rmax = proj.rect_min[order], proj.rect_max[order]
    vis = proj.visible[order]

    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    pixf = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)  # (P, 2)
    ptile_x = torch.div(pixf[:, 0], TILE_X, rounding_mode="floor").to(
        torch.int32)
    ptile_y = torch.div(pixf[:, 1], TILE_Y, rounding_mode="floor").to(
        torch.int32)

    dx = xy[:, 0:1] - pixf[None, :, 0]  # (N, P)
    dy = xy[:, 1:2] - pixf[None, :, 1]
    power = (-0.5 * (conic[:, 0:1] * dx * dx + conic[:, 2:3] * dy * dy)
             - conic[:, 1:2] * dx * dy)
    alpha = torch.clamp_max(
        opac[:, None] * torch.exp(torch.clamp_max(power, 0.0)), 0.99)
    covers = ((ptile_x[None, :] >= rmin[:, 0:1])
              & (ptile_x[None, :] < rmax[:, 0:1])
              & (ptile_y[None, :] >= rmin[:, 1:2])
              & (ptile_y[None, :] < rmax[:, 1:2]))
    cand = vis[:, None] & covers & (power <= 0.0) & (alpha >= MIN_ALPHA)
    zero = torch.zeros_like(alpha)
    a = torch.where(cand, alpha, zero)
    log1m = torch.log1p(-a)
    cum_incl = torch.cumsum(log1m, dim=0)
    cum_excl = cum_incl - log1m
    accept = cand & (cum_incl >= LOG_TERM)
    t_before = torch.exp(cum_excl)
    w = torch.where(accept, a * t_before, zero)  # (N, P)

    weight = torch.sum(w, dim=0)
    out_color = torch.einsum("np,nc->pc", w, color)
    coord = (torch.einsum("np,nc->pc", w, vp)
             + torch.einsum("np,nc->pc", w * dx, cp[:, 0::2])
             + torch.einsum("np,nc->pc", w * dy, cp[:, 1::2]))
    t_px = tc[:, None] + rp[:, 0:1] * dx + rp[:, 1:2] * dy
    depth = torch.sum(w * t_px, dim=0)
    normal = torch.einsum("np,nc->pc", w, nrm)

    t_final = torch.exp(torch.sum(torch.where(accept, log1m, zero), dim=0))
    out_color = out_color + t_final[:, None] * bg[None, :]

    # median: the last accepted pair with T_before > 0.5
    med = accept & (t_before > 0.5)
    gidx = torch.arange(1, n + 1, dtype=torch.int32, device=dev)[:, None]
    izero = torch.zeros((), dtype=torch.int32, device=dev)
    sel1 = torch.amax(torch.where(med, gidx, izero), dim=0)
    has = sel1 > 0
    gsel = torch.clamp_min(sel1 - 1, 0).long()
    parange = torch.arange(pixf.shape[0], device=dev)
    dxs, dys = dx[gsel, parange], dy[gsel, parange]
    mdepth = torch.where(
        has, tc[gsel] + rp[gsel, 0] * dxs + rp[gsel, 1] * dys,
        torch.zeros_like(dxs))
    mcoord = torch.where(
        has[:, None],
        vp[gsel] + cp[gsel, 0::2] * dxs[:, None] + cp[gsel, 1::2]
        * dys[:, None], torch.zeros_like(vp[gsel]))

    lastg = torch.amax(torch.where(accept, gidx, izero), dim=0)
    any_acc = lastg > 0
    lnf = torch.sqrt(((pixf[:, 0] - width / 2.0) / focal_x) ** 2
                     + ((pixf[:, 1] - height / 2.0) / focal_y) ** 2 + 1.0)
    wsafe = torch.where(weight > 0, weight, torch.ones_like(weight))
    out_coord = torch.where(any_acc[:, None], coord / wsafe[:, None],
                            torch.zeros_like(coord))
    depth_ln = depth / lnf
    out_depth = torch.where(any_acc, depth_ln / wsafe,
                            torch.zeros_like(depth_ln))
    nlen = torch.clamp_min(safe_norm(normal, keepdim=True), 1e-12)
    out_normal = torch.where(any_acc[:, None], normal / nlen,
                             torch.zeros_like(normal))

    def img(x):
        if x.dim() == 2:
            return x.reshape(height, width, -1).permute(2, 0, 1)
        return x.reshape(height, width)

    return RenderOutputs(
        color=img(out_color), alpha=img(weight), coord=img(out_coord),
        mcoord=img(mcoord), depth=img(out_depth), mdepth=img(mdepth / lnf),
        normal=img(out_normal), accum_coord=img(coord),
        accum_depth=img(depth_ln), n_contrib=img(lastg),
        max_contrib=img(sel1))


def render_reference(proj: ProjectedGaussians, height: int, width: int,
                     focal_x, focal_y, bg: torch.Tensor) -> RenderOutputs:
    """Render each view of ``proj`` (V, N, ...) on its own; focal_x,
    focal_y () or (V,), bg (3,) or (V, 3). Outputs keep the (V,) axis."""
    views = proj.depth.shape[0]
    dev = proj.depth.device
    fx = torch.as_tensor(focal_x, dtype=torch.float32, device=dev).reshape(
        -1).expand(views)
    fy = torch.as_tensor(focal_y, dtype=torch.float32, device=dev).reshape(
        -1).expand(views)
    bgs = bg.to(torch.float32).reshape(-1, 3).expand(views, 3)
    outs = [_render_view(ProjectedGaussians(*(x[v] for x in proj)), height,
                         width, fx[v], fy[v], bgs[v]) for v in range(views)]
    return RenderOutputs(*(torch.stack(f) for f in zip(*outs)))
