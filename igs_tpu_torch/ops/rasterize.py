"""Public differentiable rasterization API.

Counterpart of ``igs_tpu/ops/rasterize.py``: project → bin into tile
pairs → blend → untile, by one of two routes (``RasterSettings.impl``):
``"pallas_packed"`` walks each tile's segment of the sorted pair list in
place (``ops/blend.py``); ``"pallas"`` gathers per-tile windows of
``max_per_tile`` rows and blends those (``ops/blend_windowed.py``),
dropping the pairs past a tile's window. The JAX package's
``"tiles"``/``"reference"`` oracles are not ported (ROADMAP A6). Inputs
follow the reference binding: activated opacity and scales, normalized
rotations, raw SH. On CUDA tensors the blends and their backwards are the
hand-written kernels; on CPU tensors their plain versions.

Differentiable with respect to ``means3d``, ``opacity``, ``scaling``,
``rotation``, ``shs`` (or ``colors_precomp``) and ``means2d_offset``: an
NDC offset added to the projected means, whose gradient is the
reference's screen-space gradient that densify accumulates. Radii and
overflow carry no gradient. With ``clamp_grads`` (the reference's clamp
rasterizer) the gradients of the five Gaussian parameters that flow back
through one ``rasterize`` call are clamped to ±``clamp_value``;
``colors_precomp``, ``means2d_offset`` and ``bg`` pass unclamped. A
caller that renders several views through separate calls, as
``models/renderer.render_views`` does, clamps per view, as the JAX
package's ``custom_vjp`` does.

A camera with a leading view axis (``Camera.stack``) renders every view
in one binning pass and one blend launch; the outputs then keep the view
axis. Truncation is surfaced, never hidden: ``overflow_tiles`` is, per
view, the number of tiles past ``max_per_tile`` (windowed route) plus
1<<20 when the view's pairs overflowed the pair budget.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from igs_tpu_torch.ops.binning import (
    TilePairs, build_tile_pairs, image_tile_grid)
from igs_tpu_torch.ops.blend import LOG_TERM, MIN_ALPHA, render_tiles_packed
from igs_tpu_torch.ops.blend_windowed import render_tiles_windowed
from igs_tpu_torch.ops.count import count_contributions_packed, count_rows
from igs_tpu_torch.ops.projection import TILE_X, TILE_Y, project

OVERFLOW_CODE = 1 << 20


class RasterSettings(NamedTuple):
    """Static rasterization configuration."""

    image_height: int = 512
    image_width: int = 512
    sh_degree: int = 3
    kernel_size: float = 0.0
    scale_modifier: float = 1.0
    max_pairs: int = 2**21  # pair budget per view
    # "full" = all RaDe-GS outputs; "color_depth" = color + expected
    # coord/depth; "color" = color/alpha only (16-lane pack, 8 raw lanes)
    outputs: str = "full"
    # "pallas_packed" = the sorted pair list walked in place; "pallas" =
    # per-tile windows of max_per_tile rows (pairs past them are dropped
    # and counted in overflow_tiles)
    impl: str = "pallas_packed"
    max_per_tile: int = 4096
    chunk: int = 128  # rows per prefix-sum chunk of the plain versions
    clamp_grads: bool = False
    clamp_value: float = 15.0


IMPLS = ("pallas_packed", "pallas")


class _ClampGrads(torch.autograd.Function):
    """Identity forward; the backward clamps each gradient to ±value."""

    @staticmethod
    def forward(ctx, value, *xs):
        ctx.value = value
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        v = ctx.value
        return (None,) + tuple(None if g is None else torch.clamp(g, -v, v)
                               for g in grads)


def _clamped(value, *xs):
    """``xs`` (None entries kept) through ``_ClampGrads``."""
    live = [i for i, x in enumerate(xs) if x is not None and x.requires_grad]
    if not live:
        return xs
    out = list(xs)
    for i, y in zip(live, _ClampGrads.apply(value, *(xs[i] for i in live))):
        out[i] = y
    return tuple(out)


def rasterize(
    means3d: torch.Tensor,
    opacity: torch.Tensor,
    scaling: torch.Tensor,
    rotation: torch.Tensor,
    camera,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    bg: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    settings: RasterSettings = RasterSettings(),
    pairs_override: Optional[TilePairs] = None,
) -> dict:
    """Render; returns the reference's outputs as a dict plus radii.

    ``pairs_override``: a caller-supplied (possibly stale) pair list from
    ``build_pairs_packed`` used instead of binning these Gaussians.
    """
    if (shs is None) == (colors_precomp is None):
        raise ValueError("provide exactly one of shs / colors_precomp")
    if settings.impl not in IMPLS:
        raise NotImplementedError(
            f"impl={settings.impl!r} is not ported (ROADMAP A6); the port "
            f"has {IMPLS}")
    if pairs_override is not None and settings.impl != "pallas_packed":
        raise NotImplementedError("pairs_override requires "
                                  "impl='pallas_packed'")
    if settings.clamp_grads:
        means3d, opacity, scaling, rotation, shs = _clamped(
            settings.clamp_value, means3d, opacity, scaling, rotation, shs)
    dev = means3d.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    batched = camera.world_view_transform.dim() == 3
    cam = camera.batched()
    h, w = settings.image_height, settings.image_width
    if (cam.height, cam.width) != (h, w):
        raise ValueError(f"camera is {cam.height}x{cam.width}, settings {h}x{w}")
    proj = project(
        means3d, scaling, rotation, opacity, cam, shs=shs,
        colors_precomp=colors_precomp, sh_degree=settings.sh_degree,
        kernel_size=settings.kernel_size,
        scale_modifier=settings.scale_modifier, valid=valid,
        # color-only rendering never reads camera/ray planes or normals
        geometry=settings.outputs != "color",
    )
    if means2d_offset is not None:
        # NDC offset → pixel offset (ndc2pix is affine with slope size/2)
        scale = torch.tensor([0.5 * w, 0.5 * h], dtype=torch.float32,
                             device=dev)
        proj = proj._replace(means2d=proj.means2d + means2d_offset * scale)
    grid_x, grid_y = image_tile_grid(h, w)
    if pairs_override is not None:
        pairs = pairs_override
    else:
        pairs = build_tile_pairs(proj, grid_x, grid_y, settings.max_pairs,
                                 segred_aux=_segred_aux(settings))
    overflow = torch.where(pairs.overflowed, OVERFLOW_CODE, 0)
    if settings.impl == "pallas":
        out = render_tiles_windowed(proj, pairs, h, w, cam.focal_x,
                                    cam.focal_y, bg, settings.max_per_tile,
                                    mode=settings.outputs,
                                    chunk=settings.chunk)
        truncated = pairs.tile_count.reshape(proj.depth.shape[0], -1) \
            > settings.max_per_tile
        overflow = overflow + truncated.sum(dim=1)
    else:
        out = render_tiles_packed(proj, pairs, h, w, cam.focal_x, cam.focal_y,
                                  bg, mode=settings.outputs)
    overflow = overflow.to(torch.int32)
    result = {
        "overflow_tiles": overflow,
        "color": out.color,
        "alpha": out.alpha,
        "coord": out.coord,
        "mcoord": out.mcoord,
        "depth": out.depth,
        "mdepth": out.mdepth,
        "normal": out.normal,
        "radii": proj.radius,
        "n_contrib": out.n_contrib,
    }
    if not batched:
        result = {k: v[0] for k, v in result.items()}
    return result


def build_pairs_packed(means3d, opacity, scaling, rotation, camera,
                       valid=None,
                       settings: RasterSettings = RasterSettings()) -> TilePairs:
    """Binning only: the tile-pair list the packed renderer consumes."""
    n = means3d.shape[-2]
    proj = project(
        means3d, scaling, rotation, opacity, camera.batched(),
        colors_precomp=torch.zeros((n, 3), dtype=torch.float32,
                                   device=means3d.device),
        kernel_size=settings.kernel_size,
        scale_modifier=settings.scale_modifier,
        valid=valid,
        geometry=False,  # rect/depth/visibility only
    )
    grid_x, grid_y = image_tile_grid(settings.image_height,
                                     settings.image_width)
    # the cached list keeps the segred aux, so a stale list still takes
    # the scatter-free backward
    return build_tile_pairs(proj, grid_x, grid_y, settings.max_pairs,
                            segred_aux=_segred_aux(settings))


def count_gaussians(means3d, opacity, scaling, rotation, camera, valid=None,
                    settings: RasterSettings = RasterSettings()):
    """LightGaussian importance counting (the compress rasterizer).

    Returns (count int32, score float32), each (N,) (or (V, N) for a
    stacked camera): per Gaussian the number of accepted pixel
    contributions, and count · the projected opacity (the reference adds
    the constant conic opacity once per accepted pixel). Binning as for a
    render, then ``ops/count.count_contributions_packed`` (the kernel on
    CUDA tensors) over the packed pair list.
    """
    n = means3d.shape[-2]
    batched = camera.world_view_transform.dim() == 3
    cam = camera.batched()
    h, w = settings.image_height, settings.image_width
    proj = project(
        means3d, scaling, rotation, opacity, cam,
        colors_precomp=torch.zeros((n, 3), dtype=torch.float32,
                                   device=means3d.device),
        kernel_size=settings.kernel_size,
        scale_modifier=settings.scale_modifier, valid=valid,
        geometry=False,  # counting reads only xy, conic and opacity
    )
    grid_x, grid_y = image_tile_grid(h, w)
    pairs = build_tile_pairs(proj, grid_x, grid_y, settings.max_pairs)
    count = count_contributions_packed(
        count_rows(proj), pairs.gauss_id, pairs.tile_start, pairs.tile_count,
        grid_x, grid_y, w, h).reshape(proj.opacity.shape)
    score = count.float() * proj.opacity
    if not batched:
        return count[0], score[0]
    return count, score


def count_gaussians_dense(means3d, opacity, scaling, rotation, camera,
                          valid=None,
                          settings: RasterSettings = RasterSettings()):
    """The O(N·H·W) oracle of ``count_gaussians`` for one camera: every
    Gaussian against every pixel in depth order. For tests only."""
    n = means3d.shape[-2]
    dev = means3d.device
    proj = project(
        means3d, scaling, rotation, opacity, camera.batched(),
        colors_precomp=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        kernel_size=settings.kernel_size,
        scale_modifier=settings.scale_modifier, valid=valid, geometry=False)
    proj = proj._replace(**{k: v[0] for k, v in proj._asdict().items()})
    h, w = settings.image_height, settings.image_width
    depth_key = torch.where(proj.visible, proj.depth,
                            torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(depth_key, stable=True)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix_x, pix_y = xs.reshape(-1), ys.reshape(-1)
    ptx = torch.div(pix_x, TILE_X, rounding_mode="floor").to(torch.int32)
    pty = torch.div(pix_y, TILE_Y, rounding_mode="floor").to(torch.int32)
    xy, conic = proj.means2d[order], proj.conic[order]
    opac = proj.opacity[order]
    rmin, rmax = proj.rect_min[order], proj.rect_max[order]
    dx = xy[:, 0:1] - pix_x[None, :]
    dy = xy[:, 1:2] - pix_y[None, :]
    power = (-0.5 * (conic[:, 0:1] * dx * dx + conic[:, 2:3] * dy * dy)
             - conic[:, 1:2] * dx * dy)
    alpha = torch.clamp_max(
        opac[:, None] * torch.exp(torch.clamp_max(power, 0.0)), 0.99)
    covers = ((ptx[None, :] >= rmin[:, 0:1]) & (ptx[None, :] < rmax[:, 0:1])
              & (pty[None, :] >= rmin[:, 1:2]) & (pty[None, :] < rmax[:, 1:2]))
    cand = (proj.visible[order][:, None] & covers & (power <= 0.0)
            & (alpha >= MIN_ALPHA))
    a = torch.where(cand, alpha, torch.zeros_like(alpha))
    accept = cand & (torch.cumsum(torch.log1p(-a), dim=0) >= LOG_TERM)
    inv = torch.argsort(order)
    count = accept.sum(dim=1).to(torch.int32)[inv]
    score = torch.where(accept, opac[:, None],
                        torch.zeros_like(alpha)).sum(dim=1)[inv]
    return count, score


def _segred_aux(settings: RasterSettings) -> bool:
    """Whether binning builds the segmented-reduction aux: the color and
    full backwards reduce per-pair grads with the segmented scan, the
    color_depth one with index_select's scatter-add (as the JAX package)."""
    return settings.outputs in ("full", "color")
