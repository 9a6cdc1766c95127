"""Public differentiable rasterization API.

Counterpart of ``igs_tpu/ops/rasterize.py``: project → bin into tile
pairs → blend → untile, by one of four routes (``RasterSettings.impl``),
each used only when the caller names it:

- ``"pallas_packed"`` (the default) walks each tile's segment of the
  sorted pair list in place (``ops/blend.py``);
- ``"pallas"`` blends per-tile windows of ``max_per_tile`` rows
  (``ops/blend_windowed.py``), dropping the pairs past a tile's window;
- ``"tiles"`` is the JAX package's XLA tile renderer, in plain PyTorch
  (``ops/render_tiles.py``): the oracle of the two above, and the JAX
  package's route off a TPU;
- ``"reference"`` renders every pixel against every Gaussian
  (``ops/raster_ref.py``), for small scenes only.

On CUDA tensors the two kernel routes launch the hand-written blend
kernels and their backwards; on CPU tensors their plain versions. The
oracles run no kernel of their own. ``binning="compact"`` builds the
tile lists of ``"tiles"`` and ``"pallas"`` by compaction
(``ops/binning.build_tile_lists_compact``) instead of the pair sort.
Inputs follow the reference binding: activated opacity and scales,
normalized rotations, raw SH.

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
in one binning pass (and, on the kernel routes, one blend launch); the
outputs then keep the view axis. Truncation is surfaced, never hidden:
``overflow_tiles`` is, per view, the number of tiles past
``max_per_tile`` (``"pallas"`` and ``"tiles"`` with sort binning) plus
1<<20 when the view's pairs overflowed the pair budget; it is 0 for
``"reference"`` and for compact binning, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from igs_tpu_torch.ops.binning import (
    TilePairs, build_tile_lists_compact, build_tile_pairs, image_tile_grid)
from igs_tpu_torch.ops.blend import LOG_TERM, MIN_ALPHA, render_tiles_packed
from igs_tpu_torch.ops.blend_windowed import render_tiles_windowed
from igs_tpu_torch.ops.count import count_contributions_packed, count_rows
from igs_tpu_torch.ops.projection import TILE_X, TILE_Y, project
from igs_tpu_torch.ops.raster_ref import render_reference
from igs_tpu_torch.ops.render_tiles import pairs_to_idx_table, render_tiles

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
    # and counted in overflow_tiles); "tiles" / "reference" = the JAX
    # package's oracles in plain PyTorch
    impl: str = "pallas_packed"
    max_per_tile: int = 4096
    chunk: int = 128  # rows per chunk of the plain versions and "tiles"
    binning: str = "sort"  # "sort" | "compact" ("tiles" and "pallas")
    clamp_grads: bool = False
    clamp_value: float = 15.0


IMPLS = ("pallas_packed", "pallas", "tiles", "reference")
BINNINGS = ("sort", "compact")


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
    strip_row0: Optional[int] = None,
    pairs_override: Optional[TilePairs] = None,
) -> dict:
    """Render; returns the reference's outputs as a dict plus radii.

    ``strip_row0``: render only a strip of tile rows (the sharded refine's
    image split). The camera is the full image's; ``settings.image_height``
    is the strip's height, a whole number of 16-row tiles, and the strip
    starts at tile row ``strip_row0``. The projection moves into the
    strip's pixel space and each rect is clipped to its rows before
    binning, on every route, so a strip equals its rows of the full render
    (the pair sets decompose by tile row). As in the JAX package the
    ``means2d_offset`` NDC scale reads the strip's height (ROADMAP C33).

    ``pairs_override``: a caller-supplied (possibly stale) pair list from
    ``build_pairs_packed`` used instead of binning these Gaussians.
    """
    if (shs is None) == (colors_precomp is None):
        raise ValueError("provide exactly one of shs / colors_precomp")
    if settings.impl not in IMPLS:
        raise ValueError(f"impl={settings.impl!r}; the port has {IMPLS}")
    if settings.binning not in BINNINGS:
        raise ValueError(f"binning={settings.binning!r}; the port has "
                         f"{BINNINGS}")
    if pairs_override is not None and (settings.impl != "pallas_packed"
                                       or strip_row0 is not None):
        raise NotImplementedError("pairs_override requires "
                                  "impl='pallas_packed' without strip_row0")
    if strip_row0 is not None and settings.clamp_grads:
        # as the JAX package, whose clamp custom_vjp cannot carry the strip
        raise NotImplementedError("strip_row0 requires clamp_grads=False")
    if settings.clamp_grads:
        means3d, opacity, scaling, rotation, shs = _clamped(
            settings.clamp_value, means3d, opacity, scaling, rotation, shs)
    dev = means3d.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    batched = camera.world_view_transform.dim() == 3
    cam = camera.batched()
    h, w = settings.image_height, settings.image_width
    if strip_row0 is None:
        if (cam.height, cam.width) != (h, w):
            raise ValueError(f"camera is {cam.height}x{cam.width}, settings "
                             f"{h}x{w}")
    elif (h % TILE_Y or cam.width != w or strip_row0 < 0
          or strip_row0 * TILE_Y + h > cam.height):
        raise ValueError(f"strip of {h} rows at tile row {strip_row0} is not "
                         f"whole tiles inside the camera's {cam.height}x"
                         f"{cam.width} image (settings width {w})")
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
    if strip_row0 is not None:
        proj = to_strip(proj, strip_row0, h // TILE_Y)
    grid_x, grid_y = image_tile_grid(h, w)
    views, n = proj.depth.shape
    fx, fy = cam.focal_x, cam.focal_y
    if settings.impl == "reference":
        out = render_reference(proj, h, w, fx, fy, bg)
        overflow = torch.zeros(views, dtype=torch.int32, device=dev)
    elif settings.impl == "pallas_packed":
        # binning is always the pair sort here, as in the JAX package
        if pairs_override is not None:
            pairs = pairs_override
        else:
            pairs = build_tile_pairs(proj, grid_x, grid_y,
                                     settings.max_pairs,
                                     segred_aux=_segred_aux(settings))
        out = render_tiles_packed(proj, pairs, h, w, fx, fy, bg,
                                  mode=settings.outputs)
        overflow = torch.where(pairs.overflowed, OVERFLOW_CODE, 0)
    else:
        if settings.binning == "compact":
            pairs = _compact_pairs(proj, grid_x, grid_y,
                                   settings.max_per_tile)
            # the JAX package surfaces truncation on the sort route only
            overflow = torch.zeros(views, dtype=torch.int32, device=dev)
        else:
            pairs = build_tile_pairs(
                proj, grid_x, grid_y, settings.max_pairs,
                segred_aux=(settings.impl == "pallas"
                            and _segred_aux(settings)))
            truncated = pairs.tile_count.reshape(views, -1) \
                > settings.max_per_tile
            overflow = torch.where(pairs.overflowed, OVERFLOW_CODE, 0) \
                + truncated.sum(dim=1)
        if settings.impl == "pallas":
            out = render_tiles_windowed(proj, pairs, h, w, fx, fy, bg,
                                        settings.max_per_tile,
                                        mode=settings.outputs,
                                        chunk=settings.chunk)
        else:
            out = render_tiles(proj, pairs_to_idx_table(
                pairs, settings.max_per_tile), h, w, fx, fy, bg,
                chunk=settings.chunk)
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


def calibrate_pair_budget(means3d, opacity, scaling, rotation, camera,
                          valid=None,
                          settings: RasterSettings = RasterSettings(),
                          headroom: float = 1.25, quantum: int = 32768):
    """Right-size ``max_pairs`` to the scene: the measured pair count ×
    ``headroom``, rounded up to ``quantum``, at least ``quantum`` and
    capped at ``settings.max_pairs``. Every budget-sized stage pays for
    the budget, not the live pairs; overflow stays surfaced if the
    calibrated budget is ever exceeded. For a stacked camera the densest
    view counts. Returns (settings with the calibrated max_pairs, the
    measured pairs)."""
    pairs = build_pairs_packed(means3d, opacity, scaling, rotation, camera,
                               valid=valid, settings=settings)
    measured = int(pairs.num_pairs.max())
    budget = int(-(-(measured * headroom) // quantum) * quantum)
    budget = max(quantum, min(budget, settings.max_pairs))
    return settings._replace(max_pairs=budget), measured


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


def _compact_pairs(proj, grid_x: int, grid_y: int,
                   max_per_tile: int) -> TilePairs:
    """The compact binning's tile lists as a pair list whose tile t holds
    the rows t·max_per_tile … + count of the flattened table, so both the
    tile renderer and the windowed kernels read each list in place."""
    views, n = proj.depth.shape
    dev = proj.depth.device
    idx, counts = build_tile_lists_compact(proj, grid_x, grid_y,
                                           max_per_tile)
    # rows of the (V·N) flattened Gaussians, as the sort route's
    base = (torch.arange(views, dtype=torch.int32, device=dev) * n)[:, None,
                                                                      None]
    idx = torch.where(idx >= 0, idx + base, idx).reshape(-1)
    tiles = views * grid_x * grid_y
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    return TilePairs(
        gauss_id=idx, tile_id=torch.zeros(0, dtype=torch.int32, device=dev),
        num_pairs=counts.sum(1).to(torch.int32),
        tile_start=torch.arange(tiles, dtype=torch.int32, device=dev)
        * max_per_tile,
        tile_count=counts.reshape(-1),
        overflowed=torch.zeros(views, dtype=torch.bool, device=dev),
        exp_to_sorted=empty, exp_gauss_id=empty.to(torch.int32),
        gauss_last_row=empty)


def to_strip(proj, row0: int, rows: int):
    """The projection in the pixel space of the strip of ``rows`` tile rows
    from tile row ``row0``: means moved up by its first pixel row, rects
    clipped to its rows, and ``tiles_touched`` recounted."""
    rymin = torch.clamp(proj.rect_min[..., 1] - row0, 0, rows)
    rymax = torch.clamp(proj.rect_max[..., 1] - row0, 0, rows)
    tiles = (proj.rect_max[..., 0] - proj.rect_min[..., 0]) * (rymax - rymin)
    shift = torch.tensor([0.0, float(row0 * TILE_Y)],
                         device=proj.means2d.device)
    return proj._replace(
        means2d=proj.means2d - shift,
        rect_min=torch.stack([proj.rect_min[..., 0], rymin], -1),
        rect_max=torch.stack([proj.rect_max[..., 0], rymax], -1),
        tiles_touched=torch.where(proj.visible, tiles,
                                  torch.zeros_like(tiles)))


def _segred_aux(settings: RasterSettings) -> bool:
    """Whether binning builds the segmented-reduction aux: the color and
    full backwards reduce per-pair grads with the segmented scan, the
    color_depth one with index_select's scatter-add (as the JAX package)."""
    return settings.outputs in ("full", "color")
