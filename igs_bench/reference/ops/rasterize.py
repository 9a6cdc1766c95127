"""The rasterizer in plain PyTorch: projection → the exact pair sort (no
budget: every pair of every tile) → the tile blend of ``render_tiles``.

It keeps the port's ``rasterize`` signature and outputs for the routes the
reference takes; there is no kernel, no pair budget, no per-tile window
and no shared pair list, so ``overflow_tiles`` is always 0. With
``outputs="color"`` only the color, the alpha and the contributor count
are blended, as the port's color mode; the other outputs are zero.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from igs_bench.reference import lowp
from igs_bench.reference.ops.binning import build_tile_pairs, image_tile_grid
from igs_bench.reference.ops.projection import ProjectedGaussians, project
from igs_bench.reference.ops.render_tiles import (
    pairs_to_idx_table, render_tiles)


class RasterSettings(NamedTuple):
    """The port's settings; the reference reads the image size, the SH
    degree, the filter, the outputs, the chunk and the gradient clamp."""

    image_height: int = 512
    image_width: int = 512
    sh_degree: int = 3
    kernel_size: float = 0.0
    scale_modifier: float = 1.0
    max_pairs: int = 2**21
    outputs: str = "full"
    impl: str = "tiles"
    max_per_tile: int = 4096
    chunk: int = 128
    binning: str = "sort"
    clamp_grads: bool = False
    clamp_value: float = 15.0


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
    live = [i for i, x in enumerate(xs) if x is not None and x.requires_grad]
    if not live:
        return xs
    out = list(xs)
    for i, y in zip(live, _ClampGrads.apply(value, *(xs[i] for i in live))):
        out[i] = y
    return tuple(out)


def rasterize(means3d, opacity, scaling, rotation, camera, shs=None,
              colors_precomp=None, bg=None, means2d_offset=None, valid=None,
              settings: RasterSettings = RasterSettings(),
              strip_row0: Optional[int] = None,
              pairs_override=None) -> dict:
    if strip_row0 is not None or pairs_override is not None:
        raise NotImplementedError("the reference renders whole images with "
                                  "exact pairs")
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
        raise ValueError(f"camera is {cam.height}x{cam.width}, settings "
                         f"{h}x{w}")
    proj = project(
        means3d, scaling, rotation, opacity, cam, shs=shs,
        colors_precomp=colors_precomp, sh_degree=settings.sh_degree,
        kernel_size=settings.kernel_size,
        scale_modifier=settings.scale_modifier, valid=valid,
        geometry=settings.outputs != "color")
    if means2d_offset is not None:
        scale = torch.tensor([0.5 * w, 0.5 * h], dtype=torch.float32,
                             device=dev)
        proj = proj._replace(means2d=proj.means2d + means2d_offset * scale)
    if lowp.active():
        proj = ProjectedGaussians(*(
            lowp.bf16(x) if x.is_floating_point() else x for x in proj))
    grid_x, grid_y = image_tile_grid(h, w)
    # every pair: the budget is the densest view's count
    touched = torch.where(proj.visible, proj.tiles_touched, 0)
    budget = max(1, int(touched.to(torch.int64).sum(1).max()))
    pairs = build_tile_pairs(proj, grid_x, grid_y, budget)
    width = max(1, int(pairs.tile_count.max()))
    width = -(-width // settings.chunk) * settings.chunk
    out = render_tiles(proj, pairs_to_idx_table(pairs, width), h, w,
                       cam.focal_x, cam.focal_y, bg, chunk=settings.chunk,
                       tile_count=pairs.tile_count,
                       color_only=settings.outputs == "color")
    views = proj.depth.shape[0]
    result = {
        "overflow_tiles": torch.zeros(views, dtype=torch.int32, device=dev),
        "color": out.color, "alpha": out.alpha, "coord": out.coord,
        "mcoord": out.mcoord, "depth": out.depth, "mdepth": out.mdepth,
        "normal": out.normal, "radii": proj.radius,
        "n_contrib": out.n_contrib,
    }
    if not batched:
        result = {k: v[0] for k, v in result.items()}
    return result
