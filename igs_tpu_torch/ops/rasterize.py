"""Public forward rasterization API.

Counterpart of the forward of ``igs_tpu/ops/rasterize.py`` with
``impl="pallas_packed"``: project → bin into tile pairs → packed blend →
untile. Inputs follow the reference binding: activated opacity and scales,
normalized rotations, raw SH. On CUDA tensors the blend is the
hand-written kernel; on CPU tensors its plain version.

A camera with a leading view axis (``Camera.stack``) renders every view
in one binning pass and one blend launch; the outputs then keep the view
axis. Overflow of the static pair budget is surfaced, never hidden: the
``overflow_tiles`` output is 1<<20 for a view whose pairs were truncated.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from igs_tpu_torch.ops.binning import (
    TilePairs, build_tile_pairs, image_tile_grid)
from igs_tpu_torch.ops.blend import render_tiles_packed
from igs_tpu_torch.ops.projection import project

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


def rasterize(
    means3d: torch.Tensor,
    opacity: torch.Tensor,
    scaling: torch.Tensor,
    rotation: torch.Tensor,
    camera,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    bg: Optional[torch.Tensor] = None,
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
    grid_x, grid_y = image_tile_grid(h, w)
    if pairs_override is not None:
        pairs = pairs_override
    else:
        pairs = build_tile_pairs(proj, grid_x, grid_y, settings.max_pairs)
    out = render_tiles_packed(proj, pairs, h, w, cam.focal_x, cam.focal_y, bg,
                              mode=settings.outputs)
    overflow = torch.where(pairs.overflowed, OVERFLOW_CODE, 0).to(torch.int32)
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
    return build_tile_pairs(proj, grid_x, grid_y, settings.max_pairs)
