"""Residual decoding, deformation and view rendering.

Counterpart of ``igs_tpu/models/renderer.py``: ``ResidualDecoder`` (MLP +
zero-init output heads, rotation bias (1, 1e-2, 1e-2, 1e-2)),
``interpolate_residuals``, ``render_views`` and ``deform_and_render``
(without the flow render).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional

import torch
from torch import nn

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.models.networks import MLP
from igs_tpu_torch.ops.anchors import AnchorState, interpolate_anchor_features
from igs_tpu_torch.ops.binning import TilePairs
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize

# output heads in the reference's out_layers order
HEADS = (("xyz", 3), ("rotation", 4))


class ResidualDecoder(nn.Module):
    """anchor/Gaussian feature (…, C) → {xyz (…, 3), rotation (…, 4)}."""

    def __init__(self, in_channels: int = 128, n_neurons: int = 128,
                 n_hidden_layers: int = 2):
        super().__init__()
        self.mlp_net = MLP(n_neurons, in_channels, n_neurons, n_hidden_layers)
        self.out_layers = nn.ModuleList(
            [nn.Linear(in_channels, ch) for _, ch in HEADS])

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        """Zero-init heads: at random init the deform is (near) identity."""
        for layer in self.out_layers:
            layer.weight.zero_()
            layer.bias.zero_()
        self.out_layers[1].bias.copy_(torch.tensor([1.0, 1e-2, 1e-2, 1e-2]))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = self.mlp_net(x)
        return {k: layer(x) for (k, _), layer in zip(HEADS, self.out_layers)}


def interpolate_residuals(anchor_feats: torch.Tensor,
                          state: AnchorState) -> torch.Tensor:
    """K-anchor weighted feature blend per Gaussian."""
    return interpolate_anchor_features(anchor_feats, state.weights,
                                       state.neighbor_idx)


def render_views(gaussians: Gaussians, cameras: Camera, bg: torch.Tensor,
                 settings: RasterSettings, parallel: bool = False,
                 pairs_override: Optional[TilePairs] = None
                 ) -> Dict[str, torch.Tensor]:
    """Render the stacked ``cameras`` (V views) of one Gaussians model.

    Returns images_pred (V, 3, H, W), depth_pred (V, H, W), alpha, normal
    and overflow_tiles (V,). ``parallel=True`` bins every view in one pass
    and blends them in one kernel launch (for many small renders, such as
    the 128² depth-carry views); otherwise the views render one by one.
    """
    def one(cam):
        out = rasterize(
            means3d=gaussians.get_xyz, opacity=gaussians.get_opacity,
            scaling=gaussians.get_scaling, rotation=gaussians.get_rotation,
            camera=cam, shs=gaussians.shs, bg=bg, valid=gaussians.valid,
            settings=settings, pairs_override=pairs_override)
        return {"images_pred": out["color"], "depth_pred": out["depth"],
                "alpha": out["alpha"], "normal": out["normal"],
                "overflow_tiles": out["overflow_tiles"]}

    if parallel:
        return one(cameras)
    views = cameras.world_view_transform.shape[0]
    outs = [one(Camera.stack([_view(cameras, i)])) for i in range(views)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def _view(cameras: Camera, i: int) -> Camera:
    return replace(cameras, **{
        f: getattr(cameras, f)[i]
        for f in ("world_view_transform", "full_proj_transform",
                  "camera_center", "tanfovx", "tanfovy")})


def deform_and_render(gaussians: Gaussians, residuals: Dict[str, torch.Tensor],
                      mask: torch.Tensor, cameras: Camera, bg: torch.Tensor,
                      settings: RasterSettings) -> Dict:
    """Deform one Gaussians model by its dense residuals, render ``cameras``."""
    gs = gaussians.deform(res_xyz=residuals["xyz"],
                          res_rotation=residuals.get("rotation"),
                          res_shs=residuals.get("shs"), mask=mask)
    out = render_views(gs, cameras, bg, settings)
    out["3dgs"] = gs
    return out
