"""AGM-Net — the anchor-driven Gaussian motion network.

Counterpart of ``igs_tpu/models/agm.py``: frozen GMFlow backbone →
1-layer motion transformer → 2× upsample + conv → ModLN 3D conditioning on
(rays, depth) → anchor projection + Transformer1D (GridEncoder) → residual
decode → deform → render. Parameter names are the reference torch model's
(``transformer.*``, ``upsample.*``, ``ModLN.*``, ``triplane_encoder.conv.*``,
``render.*``, and ``backbone.*`` for the GMFlow weights).

The same module serves streaming inference and training: gradients flow
through the renders to everything but the backbone, whose features are
detached unless ``train_backbone`` is set (the reference freezes its
pretrained GMFlow; without pretrained weights the JAX package's recipe
trains it end to end).

Three flags run parts of the network in bf16 (parameters stay float32):
``cnn_bf16`` the CNN encoder, ``ft_bf16`` the 6-layer feature
transformer's projections, ``encoder_bf16`` the anchor Transformer1D's
attention and feed-forward. The ModLN condition follows the motion
feature's type, and the decoded residuals are cast to float32 before the
deform, so the rasterizer and its kernels always take float32.

With ``render_flow`` the forward without ``depth_settings`` also renders
each output view's predicted 2D flow at ``flow_height`` × ``flow_width``
(``models/renderer.render_flow``; the reference's cfg.render_flow):
``flow_pred`` (B, V, 2, fh, fw) and ``flow_mask`` (B, V, fh, fw). It
renders through the clamp rasterizer in color mode on the same route as
the views; the streaming split (``depth_settings``) renders no flow, as
in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from igs_tpu_torch.core.camera import Camera, ray_to_plucker
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.core.sh import rsh_cart_3
from igs_tpu_torch.models.grid_encoder import GridEncoder
from igs_tpu_torch.models.networks import Conv, ModLN
from igs_tpu_torch.models.renderer import (
    ResidualDecoder, deform_and_render, interpolate_residuals, render_views)
from igs_tpu_torch.models.swin import FeatureTransformerMy
from igs_tpu_torch.models.unimatch import UniMatch
from igs_tpu_torch.ops.anchors import AnchorState
from igs_tpu_torch.ops.rasterize import RasterSettings, build_pairs_packed
from igs_tpu_torch.utils.profiling import span


class AGMNet(nn.Module):
    """The full IGS system module, for streaming inference and training."""

    def __init__(self, feature_channels: int = 128, backbone_layers: int = 6,
                 motion_layers: int = 1, up_sample: bool = True,
                 use_condition3d: bool = True, local_ray: bool = True,
                 fine_tune_backbone: bool = True, train_backbone: bool = False,
                 encoder_heads: int = 8, encoder_head_dim: int = 64,
                 encoder_layers: int = 4, attn_splits: int = 2,
                 encoder_bf16: bool = False, cnn_bf16: bool = False,
                 ft_bf16: bool = False, render_flow: bool = False,
                 flow_height: int = 1024, flow_width: int = 1352):
        super().__init__()
        self.render_flow = render_flow
        self.flow_height, self.flow_width = flow_height, flow_width
        bf16 = torch.bfloat16
        c = feature_channels
        self.up_sample = up_sample
        self.use_condition3d = use_condition3d
        self.local_ray = local_ray
        self.fine_tune_backbone = fine_tune_backbone
        self.train_backbone = train_backbone
        self.attn_splits = attn_splits
        self.backbone = UniMatch(c, backbone_layers, attn_splits=attn_splits,
                                 cnn_dtype=bf16 if cnn_bf16 else None,
                                 ft_dtype=bf16 if ft_bf16 else None)
        if fine_tune_backbone:
            self.transformer = FeatureTransformerMy(motion_layers, c)
        if up_sample:
            self.upsample = Conv(c, c, 3, padding=1)
        if use_condition3d:
            # condition: local ray dir (3) or degree-3 SH of the Plücker
            # direction and moment (32), plus depth
            self.ModLN = ModLN(c, mod_dim=4 if local_ray else 33)
        self.triplane_encoder = GridEncoder(
            c, encoder_heads, encoder_head_dim, encoder_layers,
            dtype=bf16 if encoder_bf16 else None)
        self.render = ResidualDecoder(in_channels=c, n_neurons=c)

    def motion_features(self, cur_images, next_images, cur_tile: int = 1):
        """(B·V, 3, H, W) ×2 → motion feature (B·V, C, h, w); the backbone
        features are detached unless ``train_backbone``."""
        with span("agm.backbone"):
            f0, f1 = self.backbone(cur_images, next_images,
                                   img0_tile=cur_tile)
        if not self.train_backbone:
            f0, f1 = f0.detach(), f1.detach()
        with span("agm.motion"):
            motion = (self.transformer(f0, f1,
                                       attn_num_splits=self.attn_splits)
                      if self.fine_tune_backbone else f0)
            if self.up_sample:
                motion = self.upsample(F.interpolate(
                    motion, scale_factor=2, mode="bilinear",
                    align_corners=False))
        return motion

    def condition3d(self, motion_feature, rays, depth):
        """ModLN(motion | rays + depth); depth (B, V, H, W) resized to the
        feature map bilinearly without antialiasing."""
        bv, c, h, w = motion_feature.shape
        b, v = depth.shape[:2]
        if self.local_ray:
            ray = torch.repeat_interleave(rays, v, dim=0)  # (B·V, h, w, 3)
        else:
            plucker = ray_to_plucker(rays)  # (B, V, h, w, 6)
            ray = torch.cat([rsh_cart_3(plucker[..., :3]),
                             rsh_cart_3(plucker[..., 3:6])], dim=-1)
            ray = ray.reshape(bv, h, w, 32)
        d = F.interpolate(depth.reshape(bv, 1, *depth.shape[2:]), size=(h, w),
                          mode="bilinear", align_corners=False)[:, 0]
        cond = torch.cat([ray, d[..., None]], dim=-1).to(motion_feature.dtype)
        x = self.ModLN(motion_feature.permute(0, 2, 3, 1), cond)
        return x.permute(0, 3, 1, 2)

    def forward(self, batch: Dict[str, Any], anchor_state: AnchorState,
                gaussians: Gaussians, settings: RasterSettings,
                depth_settings: Optional[RasterSettings] = None,
                shared_cur: bool = False, shared_window_pairs: bool = False,
                shared_pairs_drift_px: float = 8.0) -> Dict[str, Any]:
        """AGM-Net on a batch of B candidates.

        batch tensors (the collate() layout): cur_images_input /
        next_images_input (B, V, 3, H, W), depth (B, V, H, W), local_rays
        (B, h, w, 3) or rays (B, V, h, w, 6), FOV (B, 2), c2w_input
        (B, V, 4, 4), c2w_output (B, Vout, 4, 4), background_color (B, 3).
        ``anchor_state`` and ``gaussians`` carry a leading B axis.
        """
        b, v, c, hh, ww = batch["cur_images_input"].shape
        nxt = batch["next_images_input"].reshape(-1, c, hh, ww)
        if shared_cur and b > 1:
            # every candidate shares the key frame as cur: its CNN runs once
            motion = self.motion_features(batch["cur_images_input"][0], nxt,
                                          cur_tile=b)
        else:
            motion = self.motion_features(
                batch["cur_images_input"].reshape(-1, c, hh, ww), nxt)
        if self.use_condition3d:
            ray_key = "local_rays" if self.local_ray else "rays"
            with span("agm.condition"):
                motion = self.condition3d(motion, batch[ray_key],
                                          batch["depth"])

        with span("agm.triplane"):
            triplane = self.triplane_encoder(
                motion, anchor_state.anchor_points, batch["FOV"],
                batch["c2w_input"])  # (B, A, C)
        with span("agm.decode"):
            residuals = self.render(interpolate_residuals(triplane,
                                                          anchor_state))
            # the rasterizer takes float32 whatever the network computed in
            residuals = {k: r.float() for k, r in residuals.items()}
            gdefs = None if depth_settings is None else gaussians.deform(
                res_xyz=residuals["xyz"],
                res_rotation=residuals.get("rotation"),
                mask=anchor_state.mask)
        with span("agm.render"):
            fov = batch["FOV"]
            bgs = batch.get("background_color")
            if bgs is None:
                bgs = torch.zeros((b, 3), device=fov.device)
            c2w_out = batch["c2w_output"]

            def cams(c2ws, bi, s):
                return Camera.stack([
                    Camera.from_c2w(c2w, (fov[bi, 0], fov[bi, 1]),
                                    (s.image_height, s.image_width))
                    for c2w in c2ws])

            if depth_settings is None:
                # the flow renders at its own size, so its cameras (and the
                # focals that scale the flow to pixels) are rebuilt there
                flow = None
                if self.render_flow:
                    flow = settings._replace(
                        image_height=self.flow_height,
                        image_width=self.flow_width, outputs="color",
                        clamp_grads=True)
                outs = [deform_and_render(
                    gaussians.map(lambda x: x[bi]),
                    {k: r[bi] for k, r in residuals.items()},
                    anchor_state.mask[bi], cams(c2w_out[bi], bi, settings),
                    bgs[bi], settings, flow_settings=flow,
                    flow_cameras=None if flow is None else cams(
                        c2w_out[bi], bi, flow)) for bi in range(b)]
                out = {k: torch.stack([o[k] for o in outs])
                       for k in outs[0] if k != "3dgs"}
                out["3dgs"] = Gaussians.stack([o["3dgs"] for o in outs])
                out["motion_feature"] = triplane
                return out

            # streaming split: view 0 (eval) at full resolution, the
            # depth-carry views at depth_settings' resolution (they only feed
            # the /8-res ModLN conditioning)
            shared_pairs = pair_drift_frac = None
            if (shared_window_pairs and b > 1
                    and settings.impl == "pallas_packed"):
                # candidate 0's tile pair list serves every candidate's
                # eval render (same camera; per-candidate features stay
                # fresh); the other routes bin each candidate, as in the JAX
                # package
                g0 = gdefs.map(lambda x: x[0])
                cam0 = Camera.from_c2w(c2w_out[0, 0], (fov[0, 0], fov[0, 1]),
                                       (settings.image_height,
                                        settings.image_width))
                shared_pairs = build_pairs_packed(
                    g0.get_xyz, g0.get_opacity, g0.get_scaling,
                    g0.get_rotation, cam0, valid=g0.valid, settings=settings)
                # staleness signal: per candidate, the fraction of valid
                # Gaussians whose eval-view pixel moved more than the drift
                # threshold away from candidate 0's
                fpt = cam0.full_proj_transform
                ph = gdefs.get_xyz @ fpt[:3, :] + fpt[3, :]
                p = ph[..., :2] / (ph[..., 3:4] + 1e-7)
                xy = torch.stack(
                    [((p[..., 0] + 1) * settings.image_width - 1) * 0.5,
                     ((p[..., 1] + 1) * settings.image_height - 1) * 0.5], -1)
                drift = torch.linalg.norm(xy - xy[:1], dim=-1)  # (B, N)
                vmask = gdefs.valid
                moved = (drift > shared_pairs_drift_px) & vmask
                pair_drift_frac = moved.sum(-1) / torch.clamp_min(
                    vmask.sum(-1), 1)

            images, depth_eval, depth_carry, overflow = [], [], [], []
            for bi in range(b):
                gdef = gdefs.map(lambda x: x[bi])
                out0 = render_views(gdef,
                                    cams(c2w_out[bi, :1], bi, settings),
                                    bgs[bi], settings,
                                    pairs_override=shared_pairs)
                outd = render_views(gdef,
                                    cams(c2w_out[bi, 1:], bi, depth_settings),
                                    bgs[bi], depth_settings, parallel=True)
                images.append(out0["images_pred"])
                depth_eval.append(out0["depth_pred"])
                depth_carry.append(outd["depth_pred"])
                overflow.append(torch.maximum(out0["overflow_tiles"].max(),
                                              outd["overflow_tiles"].max()))
            out = {
                "images_pred": torch.stack(images),  # (B, 1, 3, H, W)
                "depth_pred_eval": torch.stack(depth_eval),  # (B, 1, H, W)
                "depth_pred": torch.stack(depth_carry),  # (B, V-1, h, w)
                "3dgs": gdefs,
                "overflow_tiles": torch.stack(overflow),
                "motion_feature": triplane,
            }
            if pair_drift_frac is not None:
                out["pair_drift_frac"] = pair_drift_frac
            return out
