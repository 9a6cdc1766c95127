"""Frame-0 per-scene 3DGS optimisation (RaDe-GS) and LightGaussian
compression.

Counterpart of ``igs_tpu/train/frame0.py`` (the reference's RaDe-GS
``train.py`` and LightGaussian ``prune.py``/``compress.py``, SURVEY.md
§3.5):
  * ``create_from_points``: 3DGS init from a sparse cloud (scale from the
    mean distance to the 3 nearest neighbours, opacity 0.1, SH DC from the
    colours), padded to a fixed capacity;
  * ``compute_3d_filter``: the RaDe-GS smoothing filter, min camera-space z
    over the covering cameras · √0.2 / the largest focal;
  * ``frame0_step``: 0.8·L1 + 0.2·(1−SSIM), optionally the depth-normal
    consistency term, then gated Adam (eps 1e-15, float32 bias correction)
    with the SH band warm-up; the screen-space gradient accumulates for
    densify;
  * ``frame0_densify_and_prune``: the refine's clone + split with
    ``percent_dense`` 0.01 (both branches fire), then the opacity, size and
    z-cull prunes;
  * ``lightgaussian_importance`` / ``prune_by_importance``: per-view
    contribution counts (``ops/rasterize.count_gaussians``, the count
    kernel on the card) weighted by the normalised volume, and the
    percentile prune.

Renders without the regulariser use the color-only blend: only the color
reaches that loss, and color mode packs 16 lanes instead of 32 (the JAX
package renders every output there). The regulariser renders ``full``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import (
    Gaussians, fuse_3d_filter, inverse_sigmoid)
from igs_tpu_torch.core.sh import rgb_to_sh
from igs_tpu_torch.ops.knn import knn
from igs_tpu_torch.ops.rasterize import (
    RasterSettings, count_gaussians, rasterize)
from igs_tpu_torch.stream import refine as refine_mod
from igs_tpu_torch.stream.refine import (
    TRAINABLE, RefineConfig, RefineState, bias_corrections, init_refine_state)
from igs_tpu_torch.train.losses import l1_loss, ssim
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.safe_math import safe_normalize

# SH band of each of the 16 coefficients (the warm-up unlocks one band per
# sh_warmup_interval steps)
SH_BAND = (0, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3)

class Frame0Config(NamedTuple):
    """RaDe-GS defaults (arguments/__init__.py:61-101)."""

    iterations: int = 6000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lambda_dssim: float = 0.2
    lambda_depth_normal: float = 0.05
    regularization_from_iter: int = 10_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densification_interval: int = 100
    densify_grad_threshold: float = 0.0002
    opacity_reset_interval: int = 3000
    min_opacity: float = 0.05
    percent_dense: float = 0.01
    kernel_size: float = 0.0
    sh_warmup_interval: int = 1000
    z_cull_min: Optional[float] = 4.5  # N3D loader z-cull (train.py:196-199)


def views(cameras: Camera) -> list:
    """The single cameras of a stack (``Camera.stack``), in order."""
    return [cameras.view(i)
            for i in range(cameras.world_view_transform.shape[0])]


def position_lr(step: int, cfg: Frame0Config,
                spatial_lr_scale: float) -> float:
    """The 3DGS exponential position-lr decay, in float32."""
    f32 = torch.float32
    t = torch.clamp(torch.tensor(step / cfg.position_lr_max_steps, dtype=f32),
                    0.0, 1.0)
    init = torch.tensor(cfg.position_lr_init * spatial_lr_scale, dtype=f32)
    final = torch.tensor(cfg.position_lr_final * spatial_lr_scale, dtype=f32)
    return float(torch.exp(torch.log(init) * (1 - t) + torch.log(final) * t))


def create_from_points(points: np.ndarray, colors: np.ndarray, capacity: int,
                       device=None) -> Gaussians:
    """3DGS init from a sparse point cloud (create_from_pcd): a uniform
    subset when there are more points than ``capacity``."""
    dev = resolve_device(device)
    points, colors = np.asarray(points), np.asarray(colors)
    if points.shape[0] > capacity:
        sel = np.linspace(0, points.shape[0] - 1, capacity).astype(int)
        points, colors = points[sel], colors[sel]
    n = points.shape[0]
    pts = torch.tensor(points.astype(np.float32), device=dev)
    d, _ = knn(pts, pts, 4)  # self + 3 neighbours
    dist2 = torch.mean(torch.square(d[:, 1:]), dim=1).clamp_min(1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    shs = torch.zeros((n, 16, 3), device=dev)
    shs[:, 0, :] = rgb_to_sh(torch.tensor(colors.astype(np.float32),
                                          device=dev))
    g = Gaussians(
        xyz=pts,
        opacity=torch.full((n, 1), float(inverse_sigmoid(0.1)), device=dev),
        rotation=torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(n, 1),
        scaling=scales, shs=shs,
        valid=torch.ones(n, dtype=torch.bool, device=dev))
    return g.pad_to(capacity)


def compute_3d_filter(xyz: torch.Tensor, valid: torch.Tensor,
                      cameras: Camera) -> torch.Tensor:
    """(N, 1) per-Gaussian low-pass filter size
    (scene/gaussian_model.py:181-235)."""
    n = xyz.shape[0]
    dev = xyz.device
    distance = torch.full((n,), 1e5, device=dev)
    valid_pt = torch.zeros(n, dtype=torch.bool, device=dev)
    focal_max = torch.zeros((), device=dev)
    for cam in views(cameras):
        wvt = cam.world_view_transform
        pc = xyz @ wvt[:3, :3] + wvt[3, :3]
        z = torch.clamp_min(pc[:, 2], 0.001)
        fx, fy = cam.focal_x, cam.focal_y
        x = pc[:, 0] / z * fx + cam.width / 2.0
        y = pc[:, 1] / z * fy + cam.height / 2.0
        in_screen = ((x >= -0.15 * cam.width) & (x <= 1.15 * cam.width)
                     & (y >= -0.15 * cam.height) & (y <= 1.15 * cam.height))
        ok = (pc[:, 2] > 0.2) & in_screen
        distance = torch.where(ok, torch.minimum(distance, z), distance)
        valid_pt = valid_pt | ok
        focal_max = torch.maximum(focal_max, fx)
    far = torch.amax(torch.where(valid_pt & valid, distance,
                                 torch.full_like(distance, -1e5)))
    distance = torch.where(valid_pt, distance, far)
    return (distance / focal_max * (0.2 ** 0.5))[:, None]


def fused_render_args(g: Gaussians, filter_3d: torch.Tensor):
    """Activated (scales, opacity) with the 3D filter fused, dead rows at
    opacity 0."""
    scales, opacity = fuse_3d_filter(g.scaling, g.opacity, filter_3d)
    opacity = torch.where(g.valid[:, None], opacity, torch.zeros_like(opacity))
    return scales, opacity


def depth_to_normal(depth: torch.Tensor, camera: Camera) -> torch.Tensor:
    """(H, W, 3) camera-space normals from a depth map: unproject along each
    pixel's ray, cross the central differences (a zero border)."""
    h, w = depth.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device),
        torch.arange(w, dtype=torch.float32, device=depth.device),
        indexing="ij")
    dirx = (xs - w / 2.0) / camera.focal_x
    diry = (ys - h / 2.0) / camera.focal_y
    pts = torch.stack([dirx * depth, diry * depth, depth], -1)
    dx = pts[:, 2:, :] - pts[:, :-2, :]
    dy = pts[2:, :, :] - pts[:-2, :, :]
    nrm = safe_normalize(torch.cross(dx[1:-1], dy[:, 1:-1], dim=-1))
    return F.pad(nrm, (0, 0, 1, 1, 1, 1))


def frame0_step(state: RefineState, camera: Camera, gt_image: torch.Tensor,
                bg: torch.Tensor, filter_3d: torch.Tensor, cfg: Frame0Config,
                settings: RasterSettings, step_pos_lr: float, reg_on: bool):
    """One RaDe-GS iteration (train.py:113-258) → (new state, loss as a
    device tensor). Adam runs over the five raw parameter groups; the
    densify statistics and the overflow code accumulate as in the refine.
    The render is ``full`` with the regulariser and ``color`` without."""
    g = state.gaussians
    params = {k: getattr(g, k).detach().requires_grad_(True)
              for k in TRAINABLE}
    m2o = torch.zeros((g.num_capacity, 2), device=g.xyz.device,
                      requires_grad=True)
    settings = settings._replace(outputs="full" if reg_on else "color")
    with torch.enable_grad():
        gg = replace(g, **params)
        scales, opacity = fused_render_args(gg, filter_3d)
        out = rasterize(
            means3d=gg.xyz, opacity=opacity, scaling=scales,
            rotation=gg.get_rotation, camera=camera, shs=gg.shs, bg=bg,
            means2d_offset=m2o, valid=gg.valid, settings=settings)
        img = out["color"]
        s, _ = ssim(img, gt_image)
        loss = ((1 - cfg.lambda_dssim) * l1_loss(img, gt_image)
                + cfg.lambda_dssim * (1.0 - s))
        if reg_on:
            n_exp = depth_to_normal(out["depth"], camera)
            n_med = depth_to_normal(out["mdepth"], camera)
            rn = out["normal"].permute(1, 2, 0)
            err_e = 1.0 - torch.sum(rn * n_exp, -1)
            err_m = 1.0 - torch.sum(rn * n_med, -1)
            depth_normal = 0.4 * torch.mean(err_e) + 0.6 * torch.mean(err_m)
            loss = loss + cfg.lambda_depth_normal * depth_normal
        grads = torch.autograd.grad(
            loss, [params[k] for k in TRAINABLE] + [m2o])
    grads, g_m2o = dict(zip(TRAINABLE, grads[:-1])), grads[-1]

    lrs = {"xyz": step_pos_lr, "rotation": cfg.rotation_lr,
           "shs": cfg.feature_lr, "opacity": cfg.opacity_lr,
           "scaling": cfg.scaling_lr}
    gate = g.valid.float()
    step = state.step + 1
    bc1, bc2 = bias_corrections(step, 0.9, 0.999)
    new_params, new_m, new_v = {}, {}, {}
    for name in TRAINABLE:
        p = getattr(g, name)
        gr = grads[name] * gate.reshape((-1,) + (1,) * (p.dim() - 1))
        if name == "shs":  # bands above the warm-up degree get no gradient
            deg = min(step // cfg.sh_warmup_interval, 3)
            band = torch.tensor(SH_BAND, device=p.device)
            gr = torch.where((band <= deg)[None, :, None], gr,
                             torch.zeros_like(gr))
        m = 0.9 * state.adam_m[name] + 0.1 * gr
        v = 0.999 * state.adam_v[name] + 0.001 * gr * gr
        new_params[name] = p - lrs[name] * (m / bc1) / (
            torch.sqrt(v / bc2) + 1e-15)
        new_m[name], new_v[name] = m, v

    radii = out["radii"]
    vis = (radii > 0) & g.valid
    zero = torch.zeros_like(state.denom)
    new_state = replace(
        state, gaussians=replace(g, **new_params), adam_m=new_m, adam_v=new_v,
        step=step,
        max_radii2d=torch.where(vis, torch.maximum(state.max_radii2d,
                                                   radii.float()),
                                state.max_radii2d),
        xyz_grad_accum=state.xyz_grad_accum + torch.where(
            vis, torch.linalg.norm(g_m2o, dim=-1), zero),
        denom=state.denom + vis.float(),
        overflow=torch.maximum(state.overflow,
                               out["overflow_tiles"].to(torch.int32)))
    return new_state, loss.detach()


def reset_opacity(state: RefineState) -> RefineState:
    """opacity ← min(opacity, 0.01) in σ space; its moments zeroed."""
    g = state.gaussians
    cap = inverse_sigmoid(0.01).to(g.opacity.device)
    m, v = dict(state.adam_m), dict(state.adam_v)
    m["opacity"] = torch.zeros_like(m["opacity"])
    v["opacity"] = torch.zeros_like(v["opacity"])
    return replace(state, gaussians=replace(
        g, opacity=torch.minimum(g.opacity, cap)), adam_m=m, adam_v=v)


def frame0_densify_and_prune(state: RefineState, cfg: Frame0Config,
                             extent: float, size_threshold: Optional[float],
                             samples=None) -> RefineState:
    """3DGS densify (clone small, split big) and prune: low opacity, then,
    with ``size_threshold``, oversized screen radii and world scales, and
    the N3D z-cull. ``samples``: the split draws, as for the refine's
    ``densify_and_prune``."""
    rcfg = RefineConfig(densify_grad_threshold=cfg.densify_grad_threshold,
                        min_opacity=cfg.min_opacity,
                        percent_dense=cfg.percent_dense)
    state = refine_mod.densify_and_prune(state, rcfg, extent, samples)
    g = state.gaussians
    keep = torch.ones_like(g.valid)
    if size_threshold is not None:
        keep &= state.max_radii2d <= size_threshold
        keep &= torch.amax(g.get_scaling, dim=1) <= 0.1 * extent
    if cfg.z_cull_min is not None:
        keep &= g.xyz[:, 2] >= cfg.z_cull_min
    return replace(state, gaussians=replace(g, valid=g.valid & keep))


def lightgaussian_importance(g: Gaussians, filter_3d: torch.Tensor,
                             cameras: Camera, settings: RasterSettings,
                             v_pow: float = 0.1) -> torch.Tensor:
    """v_imp_score over all training views (prune.py:112-157): the
    per-view count scores summed in view order, times (volume / the 90th
    percentile volume)^v_pow."""
    scales, opacity = fused_render_args(g, filter_3d)
    imp = torch.zeros(g.num_capacity, device=g.xyz.device)
    for cam in views(cameras):
        _, score = count_gaussians(g.xyz, opacity, scales, g.get_rotation,
                                   cam, valid=g.valid, settings=settings)
        imp = imp + score
    volume = torch.prod(scales, dim=1)
    sorted_v = torch.sort(torch.where(g.valid, volume,
                                      torch.zeros_like(volume))).values
    n_valid = int(g.valid.sum())
    # (0.9 · n_valid) in float32, truncated, as the JAX package computes it
    k90 = g.num_capacity - n_valid + int(
        torch.tensor(0.9, dtype=torch.float32) * float(n_valid))
    k90 = min(max(k90, 0), g.num_capacity - 1)
    v90 = torch.clamp_min(sorted_v[k90], 1e-12)
    return torch.pow(volume / v90, v_pow) * imp


def prune_by_importance(g: Gaussians, scores: torch.Tensor,
                        prune_percent: float) -> Gaussians:
    """Drop the lowest ``prune_percent`` of the live Gaussians by score
    (ties in index order, as a stable argsort)."""
    k = pruned_count(int(g.valid.sum()), prune_percent)
    masked = torch.where(g.valid, scores, torch.full_like(scores, np.inf))
    order = torch.argsort(masked, stable=True)
    kill = torch.zeros_like(g.valid)
    kill[order[:k]] = True
    return replace(g, valid=g.valid & ~kill)


def pruned_count(n_valid: int, prune_percent: float) -> int:
    """How many of ``n_valid`` live rows ``prune_by_importance`` drops:
    (prune_percent · n_valid) in float32, truncated."""
    return int(torch.tensor(prune_percent, dtype=torch.float32)
               * float(n_valid))


def state_from_numpy(gaussians: Gaussians, adam_m: Mapping[str, np.ndarray],
                     adam_v: Mapping[str, np.ndarray], step: int = 0,
                     max_radii2d=None, xyz_grad_accum=None, denom=None,
                     device=None) -> RefineState:
    """A ``RefineState`` from another implementation's state fields as
    numpy arrays (Adam moments by parameter name, step, densify
    statistics); fields left None start at zero."""
    dev = resolve_device(device)
    g = gaussians.to(dev)
    state = init_refine_state(g, g.num_capacity)

    def t(x, like):
        if x is None:
            return like
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return replace(
        state,
        adam_m={k: t(adam_m[k], None) for k in TRAINABLE},
        adam_v={k: t(adam_v[k], None) for k in TRAINABLE},
        step=int(step),
        max_radii2d=t(max_radii2d, state.max_radii2d),
        xyz_grad_accum=t(xyz_grad_accum, state.xyz_grad_accum),
        denom=t(denom, state.denom))
