"""Stage-level profiler of the streaming window: the refine step and the
AGM-Net forward, stage by stage.

    python -m igs_tpu_torch.profile_stages [--what refine|agm|all]
        [--device cpu] [--out PATH]

Counterpart of the repo's ``profile_stages.py``, on its scene (150 000
Gaussians from ``RandomState(0)``, one 512² camera) with its output keys.
Each stage is a function timed with ``timeit_device`` (salt 1e-6):

  refine: ``refine/project_fwd_s`` (projection), ``refine/binning_s``
    (pair build + ``pairs_to_idx_table``), ``refine/packed_binning_s``
    (pair build + ``pack_features`` + the row gather the packed route
    runs), ``refine/raster_fwd_s`` (color mode), ``refine/raster_fwd_bwd_s``
    (mean |color| to all five parameters), ``refine/ssim_l1_grad_s`` (at
    ``res``²) and ``refine/full_step_s`` (one ``refine_step``);
  agm (B=5, 4 input views at 512², ``torch.inference_mode``):
    ``agm/cnn_encoder_s`` (the CNN on the 40 images),
    ``agm/feature_transformer_s`` (6 layers), ``agm/motion_transformer_s``
    (1 layer), ``agm/motion_features_s``, ``agm/condition3d_s``,
    ``agm/triplane_encoder_s``, ``agm/interp_decode_s`` and
    ``agm/renders_s`` (5 × (1 eval + 4 depth-carry views)).

Deviations from the JAX script: ``--cnn-bf16`` raises (ROADMAP A7);
anchor selection uses exact KNN (ROADMAP C1); ``--out`` defaults to
``logs/igs_tpu_torch/profile_stages.json``. Results print as JSON and go
to ``--out``; the kernels' launch counts go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import replace

import numpy as np
import torch

from igs_tpu_torch.builders import build_model
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.models.renderer import interpolate_residuals, render_views
from igs_tpu_torch.ops.anchors import select_anchors
from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
from igs_tpu_torch.ops.blend import pack_features
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.ops.render_tiles import pairs_to_idx_table
from igs_tpu_torch.roofline import agm_batch, scene, windowed
from igs_tpu_torch.stream.refine import (
    RefineConfig, init_refine_state, refine_step)
from igs_tpu_torch.train.losses import l1_loss, ssim
from igs_tpu_torch.utils.devtime import timeit_device
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.profiling import kernel_launches

DEFAULT_OUT = os.path.join("logs", "igs_tpu_torch", "profile_stages.json")


def stage_timeit(fn, args, K=8, iters=3):
    return timeit_device(fn, *args, K=K, iters=iters, salt_scale=1e-6)


def refine_stages(g, cam, settings, rng, dev) -> dict:
    res = settings.image_height
    n = g.num_capacity
    results = {}

    def proj_fn(x):
        return project(x, g.get_scaling, g.get_rotation, g.get_opacity, cam,
                       shs=g.shs, sh_degree=3, kernel_size=0.0,
                       valid=g.valid)

    results["refine/project_fwd_s"] = stage_timeit(proj_fn, (g.xyz,))
    proj = proj_fn(g.xyz)
    gx, gy = image_tile_grid(res, res)

    def binning(m2d):
        pairs = build_tile_pairs(proj._replace(means2d=m2d), gx, gy,
                                 settings.max_pairs)
        return (pairs_to_idx_table(pairs, settings.max_per_tile),
                pairs.tile_count)

    results["refine/binning_s"] = stage_timeit(binning, (proj.means2d,))

    def packed_binning(m2d):
        p = proj._replace(means2d=m2d)
        pairs = build_tile_pairs(p, gx, gy, settings.max_pairs)
        rows = pack_features(p).reshape(-1, 32).t().contiguous()
        return (rows.index_select(1, pairs.gauss_id.clamp_min(0).long()),
                pairs.tile_start)

    results["refine/packed_binning_s"] = stage_timeit(
        packed_binning, (proj.means2d,))

    def fwd(x):
        return rasterize(means3d=x, opacity=g.get_opacity,
                         scaling=g.get_scaling, rotation=g.get_rotation,
                         camera=cam, shs=g.shs, valid=g.valid,
                         settings=settings)["color"]

    results["refine/raster_fwd_s"] = stage_timeit(fwd, (g.xyz,))

    def fwd_bwd(*params):
        params = [p.detach().requires_grad_(True) for p in params]
        x, op, sc, ro, sh = params
        out = rasterize(means3d=x, opacity=op, scaling=sc, rotation=ro,
                        camera=cam, shs=sh, valid=g.valid, settings=settings)
        return torch.autograd.grad(torch.mean(torch.abs(out["color"])),
                                   params)

    results["refine/raster_fwd_bwd_s"] = stage_timeit(
        fwd_bwd, (g.xyz, g.get_opacity, g.get_scaling, g.get_rotation,
                  g.shs))

    img = torch.as_tensor(rng.uniform(0, 1, (3, res, res)),
                          dtype=torch.float32, device=dev)
    gt = torch.as_tensor(rng.uniform(0, 1, (3, res, res)),
                         dtype=torch.float32, device=dev)

    def ssim_l1_grad(a, b):
        a = a.detach().requires_grad_(True)
        s, _ = ssim(a, b)
        return torch.autograd.grad(0.8 * l1_loss(a, b) + 0.2 * (1 - s), a)

    results["refine/ssim_l1_grad_s"] = stage_timeit(ssim_l1_grad, (img, gt),
                                                    K=16)

    state = init_refine_state(g, capacity=n)
    rcfg = RefineConfig()
    bg = torch.zeros(3, device=dev)

    def full_step(xyz, st):
        st = replace(st, gaussians=replace(st.gaussians, xyz=xyz))
        st2, _ = refine_step(st, cam, gt, bg, rcfg, settings)
        return st2.gaussians.xyz

    results["refine/full_step_s"] = stage_timeit(full_step, (g.xyz, state),
                                                 K=4)
    return results


def agm_stages(g, settings, rng, dev, batch: int, hw: int, anchors: int,
               depth_res: int, system) -> dict:
    b = batch
    model = build_model(system or {}, device=dev)
    bbox = torch.tensor([[-2.0, -2, -2], [2.0, 2, 2]], device=dev)
    with torch.inference_mode():
        state1 = select_anchors(g.xyz, bbox, valid=g.valid,
                                anchor_size=anchors, k=8)
    astate, gb = windowed(state1, g, b)
    bt = agm_batch(b, hw, rng, dev)
    agm_settings = settings._replace(clamp_grads=True, outputs="color")
    depth_settings = agm_settings._replace(
        image_height=depth_res, image_width=depth_res, max_pairs=1 << 18,
        max_per_tile=512, outputs="color_depth")
    cur = bt["cur_images_input"].reshape(-1, 3, hw, hw)
    nxt = bt["next_images_input"].reshape(-1, 3, hw, hw)
    results = {}

    def inference(fn):
        def run(*a):
            with torch.inference_mode():
                return fn(*a)
        return run

    # the CNN encoder on the 2·B·4 images
    concat = torch.cat([cur, nxt], dim=0)
    cnn = inference(model.backbone.backbone)
    results["agm/cnn_encoder_s"] = stage_timeit(cnn, (concat,), K=4)
    f0, f1 = cnn(concat).chunk(2, dim=0)

    # the 6-layer feature transformer and the 1-layer motion transformer
    ft = inference(lambda a, b2: model.backbone.transformer(
        a, b2, attn_num_splits=2))
    results["agm/feature_transformer_s"] = stage_timeit(ft, (f0, f1), K=4)
    mt = inference(lambda a, b2: model.transformer(a, b2, attn_num_splits=2))
    results["agm/motion_transformer_s"] = stage_timeit(mt, (f0, f1), K=4)

    # backbone + motion transformer + upsample
    motion_fn = inference(model.motion_features)
    results["agm/motion_features_s"] = stage_timeit(motion_fn, (cur, nxt),
                                                    K=4)
    motion = motion_fn(cur, nxt)

    cond_fn = inference(lambda mo: model.condition3d(
        mo, bt["local_rays"], bt["depth"]))
    results["agm/condition3d_s"] = stage_timeit(cond_fn, (motion,), K=8)
    cond = cond_fn(motion)

    # anchor projection + Transformer1D
    tri_fn = inference(lambda mo: model.triplane_encoder(
        mo, astate.anchor_points, bt["FOV"], bt["c2w_input"]))
    results["agm/triplane_encoder_s"] = stage_timeit(tri_fn, (cond,), K=4)
    tri = tri_fn(cond)

    dec_fn = inference(lambda t: model.render(interpolate_residuals(
        t, astate)))
    results["agm/interp_decode_s"] = stage_timeit(dec_fn, (tri,), K=8)
    res_dec = dec_fn(tri)

    def renders(resid_xyz):
        images, depths = [], []
        for bi in range(b):
            gdef = gb.map(lambda x: x[bi]).deform(
                res_xyz=resid_xyz[bi], res_rotation=res_dec["rotation"][bi],
                mask=astate.mask[bi])
            fov = (bt["FOV"][bi, 0], bt["FOV"][bi, 1])
            c2ws = bt["c2w_output"][bi]
            cam0 = Camera.stack([Camera.from_c2w(
                c2ws[0], fov, (agm_settings.image_height,
                               agm_settings.image_width))])
            out0 = render_views(gdef, cam0, bt["background_color"][bi],
                                agm_settings)
            camsd = Camera.stack([Camera.from_c2w(
                c, fov, (depth_settings.image_height,
                         depth_settings.image_width)) for c in c2ws[1:]])
            outd = render_views(gdef, camsd, bt["background_color"][bi],
                                depth_settings, parallel=True)
            images.append(out0["images_pred"])
            depths.append(outd["depth_pred"])
        return torch.stack(images), torch.stack(depths)

    results["agm/renders_s"] = stage_timeit(inference(renders),
                                            (res_dec["xyz"],), K=4)
    return results


def run(what: str = "all", n_gaussians: int = 150_000, res: int = 512,
        batch: int = 5, cnn_bf16: bool = False, device=None, hw: int = 512,
        anchors: int = 8192, depth_res: int = 128, system=None) -> dict:
    """The JAX script's results dict; ``hw`` (the AGM input resolution),
    ``anchors`` and ``depth_res`` are the JAX script's constants, and
    ``system`` the model's config section (AGMNet defaults when None)."""
    if cnn_bf16:
        raise NotImplementedError("the bf16 compute flags are not ported "
                                  "(ROADMAP A7)")
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    g = scene(n_gaussians, rng, dev)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 5.0
    cam = Camera.from_w2c(w2c, 0.9, 0.9, height=res, width=res, device=dev)
    settings = RasterSettings(
        image_height=res, image_width=res, impl="pallas_packed",
        max_pairs=1 << 19, max_per_tile=1024, chunk=256, outputs="color",
        clamp_grads=False)
    results = {}
    if what in ("refine", "all"):
        results.update(refine_stages(g, cam, settings, rng, dev))
    if what in ("agm", "all"):
        results.update(agm_stages(g, settings, rng, dev, batch, hw, anchors,
                                  depth_res, system))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", default="all", choices=["refine", "agm", "all"])
    ap.add_argument("--n-gaussians", type=int, default=150_000)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--cnn-bf16", action="store_true",
                    help="not ported (ROADMAP A7): raises")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    config = vars(args)
    out = config.pop("out")
    results = run(**config)
    print(json.dumps(results, indent=2), flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"kernel launches {json.dumps(kernel_launches())}",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
