"""The key-frame refine of ``chip_smoke.py``'s scene, in miniature, through
the JAX package and the port with the same split samples.

    JAX_PLATFORMS=cpu python -m tests.torch_port_refine_probe [--static-frac F]
        [--no-densify] [--port-only]

The miniature keeps what the refine sees in pixels: the resolution is
1014x1352 / 4, the Gaussians are 16x fewer and 4x larger (the same size on
screen and the same coverage), the motion and the position learning rate
are 4x larger (the same motion and step in pixels), and the densify
threshold is 4x larger (it bounds a gradient with respect to an NDC
offset). The carried Gaussians are frame 0 (an AGM-Net with random weights
predicts almost no motion), the ground truth is key frame 5's 13 training
views. The refine is the ``opt`` section of
``configs/synthetic_fullshape.yaml``: 50 steps, densify every 20.

Prints, for each package: the per-step losses, the mean of the first and
of the last five, the densify events and the eval view's PSNR before and
after the refine; then the largest relative difference of the two loss
curves. CPU minutes: about two for the port, three for JAX.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

import chip_smoke as smoke
from igs_tpu_torch.builders import build_stream_configs
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.stream import refine as tref

SHRINK = 4
KEY = 5
HW = (1014 // SHRINK, 1352 // SHRINK)
FOV = (smoke.FOV, smoke.FOV)
EXTENT = 3.0  # unused at percent_dense 0


def _scene(static_frac):
    n = smoke.N_GAUSSIANS // SHRINK ** 2
    kw = dict(motion_scale=0.15 * SHRINK, static_frac=static_frac,
              scale_range=(-5.0 + math.log(SHRINK), -3.8 + math.log(SHRINK)))
    return (smoke.scene_gaussians(0.0, n, **kw),
            smoke.scene_gaussians(0.4 * KEY, n, **kw))


def _refine_config(densify):
    opt = dict(smoke.OPT, use_densify=densify,
               densify_grad_threshold=smoke.OPT["densify_grad_threshold"]
               * SHRINK)
    opt["training_lr"] = dict(
        opt["training_lr"],
        position_lr_init=opt["training_lr"]["position_lr_init"] * SHRINK)
    stream, refine = build_stream_configs(opt)
    return refine, stream.refine_iterations


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--static-frac", type=float, default=0.3)
    ap.add_argument("--no-densify", action="store_true")
    ap.add_argument("--port-only", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(2)

    carried, target = _scene(args.static_frac)
    cfg, iters = _refine_config(not args.no_densify)
    settings = RasterSettings(image_height=HW[0], image_width=HW[1],
                              outputs="color", max_pairs=1 << 19)
    c2ws = smoke.make_cameras()
    views = [v for v in range(smoke.N_CAMS) if v != smoke.EVAL_VIEW]
    cams = Camera.stack([Camera.from_c2w(c2ws[v], FOV, HW, device="cpu")
                         for v in views])
    eval_cam = Camera.from_c2w(c2ws[smoke.EVAL_VIEW], FOV, HW, device="cpu")
    bg = torch.zeros(3)

    def render(g, cam):
        with torch.no_grad():
            out = rasterize(g.get_xyz, g.get_opacity, g.get_scaling,
                            g.get_rotation, cam, shs=g.shs, bg=bg,
                            valid=g.valid, settings=settings)
        if int(out["overflow_tiles"]):
            raise RuntimeError("render overflowed its pair budget")
        return torch.clamp(out["color"], 0, 1)

    def psnr(img, gt):
        return float(-10 * torch.log10(((img - gt) ** 2).mean()))

    truth = Gaussians.create(*target, device="cpu")
    # the dataset reads uint8 PNGs
    gts = torch.stack([(render(truth, cams.view(i)) * 255).to(torch.uint8)
                       .float() / 255 for i in range(len(views))])
    gt_eval = render(truth, eval_cam)
    g0 = Gaussians.create(*carried, device="cpu")
    capacity = g0.num_capacity * 5 // 4
    order = tref.view_order(iters, len(views))
    print(f"config: {cfg}")
    print(f"scene: {g0.num_capacity} Gaussians in {capacity} slots, static "
          f"fraction {args.static_frac}, {HW[0]}x{HW[1]}")

    # the port, with seeded split samples that JAX is fed too
    samples, events = [], []
    densify = tref.densify_and_prune

    def seeded_densify(state, c, extent):
        gen = torch.Generator().manual_seed(100 + len(samples))
        draws = tuple(torch.randn((capacity, 3), generator=gen)
                      for _ in range(2))
        samples.append(draws)
        g = state.gaussians
        mean_grad = torch.where(state.denom > 0, state.xyz_grad_accum
                                / state.denom.clamp_min(1.0),
                                torch.zeros_like(state.denom))
        selected = (mean_grad >= c.densify_grad_threshold) & g.valid
        n_static = int(g0.num_capacity * args.static_frac)  # rows first
        out = densify(state, c, extent, draws)
        events.append({
            "step": state.step, "live": int(g.valid.sum()),
            "free": int((~g.valid).sum()), "selected": int(selected.sum()),
            "selected_static": int(selected[:n_static].sum()),
            "live_after": int(out.gaussians.valid.sum())})
        return out

    tref.densify_and_prune = seeded_densify
    try:
        losses = []
        state = tref.refine_run(
            tref.init_refine_state(g0, capacity), cams, gts, order, bg, cfg,
            settings, EXTENT, iters,
            on_step=lambda it, st, m: losses.append(float(m["loss"])))
    finally:
        tref.densify_and_prune = densify
    print(f"eval PSNR before the refine {psnr(render(g0, eval_cam), gt_eval)}")
    _report("port", losses, events,
            psnr(render(state.gaussians, eval_cam), gt_eval))
    if args.port_only:
        return

    import jax
    import jax.numpy as jnp

    from igs_tpu.core.camera import Camera as JCamera
    from igs_tpu.core.gaussians import Gaussians as JGaussians
    from igs_tpu.ops.rasterize import RasterSettings as JSettings
    from igs_tpu.ops.rasterize import rasterize as jax_rasterize
    from igs_tpu.stream import refine as jref

    jset = JSettings(image_height=HW[0], image_width=HW[1],
                     impl="pallas_packed", pallas_interpret=True,
                     outputs="color", max_pairs=1 << 19)
    jcfg = jref.RefineConfig(**cfg._asdict())
    jcams = [JCamera.from_c2w(c2ws[v], FOV, HW) for v in views]
    step = jax.jit(lambda s, cam, gt: jref.refine_step(
        s, cam, gt, jnp.zeros(3), jcfg, jset))
    jstate = jref.init_refine_state(
        JGaussians.create(*[jnp.asarray(x) for x in carried]), capacity)
    normal = jax.random.normal
    fed = iter(samples)
    jlosses = []
    for it, v in enumerate(order):
        jstate, m = step(jstate, jcams[v], jnp.asarray(gts[v].numpy()))
        jlosses.append(float(m["loss"]))
        if tref._densify_now(cfg, it):
            draws = iter([jnp.asarray(x.numpy()) for x in next(fed)])
            # the JAX densify draws its two split samples with
            # jax.random.normal; hand it the port's instead
            jax.random.normal = lambda key, shape: next(draws)
            try:
                jstate = jref.densify_and_prune(jstate, jcfg,
                                                jnp.float32(EXTENT))
            finally:
                jax.random.normal = normal
    jg = jstate.gaussians
    img = jax_rasterize(
        means3d=jg.get_xyz, opacity=jg.get_opacity, scaling=jg.get_scaling,
        rotation=jg.get_rotation,
        camera=JCamera.from_c2w(c2ws[smoke.EVAL_VIEW], FOV, HW), shs=jg.shs,
        bg=jnp.zeros(3), valid=jg.valid, settings=jset)["color"]
    _report("jax", jlosses, [], psnr(
        torch.clamp(torch.tensor(np.asarray(img)), 0, 1), gt_eval))
    rel = np.abs(np.subtract(losses, jlosses)) / np.abs(jlosses)
    print(f"port vs jax: largest relative loss difference {rel.max():.3g}")


def _report(name, losses, events, psnr_after):
    print(f"{name}: losses {np.round(losses, 5).tolist()}")
    for e in events:
        print(f"{name}: densify {e}")
    print(f"{name}: mean loss first 5 {np.mean(losses[:5]):.5f}, last 5 "
          f"{np.mean(losses[-5:]):.5f}; eval PSNR after the refine "
          f"{psnr_after:.4f}")


if __name__ == "__main__":
    main()
