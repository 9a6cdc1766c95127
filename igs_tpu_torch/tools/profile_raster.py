"""Stage split of the packed rasterizer at the production shape, forward
and backward, plus a ``torch.profiler`` trace of one forward+backward.

    python -m igs_tpu_torch.tools.profile_raster [--n 150000] [--res 512]
        [--mode color|full] [--K 32] [--device cpu]

Counterpart of ``tools/tools_profile_raster.py`` (150 000 Gaussians at
512², a 2^19 pair budget, colour mode). Stages, each timed alone with
``timeit_device`` on the inputs the stage before it made: the projection
(``project_fwd``), the binning with the segmented-reduction aux
(``binning``), the pair gather into the (lanes, pairs) layout
(``pair_gather_T``), the forward kernel B1 alone (``blend_fwd_kernel``),
raw → outputs, the backward kernel B2 alone (``blend_bwd_kernel``; the
TPU probe could time only forward+backward and subtract), the gather's
transpose the port runs, B3's chain (``segred_chain``: the inverse
permutation and ``segment_sum_sorted``), beside the scatter-add it
replaces (``scatter_add_T``, ``index_add_``), and the projection's
backward (``project_bwd``). The JAX probe's ``jax.profiler`` trace
becomes a ``torch.profiler`` trace of one forward+backward through
``rasterize``, written beside the JSON (``<out>_trace/trace.json``),
whose ten largest operators by self time the JSON also lists.
"""

from __future__ import annotations

import os
import sys

import torch

from igs_tpu_torch.ops import blend
from igs_tpu_torch.ops.binning import build_tile_pairs
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.ops.segred import segment_sum_sorted
from igs_tpu_torch.tools.probe import (OUT_DIR, Probe, camera, ms,
                                       packed_inputs, parser, render_grads,
                                       scene)
from igs_tpu_torch.utils.profiling import trace


def top_ops(prof, n=10):
    """The ``n`` operators with the largest self time (device time on a
    card, CPU time otherwise), in ms."""
    cuda = torch.cuda.is_available()
    rows = []
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", 0) if cuda
             else e.self_cpu_time_total)
        rows.append((e.key, t / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return [{"op": k, "self_ms": t, "calls": c} for k, t, c in rows[:n]]


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--mode", default="color", choices=["color", "full"])
    ap.add_argument("--K", type=int, default=32)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--max-pairs", type=int, default=1 << 19)
    args = ap.parse_args(argv)
    pr = Probe("profile_raster", args)
    g = scene(args.n, pr.dev)
    cam = camera(args.res, pr.dev)
    mode, mp = args.mode, args.max_pairs
    geometry = mode != "color"
    proj, pairs, feats_t, gx, gy = packed_inputs(g, cam, mode, mp)
    lanes = feats_t.shape[0]
    bg = torch.zeros(3, device=pr.dev)
    k = dict(K=args.K, iters=args.iters)

    def f_project(xyz):
        return project(xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                       cam, shs=g.shs, valid=g.valid, geometry=geometry)

    def f_gather(rows):
        return torch.index_select(rows, 1, pairs.gauss_id.clamp_min(0).long())

    def f_fwd(ft):
        return blend._blend_fwd(ft, pairs.tile_start, pairs.tile_count, gx,
                                gy, mode)

    raw = f_fwd(feats_t)

    def f_outputs(r):
        if mode == "color":
            return blend.raw_to_outputs_color(r, 1, gx, gy, args.res,
                                              args.res, bg)
        return blend.raw_to_outputs(r, 1, gx, gy, args.res, args.res,
                                    cam.focal_x, cam.focal_y, bg)

    gen = torch.Generator(device="cpu").manual_seed(0)
    cot = (1e-3 * torch.randn(raw.shape, generator=gen)).to(pr.dev)

    def f_bwd(ft):
        return blend.blend_raw_packed_bwd(ft, pairs.tile_start,
                                          pairs.tile_count, gx, gy, mode,
                                          raw, cot)

    dfeats = f_bwd(feats_t)
    n_rows = proj.depth.numel()

    def f_segred(d):
        d_exp = torch.index_select(d, 1, pairs.exp_to_sorted)
        return segment_sum_sorted(d_exp, pairs.exp_gauss_id,
                                  pairs.gauss_last_row)

    def f_scatter(d):
        return torch.zeros((lanes, n_rows), device=d.device).index_add_(
            1, pairs.gauss_id.clamp_min(0).long(), d)

    def f_proj_bwd(x):
        # the projection's VJP for a cotangent of 1e-3 on each output
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            o = [t for t in f_project(x) if t.requires_grad]
            return torch.autograd.grad(
                o, [x], [torch.full_like(t, 1e-3) for t in o])

    rows = blend.pack_features(proj)[..., :lanes].reshape(-1, lanes).t(
        ).contiguous()
    stages = {
        "project_fwd": ms(f_project, g.xyz, **k),
        "binning": ms(lambda p: build_tile_pairs(p, gx, gy, mp,
                                                 segred_aux=True), proj, **k),
        "pair_gather_T": ms(f_gather, rows, **k),
        "blend_fwd_kernel": ms(f_fwd, feats_t, **k),
        "raw_to_outputs": ms(f_outputs, raw, **k),
        "blend_bwd_kernel": ms(f_bwd, feats_t, **k),
        "segred_chain": ms(f_segred, dfeats, **k),
        "scatter_add_T": ms(f_scatter, dfeats, **k),
        "project_bwd": ms(f_proj_bwd, g.xyz, **k),
    }
    for name, t in stages.items():
        pr.put(name, t)
    pr.put("live_pairs", int(pairs.tile_count.sum()), "")
    settings = RasterSettings(image_height=args.res, image_width=args.res,
                              impl="pallas_packed", max_pairs=mp,
                              outputs=mode, clamp_grads=False)
    grads = render_grads(g, cam, settings, depth_term=mode != "color")
    params = (g.xyz, g.opacity, g.scaling, g.rotation, g.shs)
    grads(*params)  # warm
    base = os.path.splitext(args.out or os.path.join(
        OUT_DIR, "profile_raster.json"))[0]
    with trace(base + "_trace") as prof:
        grads(*params)
        if pr.dev.type == "cuda":
            torch.cuda.synchronize()
    pr.put("trace", os.path.join(base + "_trace", "trace.json"), "")
    pr.put("top_ops", top_ops(prof), "")
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
