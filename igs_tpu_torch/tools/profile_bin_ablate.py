"""Binning stage costs inside a 50-step loop, differential: projection
and the binning up to each stage, each step on the next of 18 views,
and on top a whole colour forward.

    python -m igs_tpu_torch.tools.profile_bin_ablate [--n 150000]
        [--res 512] [--steps 50] [--views 18] [--device cpu]

Counterpart of ``tools/tools_profile_bin_ablate.py`` (150 000 Gaussians
at 512², 18 views shifted along x, a 2^19 pair budget, a zero colour).
Variants up to: ``depthsort`` (the argsort), ``gathers`` (the depth
order with its gathers: ``binning.depth_order``), ``expand``
(``expand_pairs``), ``sort`` (``sort_pairs``), ``ranges``
(``tile_ranges``), ``aux`` (``segred_tables``: the whole binning), and
beyond the JAX probe ``render``: a colour forward through
``rasterize``, whose blend is the kernel B1, so the binning's share
reads against a whole forward. Each step feeds a scalar of its output
back into the positions, as the JAX loop does; ms a step from
``timeit_device`` (K=2, 3 rounds) over the whole loop. The port runs the
loop eager, so the differences sit close to the stages' isolated costs.
"""

from __future__ import annotations

import sys

import torch

from igs_tpu_torch.ops.binning import image_tile_grid
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.rasterize import rasterize
from igs_tpu_torch.tools.bench_binning import compose
from igs_tpu_torch.tools.probe import (Probe, RefineSetup, ms, parser,
                                       refine_args)

UPTO = ("depthsort", "gathers", "expand", "sort", "ranges", "aux", "render")
_COMPOSE = {"gathers": "depth_order", "expand": "expand", "sort": "sort",
            "ranges": "ranges", "aux": "aux"}


def _scalar(out) -> torch.Tensor:
    if isinstance(out, torch.Tensor):
        return out.sum().float()
    if hasattr(out, "tile_count"):
        return out.tile_count.sum().float() + out.gauss_id.sum().float()
    return sum(t.sum().float() for t in out)


def main(argv=None) -> int:
    ap = parser(__doc__)
    refine_args(ap)
    args = ap.parse_args(argv)
    pr = Probe("profile_bin_ablate", args)
    rs = RefineSetup(args, pr.dev)
    g = rs.g
    gx, gy = image_tile_grid(args.res, args.res)
    cams = [rs.cams.view(v) for v in rs.order]
    zero = torch.zeros_like(g.xyz)

    def stage(x, cam, upto):
        if upto == "render":
            return rasterize(means3d=x, opacity=g.get_opacity,
                             scaling=g.get_scaling, rotation=g.get_rotation,
                             camera=cam, shs=g.shs, valid=g.valid,
                             settings=rs.settings)["color"].mean()
        proj = project(x, g.get_scaling, g.get_rotation, g.get_opacity, cam,
                       colors_precomp=zero, valid=g.valid, geometry=False)
        if upto == "depthsort":
            key = torch.where(proj.visible, proj.depth,
                              torch.full_like(proj.depth, float("inf")))
            return _scalar(torch.argsort(key, dim=-1, stable=True))
        return _scalar(compose(proj, gx, gy, args.max_pairs,
                               _COMPOSE[upto]))

    for upto in UPTO:
        def loop(xyz, u=upto):
            acc = torch.zeros((), device=xyz.device)
            for cam in cams:
                s = stage(xyz, cam, u)
                xyz = xyz + 1e-12 * s
                acc = acc + s
            return acc + xyz[:4].sum()

        t = ms(loop, g.xyz, K=args.K, iters=args.iters)
        pr.put(f"upto {upto}", t / args.steps, "ms/step")
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
