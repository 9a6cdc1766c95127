"""Differential refine ablation: the 50-step refine loop timed whole with
one stage removed at a time, and the differences.

    python -m igs_tpu_torch.tools.profile_refine_ablate [--n 150000]
        [--res 512] [--steps 50] [--views 18] [--rebin-every 5]
        [--device cpu]

Counterpart of ``tools/tools_profile_refine_ablate.py`` (150 000
Gaussians at 512², 18 views shifted along x, zero ground truths, colour
outputs on the packed route, a 2^19 pair budget, no densify). Variants,
each a loop over the steps: ``full`` (``refine_step``), ``no_ssim``
(the L1 loss alone: ``lambda_l1`` 1 and the SSIM replaced by a
constant, since an eager step would still compute a term weighted 0),
``no_stats`` (no densify statistics), ``no_adam`` (gradients, then the
positions nudged by 1e-6 × their gradient, no optimiser), ``fwd_l1``
(a render and its L1, no backward), ``fwd_only`` (a render),
``bin_only`` (projection and binning: ``build_pairs_packed``) and
``rebin`` (``refine_run`` with ``rebin_every``, the pair list reused
between rebuilds). The JAX probe needs the differential design because
XLA fuses and overlaps the stages inside its ``fori_loop``, so a stage
alone costs more than its share. The port's loop runs eager, one launch
after another, so the differences here sit close to each stage's
isolated cost; the design is kept so the two read alike.
"""

from __future__ import annotations

import sys
from dataclasses import replace

import torch

from igs_tpu_torch.ops.rasterize import build_pairs_packed, rasterize
from igs_tpu_torch.stream import refine as refine_mod
from igs_tpu_torch.stream.refine import (RefineConfig, loss_and_grads,
                                         refine_step)
from igs_tpu_torch.tools.probe import (Probe, RefineSetup, ms, parser,
                                       refine_args)
from igs_tpu_torch.train.losses import l1_loss


def variants(rs: RefineSetup, rebin_every: int):
    cfg = RefineConfig(use_densify=False)
    views = [(rs.cams.view(v), rs.gts[v]) for v in rs.order]

    def steps(state, **kw):
        c = kw.pop("cfg", cfg)
        for cam, gt in views:
            state, _ = refine_step(state, cam, gt, rs.bg, c, rs.settings,
                                   **kw)
        return state

    def no_ssim(state):
        saved = refine_mod.ssim
        refine_mod.ssim = lambda a, b: (torch.ones((), device=a.device),
                                        None)
        try:
            return steps(state, cfg=cfg._replace(lambda_l1=1.0))
        finally:
            refine_mod.ssim = saved

    def no_adam(state):
        g = state.gaussians
        acc = 0.0
        for cam, gt in views:
            _, grads, _, _, mse, _ = loss_and_grads(g, cam, gt, rs.bg, cfg,
                                                    rs.settings)
            g = replace(g, xyz=g.xyz - 1e-6 * grads["xyz"])
            acc = acc + mse
        return acc

    def forward(state, loss):
        g = state.gaussians
        acc = 0.0
        for cam, gt in views:
            img = rasterize(means3d=g.get_xyz, opacity=g.get_opacity,
                            scaling=g.get_scaling, rotation=g.get_rotation,
                            camera=cam, shs=g.shs, valid=g.valid,
                            settings=rs.settings)["color"]
            m = l1_loss(img, gt) if loss else torch.mean(img)
            g = replace(g, xyz=g.xyz + 1e-9 * m)
            acc = acc + m
        return acc

    def bin_only(state):
        g = state.gaussians
        acc = 0.0
        for cam, _ in views:
            pairs = build_pairs_packed(
                g.get_xyz, g.get_opacity, g.get_scaling, g.get_rotation,
                cam, valid=g.valid, settings=rs.settings)
            m = pairs.tile_count.sum().float() * 1e-9
            g = replace(g, xyz=g.xyz + 1e-12 * m)
            acc = acc + m
        return acc

    return {
        "full": steps,
        "no_ssim": no_ssim,
        "no_stats": lambda s: steps(s, do_densify_stats=False),
        "no_adam": no_adam,
        "fwd_l1": lambda s: forward(s, True),
        "fwd_only": lambda s: forward(s, False),
        "bin_only": bin_only,
        "rebin": rs.run(cfg._replace(rebin_every=rebin_every)),
    }


def main(argv=None) -> int:
    ap = parser(__doc__)
    refine_args(ap)
    ap.add_argument("--rebin-every", type=int, default=5)
    args = ap.parse_args(argv)
    pr = Probe("profile_refine_ablate", args)
    rs = RefineSetup(args, pr.dev)
    step = {}
    for name, fn in variants(rs, args.rebin_every).items():
        t = ms(fn, rs.state, K=args.K, iters=args.iters)
        step[name] = t / args.steps
        pr.put(name, {"loop_ms": t, "step_ms": step[name]})
    pr.put("differential_step_ms", {
        "ssim+grad": step["full"] - step["no_ssim"],
        "densify stats": step["full"] - step["no_stats"],
        "adam update": step["full"] - step["no_adam"],
        "backward total": step["no_adam"] - step["fwd_l1"],
        "l1 fwd": step["fwd_l1"] - step["fwd_only"],
        "fwd render": step["fwd_only"] - step["bin_only"],
        "projection+binning": step["bin_only"],
        f"rebin_every={args.rebin_every} saving":
            step["full"] - step["rebin"]}, "")
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
