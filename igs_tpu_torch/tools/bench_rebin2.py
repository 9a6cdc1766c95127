"""The ceiling of pair caching in the refine loop: every view's pair list
built once before the loop and read only, against the exact loop and
the projection alone (a probe of the cache the TPU rounds rejected, kept
as the evidence trail).

    python -m igs_tpu_torch.tools.bench_rebin2 [--n 150000] [--res 512]
        [--steps 50] [--views 18] [--device cpu]

Counterpart of ``tools/tools_bench_rebin2.py``: ``bench_rebin``'s scene
and real targets, the 18 views shifted along x only, densify off. Three
loops over the 50 steps, each timed by ``timeit_device`` (K=2, 3
rounds), under the JAX probe's names:

* ``exact``: ``refine_step`` binning every step;
* ``frozen``: the 18 lists built first from the starting state
  (``ops/rasterize.build_pairs_packed``, inside the timed call), then
  each step's ``refine_step(..., pairs_override=)`` reads its view's
  list (the staleness is the whole loop);
* ``proj_only``: the projection alone in context
  (``ops/projection.project(..., geometry=False)``, a step's means nudged
  by a scalar of the last projection so no step is dead code).

``exact`` and ``frozen`` also record the quality drift: view 0 of the
final state against its target (``psnr_v0``, dB). The loops launch B1
(colour), B2 and B3.
"""

from __future__ import annotations

import sys
from dataclasses import replace

import torch

from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.rasterize import build_pairs_packed
from igs_tpu_torch.stream.refine import RefineConfig, refine_step
from igs_tpu_torch.tools.bench_rebin import RebinSetup, timed_loop
from igs_tpu_torch.tools.probe import Probe, parser, refine_args

CFG = RefineConfig(use_densify=False)


def build_view(rs: RebinSetup, g, v: int):
    """View ``v``'s pair list of ``g``, as the refine loop builds it."""
    return build_pairs_packed(g.get_xyz, g.get_opacity, g.get_scaling,
                              g.get_rotation, rs.cams.view(v), valid=g.valid,
                              settings=rs.settings)


def prebuild(rs: RebinSetup, g) -> list:
    return [build_view(rs, g, v) for v in range(rs.gts.shape[0])]


def step(rs: RebinSetup, state, it: int, pairs=None):
    v = rs.order[it]
    return refine_step(state, rs.cams.view(v), rs.gts[v], rs.bg, CFG,
                       rs.settings, pairs_override=pairs)[0]


def loop_exact(rs: RebinSetup):
    def run(state):
        for it in range(rs.steps):
            state = step(rs, state, it)
        return state
    return run


def loop_frozen(rs: RebinSetup):
    def run(state):
        stack = prebuild(rs, state.gaussians)
        for it in range(rs.steps):
            state = step(rs, state, it, stack[rs.order[it]])
        return state
    return run


def loop_proj_only(rs: RebinSetup):
    def run(state):
        g = state.gaussians
        n = g.xyz.shape[0]
        zeros = torch.zeros((n, 3), device=g.xyz.device)
        acc = torch.zeros((), device=g.xyz.device)
        for it in range(rs.steps):
            proj = project(g.get_xyz, g.get_scaling, g.get_rotation,
                           g.get_opacity, rs.cams.view(rs.order[it]),
                           colors_precomp=zeros, valid=g.valid,
                           geometry=False)
            m = torch.sum(proj.depth) * 1e-9
            g = replace(g, xyz=g.xyz + 1e-12 * m)
            acc = acc + m
        return acc + torch.sum(g.xyz[:8])
    return run


def main(argv=None) -> int:
    ap = parser(__doc__)
    refine_args(ap)
    args = ap.parse_args(argv)
    pr = Probe("bench_rebin2", args)
    rs = RebinSetup(args, pr.dev, y_shift=False)
    timed_loop(pr, rs, "exact", loop_exact(rs), args)
    timed_loop(pr, rs, "frozen", loop_frozen(rs), args)
    timed_loop(pr, rs, "proj_only", loop_proj_only(rs), args, quality=False)
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
