"""The refine loop's cost with and without densification, as one call of
``refine_run`` over 50 steps.

    python -m igs_tpu_torch.tools.bench_refine_loop [--n 150000]
        [--res 512] [--steps 50] [--views 18] [--device cpu]

Counterpart of ``tools/tools_bench_refine_loop.py`` (150 000 Gaussians
at 512², capacity 150 000, the bench camera repeated for 18 views, zero
ground truths, colour outputs on the packed route, a 2^19 pair budget,
extent 3). Per setting of ``use_densify`` the loop's ms and ms a step,
from ``timeit_device`` (K=2, 3 rounds: each call is the whole loop on a
fresh copy of the state).
"""

from __future__ import annotations

import sys

from igs_tpu_torch.stream.refine import RefineConfig
from igs_tpu_torch.tools.probe import (Probe, RefineSetup, ms, parser,
                                       refine_args)


def main(argv=None) -> int:
    ap = parser(__doc__)
    refine_args(ap)
    args = ap.parse_args(argv)
    pr = Probe("bench_refine_loop", args)
    rs = RefineSetup(args, pr.dev, shifted=False)
    for dens in (True, False):
        t = ms(rs.run(RefineConfig(use_densify=dens)), rs.state, K=args.K,
               iters=args.iters)
        pr.put(f"densify={dens}", {"loop_ms": t,
                                   "step_ms": t / args.steps})
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
