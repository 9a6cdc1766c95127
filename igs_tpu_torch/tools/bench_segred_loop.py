"""The segmented reduction against the scatter-add inside the refine
loop: 50 colour refine steps with each backward reduction.

    python -m igs_tpu_torch.tools.bench_segred_loop [--n 150000]
        [--res 512] [--steps 50] [--views 18] [--device cpu]

Counterpart of ``tools/tools_bench_segred_loop.py`` (150 000 Gaussians
at 512², 18 views shifted along x, zero ground truths, no densify, a
2^19 pair budget). "segred" is the port's default (``gather_pairs``:
the inverse permutation, the segmented scan B3, a boundary gather);
"scatter" turns the binning's aux off (``rasterize._segred_aux``), so
the pair gather is ``index_select`` and its backward ``index_add_``.
The JAX probe measured in its fused loop because XLA overlapped the
stages there; the port's loop runs eager, one launch after another, so
its difference sits close to the isolated one (``bench_segred_ab``).
"""

from __future__ import annotations

import sys

from igs_tpu_torch.ops import rasterize as ras
from igs_tpu_torch.stream.refine import RefineConfig
from igs_tpu_torch.tools.probe import (Probe, RefineSetup, ms, parser,
                                       refine_args)


def main(argv=None) -> int:
    ap = parser(__doc__)
    refine_args(ap)
    args = ap.parse_args(argv)
    pr = Probe("bench_segred_loop", args)
    rs = RefineSetup(args, pr.dev)
    loop = rs.run(RefineConfig(use_densify=False))
    orig = ras._segred_aux
    for mode in ("scatter", "segred"):
        try:
            if mode == "scatter":
                ras._segred_aux = lambda s: False
            t = ms(loop, rs.state, K=args.K, iters=args.iters)
        finally:
            ras._segred_aux = orig
        pr.put(mode, {"loop_ms": t, "step_ms": t / args.steps})
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
