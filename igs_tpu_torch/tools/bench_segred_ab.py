"""A/B of the per-pair → per-Gaussian gradient reduction inside a whole
rasterize forward+backward: the segmented reduction the port ships
(``segred.gather_pairs``: the inverse permutation, the segmented scan
B3, a boundary gather) against a plain gather whose autograd backward is
``index_add_``.

    python -m igs_tpu_torch.tools.bench_segred_ab [--n 150000]
        [--res 512] [--K 48] [--device cpu]

Counterpart of ``tools/tools_bench_segred_ab.py`` (the bench workload:
150 000 Gaussians at 512², a 2^19 pair budget; colour and full outputs,
the loss mean |colour| plus 0.1 × mean depth in full). The plain side
turns the binning's segmented-reduction aux off (``rasterize.
_segred_aux``), so ``render_tiles_packed`` gathers with
``index_select``, as the JAX probe swaps ``segred.gather_pairs`` for a
plain gather. The two sides' gradients are also compared (largest error
over the largest entry, per tensor).
"""

from __future__ import annotations

import sys

from igs_tpu_torch.ops import rasterize as ras
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.tools.probe import (Probe, camera, ms, parser,
                                       render_grads, scene)

NAMES = ("xyz", "opacity", "scaling", "rotation", "shs")
MODES = ("color", "full")  # the JAX probe's two output modes


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--K", type=int, default=48)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--max-pairs", type=int, default=1 << 19)
    args = ap.parse_args(argv)
    pr = Probe("bench_segred_ab", args)
    g = scene(args.n, pr.dev)
    cam = camera(args.res, pr.dev)
    params = (g.xyz, g.opacity, g.scaling, g.rotation, g.shs)
    orig = ras._segred_aux
    for mode in MODES:
        settings = RasterSettings(
            image_height=args.res, image_width=args.res,
            impl="pallas_packed", max_pairs=args.max_pairs, max_per_tile=1024,
            outputs=mode)
        gf = render_grads(g, cam, settings, depth_term=mode == "full")
        seg = gf(*params)
        t_seg = ms(gf, *params, K=args.K, iters=args.iters)
        try:
            ras._segred_aux = lambda s: False
            plain = gf(*params)
            t_sc = ms(gf, *params, K=args.K, iters=args.iters)
        finally:
            ras._segred_aux = orig
        err = {k: float((a - b).abs().max() / (b.abs().max() + 1e-12))
               for k, a, b in zip(NAMES, seg, plain)}
        pr.put(mode, {"segred_ms": t_seg, "scatter_ms": t_sc,
                      "grad_rel_err": err})
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
