"""Blend sweep at the production shape: the windowed route's
``max_per_tile`` beside the packed route, forward and forward+backward.

    python -m igs_tpu_torch.tools.bench_blend [--maxpt 512 1024]
        [--mode color|full] [--n 150000] [--res 512] [--K 8] [--device cpu]

Counterpart of ``tools/tools_bench_blend.py`` (150 000 Gaussians at
512², a 2^19 pair budget (``--max-pairs``); the gradient of mean
|colour| with respect to all five parameter tensors). The TPU probe
sweeps the Pallas kernels' ``chunk`` (rows a grid step blends), their
tiles-per-block cap and ``max_per_tile``. The port's kernels (B5a/B5b windowed, B1/B2 packed)
walk a tile's pairs one warp-wide batch at a time and have neither
knob: ``chunk`` is only the plain versions' row count, and the
tiles-per-block cap has no counterpart. So the sweep is the nearest
choice the port has: ``max_per_tile`` of the windowed route (which
drops pairs past it, counted as overflowing tiles), each beside the
packed route, which has no window. Each line is ``timeit_device`` at
``K`` calls.
"""

from __future__ import annotations

import sys

from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.tools.probe import (Probe, camera, ms, parser,
                                       render_grads, scene)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--maxpt", type=int, nargs="*", default=[512, 1024])
    ap.add_argument("--mode", default="color", choices=["color", "full"])
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--max-pairs", type=int, default=1 << 19)
    args = ap.parse_args(argv)
    pr = Probe("bench_blend", args)
    g = scene(args.n, pr.dev)
    cam = camera(args.res, pr.dev)
    params = (g.xyz, g.opacity, g.scaling, g.rotation, g.shs)
    cases = [("pallas_packed", None)] + [("pallas", m) for m in args.maxpt]
    for impl, maxpt in cases:
        settings = RasterSettings(
            image_height=args.res, image_width=args.res, impl=impl,
            max_pairs=args.max_pairs, max_per_tile=maxpt or 4096,
            outputs=args.mode, clamp_grads=False)

        def fwd(xyz, s=settings):
            return rasterize(means3d=xyz, opacity=g.get_opacity,
                             scaling=g.get_scaling, rotation=g.get_rotation,
                             camera=cam, shs=g.shs, valid=g.valid,
                             settings=s)["color"]

        over = int(rasterize(means3d=g.xyz, opacity=g.get_opacity,
                             scaling=g.get_scaling, rotation=g.get_rotation,
                             camera=cam, shs=g.shs, valid=g.valid,
                             settings=settings)["overflow_tiles"])
        label = "packed" if maxpt is None else f"windowed maxpt={maxpt}"
        pr.put(label, {
            "fwd_ms": ms(fwd, g.xyz, K=args.K, iters=args.iters),
            "fwd_bwd_ms": ms(render_grads(g, cam, settings), *params,
                             K=args.K, iters=args.iters),
            "overflow_tiles": over})
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
