"""Numerics check: the packed route (kernels B1, B2, and B3 in the
gradient reduction) against the windowed route (B5a, B5b) on the
production-scale scene, images and all five parameter gradients.

    python -m igs_tpu_torch.tools.precision_check [--n 150000] [--res 512]
        [--max-per-tile 1024] [--device cpu]

Counterpart of ``tools/tools_precision_check.py`` (150 000 Gaussians at
512², a 2^19 pair budget, ``max_per_tile`` 1024, colour and full
outputs; the gradient of mean |colour|). The TPU probe checks that the
packed kernels' three-pass MXU tril dots stay inside the parity
envelope; Hopper's kernels have no MXU precision tier (both routes
accumulate in float32 FMA), so here the check holds two kernel routes
that share one body but differ in their pair layout and gradient
reduction. Per output and tensor it records the largest image error and
each gradient's largest error over its largest entry, and holds the TPU
probe's bounds: image under ``TOL_IMAGE`` (2e-3) and every gradient
under ``TOL_GRAD`` (the 2e-4 parity envelope). Tiles over
``max_per_tile`` pairs, which the windowed route drops, are counted:
where there are any the two routes render different pair sets and the
check fails, as the JAX probe's asserts do. The probe exits 1 when a
check fails.
"""

from __future__ import annotations

import sys

import torch

from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.tools.probe import Probe, camera, parser, scene

TOL_IMAGE = 2e-3
TOL_GRAD = 2e-4
NAMES = ("xyz", "opacity", "scaling", "rotation", "shs")
OUTPUTS = ("color", "full")  # the JAX probe's two output modes


def render(g, cam, settings):
    """(colour image, gradients of mean |colour| by name, overflow)."""
    params = [getattr(g, k).detach().requires_grad_(True) for k in NAMES]
    with torch.enable_grad():
        out = rasterize(
            means3d=params[0], opacity=torch.sigmoid(params[1]),
            scaling=torch.exp(params[2]),
            rotation=torch.nn.functional.normalize(params[3], dim=-1),
            camera=cam, shs=params[4], valid=g.valid, settings=settings)
        grads = torch.autograd.grad(torch.mean(torch.abs(out["color"])),
                                    params)
    return (out["color"].detach(), dict(zip(NAMES, grads)),
            int(out["overflow_tiles"].sum()))


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--max-per-tile", type=int, default=1024)
    ap.add_argument("--max-pairs", type=int, default=1 << 19)
    args = ap.parse_args(argv)
    pr = Probe("precision_check", args)
    g = scene(args.n, pr.dev)
    cam = camera(args.res, pr.dev)
    base = RasterSettings(image_height=args.res, image_width=args.res,
                          max_pairs=args.max_pairs,
                          max_per_tile=args.max_per_tile, chunk=128)
    ok = True
    for outputs in OUTPUTS:
        a_img, a_gr, over = render(g, cam, base._replace(
            impl="pallas", outputs=outputs))
        b_img, b_gr, _ = render(g, cam, base._replace(
            impl="pallas_packed", outputs=outputs))
        res = {"image_max_abs": float((a_img - b_img).abs().max()),
               "image_mean_abs": float((a_img - b_img).abs().mean()),
               "windowed_overflow_tiles": over}
        for k in NAMES:
            scale = float(a_gr[k].abs().max()) + 1e-12
            res[f"grad_{k}_rel"] = float((a_gr[k] - b_gr[k]).abs().max()
                                         ) / scale
        res["ok"] = (over == 0 and res["image_max_abs"] < TOL_IMAGE
                     and all(res[f"grad_{k}_rel"] < TOL_GRAD for k in NAMES))
        ok = ok and res["ok"]
        pr.put(outputs, res)
    pr.put("ok", ok)
    pr.write()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
