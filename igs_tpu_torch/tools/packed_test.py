"""Packed-route smoke: one render of the JAX probe's scene through
``rasterize`` (and with ``bwd`` its gradient), then the forward kernel
B1 (and with ``bwd`` the backward kernel B2) held against its plain
version on the render's own inputs.

    python -m igs_tpu_torch.tools.packed_test [--n 20000] [--res 256]
        [--what fwd|bwd] [--device cpu]

Counterpart of ``tools/tools_packed_test.py`` (n = 20 000 Gaussians at
256², colour outputs, a 2^19 pair budget; ``fwd``, the default there
and here, prints the image sum, ``bwd`` the gradient sum of mean |colour| with respect to the
positions). The port adds the check the TPU probe left to the parity
tests: the raw accumulators of B1 against ``blend_raw_packed_plain``
(largest error off the pixels whose contributor count flips, at most
``TOL_ABS``; flips at most ``TOL_FLIP_FRAC`` of the pixels), and with
``bwd`` the pair-feature gradients of B2 against
``blend_raw_packed_bwd_plain`` on the same raw block and a seeded
cotangent (largest error at most ``TOL_BWD_REL`` of the largest
gradient). The probe exits 1 when a check fails. With ``--device cpu``
both sides are the plain versions.
"""

from __future__ import annotations

import sys

import torch

from igs_tpu_torch.ops import blend
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.tools.probe import (Probe, camera, packed_inputs, parser,
                                       scene)

TOL_ABS = 2e-4  # B1 against plain, per raw lane, off flip pixels
TOL_FLIP_FRAC = 1e-4  # pixels whose contributor count may flip
TOL_BWD_REL = 1e-4  # B2 against plain, of the largest gradient
NC_LANE = 5  # the colour raw block's contributor-count lane


def check_kernels(feats_t, pairs, gx, gy, mode, backward, seed=0):
    """{fwd_max_abs_err, flips, pixels[, bwd_max_rel_err]} of B1 (and B2)
    against their plain versions, and whether they hold."""
    args = (feats_t, pairs.tile_start, pairs.tile_count, gx, gy, mode)
    kern = blend._blend_fwd(*args)
    plain = blend.blend_raw_packed_plain(*args)
    nc = NC_LANE if mode == "color" else 16
    flip = kern[..., nc] != plain[..., nc]
    diff = (kern - plain).abs().amax(dim=-1)[~flip]
    res = {"fwd_max_abs_err": float(diff.max()) if diff.numel() else 0.0,
           "flips": int(flip.sum()), "pixels": flip.numel()}
    ok = (res["fwd_max_abs_err"] <= TOL_ABS
          and res["flips"] <= TOL_FLIP_FRAC * res["pixels"])
    if backward:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        cot = (1e-3 * torch.randn(kern.shape, generator=gen)).to(kern.device)
        d_kern = blend.blend_raw_packed_bwd(*args, kern, cot)
        d_plain = blend.blend_raw_packed_bwd_plain(*args, kern, cot)
        scale = float(d_plain.abs().max()) + 1e-30
        res["bwd_max_rel_err"] = float((d_kern - d_plain).abs().max()) / scale
        ok = ok and res["bwd_max_rel_err"] <= TOL_BWD_REL
    return res, ok


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--what", default="fwd", choices=["fwd", "bwd"])
    ap.add_argument("--max-pairs", type=int, default=1 << 19)
    args = ap.parse_args(argv)
    pr = Probe("packed_test", args)
    g = scene(args.n, pr.dev)
    cam = camera(args.res, pr.dev)
    settings = RasterSettings(
        image_height=args.res, image_width=args.res, impl="pallas_packed",
        max_pairs=args.max_pairs, outputs="color", clamp_grads=False)
    xyz = g.xyz.detach().requires_grad_(args.what == "bwd")
    with torch.enable_grad():
        img = rasterize(means3d=xyz, opacity=g.get_opacity,
                        scaling=g.get_scaling, rotation=g.get_rotation,
                        camera=cam, shs=g.shs, valid=g.valid,
                        settings=settings)["color"]
        pr.put("fwd_sum", float(img.detach().sum()), "")
        if args.what == "bwd":
            (grad,) = torch.autograd.grad(torch.mean(torch.abs(img)), [xyz])
            pr.put("grad_sum", float(grad.sum()), "")
    _, pairs, feats_t, gx, gy = packed_inputs(g, cam, "color",
                                              args.max_pairs)
    res, ok = check_kernels(feats_t, pairs, gx, gy, "color",
                            args.what == "bwd")
    for k, v in res.items():
        pr.put(k, v, "")
    pr.put("pairs", int(pairs.num_pairs.sum()), "")
    pr.put("ok", ok, "")
    pr.write()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
