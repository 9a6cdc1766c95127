"""Binning ablation: ``build_tile_pairs`` timed up to each of its stages,
to place the cost.

    python -m igs_tpu_torch.tools.bench_binning [--n 150000] [--res 512]
        [--max-pairs 524288] [--K 10] [--device cpu]

Counterpart of ``tools/tools_bench_binning.py`` (150 000 Gaussians at
512², a 2^19 pair budget, a zero colour). The TPU probe rebuilds the
binning by hand with pieces stubbed: argsort and gathers only, the
expansion without its tile divmod, with it, the pair sort, and the
ranges. The port's binning is five public stages of ``ops/binning.py``
(``depth_order``, ``expand_pairs``, ``sort_pairs``, ``tile_ranges``,
``segred_tables``), so the probe composes them (``compose``) and times
the composition up to each stage; the expansion's floor division is
inside ``expand_pairs`` and is not timed apart. ``compose`` with every
stage gives ``build_tile_pairs``'s pairs exactly (a CPU test holds it).
No kernel runs: binning is plain PyTorch on the card.
"""

from __future__ import annotations

import sys

import torch

from igs_tpu_torch.ops.binning import (TilePairs, depth_order, expand_pairs,
                                       image_tile_grid, segred_tables,
                                       sort_pairs, tile_ranges)
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.tools.probe import Probe, camera, ms, parser, scene

STAGES = ("depth_order", "expand", "sort", "ranges", "aux")


def project_plain(g, cam):
    """The binning probes' projection: a zero colour, no geometry."""
    return project(g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                   cam, colors_precomp=torch.zeros_like(g.xyz),
                   valid=g.valid, geometry=False)


def compose(proj, grid_x: int, grid_y: int, max_pairs: int,
            upto: str = "aux"):
    """The binning's stages in order up to ``upto``; with "ranges" or
    "aux" the ``TilePairs`` (the segmented-reduction aux with "aux"),
    else the last stage's output."""
    nv = proj.depth.shape[0]
    num_tiles = grid_x * grid_y
    order, rmin, rmax, tt = depth_order(proj)
    if upto == "depth_order":
        return order
    tile_full, gauss_full, offsets, kept = expand_pairs(
        order, rmin, rmax, tt, grid_x, num_tiles, max_pairs)
    if upto == "expand":
        return tile_full, gauss_full
    tile_sorted, perm, gauss_sorted = sort_pairs(tile_full, gauss_full)
    if upto == "sort":
        return tile_sorted, gauss_sorted
    bounds = tile_ranges(tile_sorted, nv * num_tiles)
    empty = torch.zeros(0, dtype=torch.int64, device=order.device)
    aux = (empty, torch.zeros(0, dtype=torch.int32, device=order.device),
           empty)
    if upto == "aux":
        e2s, last = segred_tables(perm, order, offsets, kept, max_pairs)
        aux = (e2s, gauss_full, last)
    total = offsets[:, -1]
    return TilePairs(
        gauss_id=gauss_sorted, tile_id=tile_sorted,
        num_pairs=torch.clamp(total, max=max_pairs).to(torch.int32),
        tile_start=bounds[:-1].to(torch.int32),
        tile_count=(bounds[1:] - bounds[:-1]).to(torch.int32),
        overflowed=total > max_pairs, exp_to_sorted=aux[0],
        exp_gauss_id=aux[1], gauss_last_row=aux[2])


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--max-pairs", type=int, default=1 << 19)
    ap.add_argument("--K", type=int, default=10)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    pr = Probe("bench_binning", args)
    g = scene(args.n, pr.dev)
    cam = camera(args.res, pr.dev)
    proj = project_plain(g, cam)
    gx, gy = image_tile_grid(args.res, args.res)
    for upto in STAGES:
        pr.put(f"upto {upto}", ms(
            lambda p, u=upto: compose(p, gx, gy, args.max_pairs, u), proj,
            K=args.K, iters=args.iters))
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
