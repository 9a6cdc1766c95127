"""Binning internals one by one, and the backward's per-pair → per-
Gaussian reductions: a transpose, the scatter-add, and the sorted
segment sum through the segmented scan (kernel B3).

    python -m igs_tpu_torch.tools.bench_binning3 [--n 150000] [--res 512]
        [--max-pairs 524288] [--K 8] [--device cpu]

Counterpart of ``tools/tools_bench_binning3.py`` (150 000 Gaussians at
512², a 2^19 pair budget). Binning lines: the depth argsort alone, the
depth order with its gathers (``depth_order``), the expansion
(``expand_pairs``), a tile histogram (``torch.bincount``), the stable
pair sort (``sort_pairs``) and the range search (``tile_ranges``). The
TPU probe also times a sort padded to its 8-pair alignment; the port's
binning pads nothing, so that line has no counterpart. Backward lines,
over (16, 2^19) per-pair grads into 150 000 Gaussians of seeded random
ids: the transpose alone, transpose + ``index_add_`` into (N, 16),
``index_add_`` in the port's (16, N) layout, and the sorted alternative
the port ships: a gather into Gaussian order and ``segment_sum_sorted``
(the segmented scan B3 and a gather of each run's last row).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from igs_tpu_torch.ops.binning import (depth_order, expand_pairs,
                                       image_tile_grid, sort_pairs,
                                       tile_ranges)
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.segred import segment_sum_sorted
from igs_tpu_torch.tools.probe import Probe, camera, ms, parser, scene


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--max-pairs", type=int, default=1 << 19)
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    pr = Probe("bench_binning3", args)
    dev = pr.dev
    n, mp = args.n, args.max_pairs
    g = scene(n, dev)
    cam = camera(args.res, dev)
    proj = project(g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                   cam, shs=g.shs, valid=g.valid, geometry=False)
    gx, gy = image_tile_grid(args.res, args.res)
    tiles = gx * gy
    k = dict(K=args.K, iters=args.iters)
    order, rmin, rmax, tt = depth_order(proj)
    tile_full, gauss_full, _, _ = expand_pairs(order, rmin, rmax, tt, gx,
                                               tiles, mp)
    tile_sorted, _, _ = sort_pairs(tile_full, gauss_full)

    def argsort_depth(p):
        key = torch.where(p.visible, p.depth,
                          torch.full_like(p.depth, float("inf")))
        return torch.argsort(key, dim=-1, stable=True)

    # the int-only stages are salted through a float carrier
    salt = torch.zeros(1, device=dev)
    pr.put("argsort_depth", ms(argsort_depth, proj, **k))
    pr.put("depth_order", ms(depth_order, proj, **k))
    pr.put("repeat_expand", ms(
        lambda s: expand_pairs(order, rmin, rmax, tt, gx, tiles, mp),
        salt, **k))
    pr.put("histogram", ms(
        lambda s: torch.bincount(tile_full, minlength=tiles + 1), salt, **k))
    pr.put(f"sort {mp} (stable)", ms(
        lambda s: sort_pairs(tile_full, gauss_full), salt, **k))
    pr.put("ranges", ms(lambda s: tile_ranges(tile_sorted, tiles), salt,
                        **k))

    lanes = 16
    rng = np.random.RandomState(0)
    dft = torch.from_numpy(rng.normal(size=(lanes, mp)).astype(
        np.float32)).to(dev)
    gid_np = rng.randint(0, n, size=(mp,)).astype(np.int64)
    gid = torch.from_numpy(gid_np).to(dev)
    perm_np = np.argsort(gid_np, kind="stable")
    perm = torch.from_numpy(perm_np).to(dev)
    gid_sorted = torch.from_numpy(gid_np[perm_np].astype(np.int32)).to(dev)
    last = np.full(n, -1, np.int64)
    last[gid_np[perm_np]] = np.arange(mp)  # the last write wins
    last_row = torch.from_numpy(last).to(dev)

    def sorted_segment(d):
        return segment_sum_sorted(torch.index_select(d, 1, perm),
                                  gid_sorted, last_row)

    pr.put("transpose only", ms(lambda d: d.t().contiguous(), dft, **k))
    pr.put("transpose+scatter", ms(
        lambda d: torch.zeros((n, lanes), device=dev).index_add_(
            0, gid, d.t()), dft, **k))
    pr.put("scatter (lanes, N)", ms(
        lambda d: torch.zeros((lanes, n), device=dev).index_add_(1, gid, d),
        dft, **k))
    pr.put("perm-gather+segment_sum_sorted", ms(sorted_segment, dft, **k))
    want = torch.zeros((lanes, n), device=dev).index_add_(1, gid, dft)
    got = sorted_segment(dft)
    pr.put("segment_sum_vs_index_add_max_abs",
           float((got - want).abs().max()), "")
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
