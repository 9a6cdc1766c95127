"""Binning strategies at the production scale: the pair sort (alone,
with the per-tile index table, with the feature gather) against the
sort-free compact lists, and the sort at smaller pair budgets.

    python -m igs_tpu_torch.tools.bench_binning2 [--n 150000] [--res 512]
        [--max-pairs 524288] [--mpt 1024] [--K 10] [--device cpu]

Counterpart of ``tools/tools_bench_binning2.py`` (150 000 Gaussians at
512², a 2^19 pair budget, 1024 rows a tile, a zero colour): lines
"pairs only" (``build_tile_pairs``), "pairs+idx_table"
(``render_tiles.pairs_to_idx_table``), "pairs+idx+gather" (the packed
features of every table slot), "compact lists"
(``build_tile_lists_compact``, the route ``binning="compact"`` runs),
"compact+gather", "pairs" at 2^18 and 2^17, and how full the budget is.
No kernel runs: binning is plain PyTorch on the card.
"""

from __future__ import annotations

import sys

from igs_tpu_torch.ops.binning import (build_tile_lists_compact,
                                       build_tile_pairs, image_tile_grid)
from igs_tpu_torch.ops.blend import pack_features
from igs_tpu_torch.ops.render_tiles import pairs_to_idx_table
from igs_tpu_torch.tools.bench_binning import project_plain
from igs_tpu_torch.tools.probe import Probe, camera, ms, parser, scene


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--max-pairs", type=int, default=1 << 19)
    ap.add_argument("--mpt", type=int, default=1024)
    ap.add_argument("--K", type=int, default=10)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    pr = Probe("bench_binning2", args)
    g = scene(args.n, pr.dev)
    cam = camera(args.res, pr.dev)
    proj = project_plain(g, cam)
    gx, gy = image_tile_grid(args.res, args.res)
    mp, mpt = args.max_pairs, args.mpt
    k = dict(K=args.K, iters=args.iters)

    def gathered(p, idx):
        return pack_features(p)[0][idx.clamp_min(0).long()].reshape(-1, 32)

    def full_current(p):
        return gathered(p, pairs_to_idx_table(
            build_tile_pairs(p, gx, gy, mp), mpt))

    def full_compact(p):
        return gathered(p, build_tile_lists_compact(p, gx, gy, mpt)[0][0])

    pr.put("pairs only", ms(lambda p: build_tile_pairs(p, gx, gy, mp), proj,
                            **k))
    pr.put("pairs+idx_table", ms(lambda p: pairs_to_idx_table(
        build_tile_pairs(p, gx, gy, mp), mpt), proj, **k))
    pr.put("pairs+idx+gather", ms(full_current, proj, **k))
    pr.put("compact lists", ms(
        lambda p: build_tile_lists_compact(p, gx, gy, mpt), proj, **k))
    pr.put("compact+gather", ms(full_compact, proj, **k))
    for small in (mp // 2, mp // 4):
        pr.put(f"pairs mp={small}", ms(
            lambda p, m=small: build_tile_pairs(p, gx, gy, m), proj, **k))
    pairs = build_tile_pairs(proj, gx, gy, mp)
    pr.put("budget", {"num_pairs": int(pairs.num_pairs.sum()),
                      "max_pairs": mp,
                      "max_tile_count": int(pairs.tile_count.max()),
                      "overflowed": bool(pairs.overflowed.any())})
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
