"""Constructions of the (tiles, max_per_tile) index table from the sorted
pair list, measured on the TPU and superseded by the fused-key sort
(kept as the evidence trail).

    python -m igs_tpu_torch.tools.bench_idxtable [--n 150000] [--res 512]
        [--max-pairs 524288] [--mpt 1024] [--K 10] [--device cpu]

Counterpart of ``tools/tools_bench_idxtable.py``: the bench scene's
150 000 Gaussians (SHs unused, zero colours) through the bench camera at
512², binned by ``build_tile_pairs`` at a 2^19 pair budget, 1024 rows a
tile. Each variant is timed with the binning (its means salted) by
``timeit_device`` (K=10, 3 rounds), under the JAX probe's names:

* ``A gather idx_table``: ``ops/render_tiles.pairs_to_idx_table``, a
  (T, 1024) gather from the sorted list;
* ``B scatter searchsorted``: each pair's rank in its tile from
  ``searchsorted`` of the tile ids on themselves, then a scatter of the
  ids (pairs past the table dropped into a spill slot, as the JAX
  probe's ``mode="drop"``);
* ``C scatter start-gather``: the rank from a gather of ``tile_start``;
* ``D fused feats scatter``: the (pairs, 32) packed features
  (``ops/blend.pack_features``) gathered a pair and scattered into a
  (T·1024, 32) table;
* ``E dyn-slice windows``: no table; the features gathered a pair and
  each tile's 1024-row window sliced at its start. The JAX probe maps
  ``lax.dynamic_slice`` over the starts with ``jax.vmap``; the port's
  nearest is a strided view of every window (``Tensor.unfold``) indexed
  by the starts, laid out (T·1024, 32).

The JAX probe's checks stay checks: B and C equal A, and E equals A's
table followed by the feature gather within each tile's count; the port
also holds D to that. A failed check makes the program exit 1. No
variant launches a kernel of the port (the JSON's ``launches`` is
empty and ``kernel`` says so).
"""

from __future__ import annotations

import sys

import torch

from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
from igs_tpu_torch.ops.blend import pack_features
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.render_tiles import pairs_to_idx_table
from igs_tpu_torch.tools.probe import Probe, camera, ms, parser, scene


def _rank_by_search(pairs):
    slots = torch.arange(pairs.tile_id.shape[0], device=pairs.tile_id.device)
    return slots - torch.searchsorted(pairs.tile_id, pairs.tile_id,
                                      side="left")


def _scatter_ids(pairs, within, ok, tiles: int, mpt: int):
    dest = torch.where(ok, pairs.tile_id.long() * mpt + within,
                       torch.full_like(within, tiles * mpt))
    table = torch.full((tiles * mpt + 1,), -1, dtype=torch.int32,
                       device=within.device)
    table[dest] = pairs.gauss_id
    return table[:-1].reshape(tiles, mpt)


def variant_b(pairs, tiles: int, mpt: int):
    within = _rank_by_search(pairs)
    ok = (pairs.tile_id < tiles) & (within < mpt)
    return _scatter_ids(pairs, within, ok, tiles, mpt)


def variant_c(pairs, tiles: int, mpt: int):
    slots = torch.arange(pairs.tile_id.shape[0], device=pairs.tile_id.device)
    start_pad = torch.cat([pairs.tile_start.long(), torch.full(
        (1,), pairs.tile_id.shape[0], device=slots.device)])
    within = slots - start_pad[torch.clamp_max(pairs.tile_id.long(), tiles)]
    ok = (pairs.tile_id < tiles) & (within < mpt) & (within >= 0)
    return _scatter_ids(pairs, within, ok, tiles, mpt)


def variant_d(pairs, feats, tiles: int, mpt: int):
    rows = feats[pairs.gauss_id.clamp_min(0).long()]
    within = _rank_by_search(pairs)
    ok = (pairs.tile_id < tiles) & (within < mpt) & (pairs.gauss_id >= 0)
    dest = torch.where(ok, pairs.tile_id.long() * mpt + within,
                       torch.full_like(within, tiles * mpt))
    table = torch.zeros((tiles * mpt + 1, feats.shape[-1]),
                        device=feats.device)
    table[dest] = rows
    return table[:-1]


def variant_e(pairs, feats, mpt: int):
    rows = feats[pairs.gauss_id.clamp_min(0).long()]
    rows = torch.nn.functional.pad(rows, (0, 0, 0, mpt))
    windows = rows.unfold(0, mpt, 1)[pairs.tile_start.long()]  # (T, 32, mpt)
    return windows.transpose(1, 2).reshape(-1, feats.shape[-1])


def within_counts(pairs, mpt: int) -> torch.Tensor:
    """(T, mpt) bool: the slots below each tile's count."""
    j = torch.arange(mpt, device=pairs.tile_count.device)
    return j[None, :] < torch.clamp_max(pairs.tile_count, mpt)[:, None]


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--max-pairs", type=int, default=1 << 19)
    ap.add_argument("--mpt", type=int, default=1024)
    ap.add_argument("--K", type=int, default=10)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    pr = Probe("bench_idxtable", args)
    dev, n, mp, mpt = pr.dev, args.n, args.max_pairs, args.mpt
    g = scene(n, dev)
    proj = project(g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                   camera(args.res, dev),
                   colors_precomp=torch.zeros((n, 3), device=dev))
    gx, gy = image_tile_grid(args.res, args.res)
    tiles = gx * gy
    k = dict(K=args.K, iters=args.iters)
    salt = torch.zeros((), device=dev)

    def binned(e):
        p = proj._replace(means2d=proj.means2d + e)
        return p, build_tile_pairs(p, gx, gy, mp)

    def feats_of(p):
        return pack_features(p).reshape(-1, 32)

    pr.put("A gather idx_table", ms(
        lambda e: pairs_to_idx_table(binned(e)[1], mpt), salt, **k))
    pr.put("B scatter searchsorted", ms(
        lambda e: variant_b(binned(e)[1], tiles, mpt), salt, **k))
    pr.put("C scatter start-gather", ms(
        lambda e: variant_c(binned(e)[1], tiles, mpt), salt, **k))
    pr.put("D fused feats scatter", ms(
        lambda e: variant_d(binned(e)[1], feats_of(binned(e)[0]), tiles,
                            mpt), salt, **k))
    pr.put("E dyn-slice windows", ms(
        lambda e: variant_e(binned(e)[1], feats_of(binned(e)[0]), mpt),
        salt, **k))

    pairs = build_tile_pairs(proj, gx, gy, mp)
    feats = feats_of(proj)
    a = pairs_to_idx_table(pairs, mpt)
    gathered = feats[a.clamp_min(0).long()]  # (T, mpt, 32)
    live = within_counts(pairs, mpt)
    checks = {
        "B == A": bool(torch.equal(variant_b(pairs, tiles, mpt), a)),
        "C == A": bool(torch.equal(variant_c(pairs, tiles, mpt), a)),
        "E == A+gather (within counts)": bool(torch.equal(
            variant_e(pairs, feats, mpt).reshape(gathered.shape)[live],
            gathered[live])),
        "D == A+gather (within counts)": bool(torch.equal(
            variant_d(pairs, feats, tiles, mpt).reshape(gathered.shape)[live],
            gathered[live])),
    }
    pr.put("checks", checks)
    pr.put("ok", all(checks.values()))
    pr.put("kernel", "none of the port's: PyTorch calls only")
    pr.write()
    return 0 if pr.results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
