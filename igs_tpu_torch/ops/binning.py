"""Tile binning: duplicate Gaussians over the tiles they cover, then sort.

Counterpart of ``igs_tpu/ops/binning.py`` (``build_tile_pairs``, with the
segmented-reduction aux that ``ops/segred.gather_pairs`` reads in the
backward). The per-tile order is the reference's: a stable depth argsort
of the Gaussians, expansion in that order, then a stable sort by tile id, so
ties keep Gaussian-index order. The pair budget ``max_pairs`` is per view
and truncation is surfaced through ``overflowed``.

Several views bin in one pass: tile ids of view v are offset by v·T and
Gaussian ids index the flattened (V·N) rows, so one blend launch walks
every view's tiles.

``build_tile_pairs`` runs five public stages (``depth_order``,
``expand_pairs``, ``sort_pairs``, ``tile_ranges``, ``segred_tables``),
which the binning probes of ``igs_tpu_torch/tools/`` time one by one.

``build_tile_lists_compact`` is the JAX package's sort-free binning
(``binning="compact"``): per-tile lists by compaction, in the same order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from igs_tpu_torch.ops.projection import ProjectedGaussians, TILE_X, TILE_Y


class TilePairs(NamedTuple):
    gauss_id: torch.Tensor  # (V·max_pairs,) int32 row of the (V·N) features, -1 pad
    tile_id: torch.Tensor  # (V·max_pairs,) int32 v·T + tile, V·T for pad
    num_pairs: torch.Tensor  # (V,) int32 pairs kept per view
    tile_start: torch.Tensor  # (V·T,) int32 segment starts
    tile_count: torch.Tensor  # (V·T,) int32 segment lengths
    overflowed: torch.Tensor  # (V,) bool — a view exceeded max_pairs
    # segmented grad-reduction aux (ops/segred.py), empty unless asked for.
    # Gaussians are depth-sorted before expansion, so in expansion order
    # (slot v·max_pairs + base + local) each row's pairs are contiguous.
    exp_to_sorted: torch.Tensor  # (V·max_pairs,) int64 expansion slot → sorted position
    exp_gauss_id: torch.Tensor  # (V·max_pairs,) int32 row per expansion slot, -1 pad
    gauss_last_row: torch.Tensor  # (V·N,) int64 expansion slot of the row's last kept pair, -1 if none


def image_tile_grid(height: int, width: int) -> tuple[int, int]:
    return (width + TILE_X - 1) // TILE_X, (height + TILE_Y - 1) // TILE_Y


def depth_order(proj: ProjectedGaussians):
    """Stage 1: the stable depth sort per view (invisible → +inf, last):
    (order (V, N) int64, rect_min, rect_max (V, N, 2) and tiles touched
    (V, N) int64 in that order)."""
    depth_key = torch.where(proj.visible, proj.depth,
                            torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(depth_key, dim=-1, stable=True)  # (V, N)
    rect_min = torch.gather(proj.rect_min, 1, order[..., None].expand(-1, -1, 2))
    rect_max = torch.gather(proj.rect_max, 1, order[..., None].expand(-1, -1, 2))
    tt = torch.gather(proj.tiles_touched, 1, order).to(torch.int64)
    return order, rect_min, rect_max, tt


def expand_pairs(order, rect_min, rect_max, tt, grid_x: int, num_tiles: int,
                 max_pairs: int):
    """Stage 2: the (gaussian, tile) pairs in depth order under the budget,
    in expansion slots: (tile ids (V·max_pairs,) int32, V·T for pad;
    gauss ids (V·max_pairs,) int32, -1 pad; the per-view cumulative tiles
    (V, N) int64; pairs kept per Gaussian (V·N,) int64).

    Every slot is filled at the budget's fixed size, as the JAX package's
    ``total_repeat_length`` does: each view's rows are followed by one pad
    row that repeats into the view's unused slots, so the repeat's size is
    known without reading the counts back (no host sync)."""
    nv, n = order.shape
    dev = order.device
    offsets = torch.cumsum(tt, dim=1)
    base = offsets - tt
    kept = torch.clamp(torch.minimum(tt, max_pairs - base), min=0)
    pad = max_pairs - kept.sum(dim=1, keepdim=True)
    src = torch.repeat_interleave(torch.cat([kept, pad], 1).reshape(-1),
                                  output_size=nv * max_pairs)
    view = torch.div(src, n + 1, rounding_mode="floor")
    col = src - view * (n + 1)
    live = col < n
    rows = view * n + col.clamp(max=n - 1)
    local = (torch.arange(nv * max_pairs, device=dev) - view * max_pairs
             - base.reshape(-1)[rows])
    x0 = rect_min[..., 0].reshape(-1)[rows].to(torch.int64)
    y0 = rect_min[..., 1].reshape(-1)[rows].to(torch.int64)
    rw = torch.clamp(rect_max[..., 0] - rect_min[..., 0], min=1).reshape(-1)[
        rows].to(torch.int64)
    q = torch.div(local, rw, rounding_mode="floor")
    tile = view * num_tiles + (y0 + q) * grid_x + x0 + (local - q * rw)
    tile_full = torch.where(live, tile, nv * num_tiles).to(torch.int32)
    gauss_full = torch.where(live, view * n + order.reshape(-1)[rows],
                             -1).to(torch.int32)
    return tile_full, gauss_full, offsets, kept.reshape(-1)


def sort_pairs(tile_full: torch.Tensor, gauss_full: torch.Tensor):
    """Stage 3: the stable tile sort, depth order kept within each tile:
    (sorted tile ids, the permutation (int64), sorted gauss ids)."""
    tile_sorted, perm = torch.sort(tile_full, stable=True)
    return tile_sorted, perm, gauss_full[perm]


def tile_ranges(tile_sorted: torch.Tensor, tiles: int) -> torch.Tensor:
    """Stage 4: the ``tiles + 1`` segment bounds of the sorted ids, by
    binary search."""
    return torch.searchsorted(
        tile_sorted, torch.arange(tiles + 1, dtype=torch.int32,
                                  device=tile_sorted.device))


def segred_tables(perm: torch.Tensor, order: torch.Tensor,
                  offsets: torch.Tensor, kept: torch.Tensor, max_pairs: int):
    """Stage 5, the segmented grad-reduction aux: the inverse of the tile
    sort (expansion slot → sorted position), and per (V·N) row, in the
    original order, the slot of its last kept pair (-1 if none)."""
    nv, n = order.shape
    dev = perm.device
    exp_to_sorted = torch.empty_like(perm)
    exp_to_sorted[perm] = torch.arange(perm.shape[0], device=dev)
    view_base = torch.arange(nv, device=dev)[:, None] * max_pairs
    last = view_base + torch.clamp(offsets, max=max_pairs) - 1
    last = torch.where(kept.reshape(nv, n) > 0, last,
                       torch.full_like(last, -1))
    gauss_last_row = torch.empty_like(last)
    gauss_last_row.scatter_(1, order, last)
    return exp_to_sorted, gauss_last_row.reshape(-1)


def build_tile_pairs(proj: ProjectedGaussians, grid_x: int, grid_y: int,
                     max_pairs: int, segred_aux: bool = False) -> TilePairs:
    """The five stages above, in order; the aux only when asked for."""
    nv, n = proj.depth.shape
    num_tiles = grid_x * grid_y
    dev = proj.depth.device
    order, rect_min, rect_max, tt = depth_order(proj)
    tile_full, gauss_full, offsets, kept = expand_pairs(
        order, rect_min, rect_max, tt, grid_x, num_tiles, max_pairs)
    tile_sorted, perm, gauss_sorted = sort_pairs(tile_full, gauss_full)
    bounds = tile_ranges(tile_sorted, nv * num_tiles)
    if segred_aux:
        exp_to_sorted, gauss_last_row = segred_tables(perm, order, offsets,
                                                      kept, max_pairs)
        exp_gauss_id = gauss_full
    else:
        exp_to_sorted = gauss_last_row = torch.zeros(
            0, dtype=torch.int64, device=dev)
        exp_gauss_id = torch.zeros(0, dtype=torch.int32, device=dev)
    total = offsets[:, -1]
    return TilePairs(
        gauss_id=gauss_sorted,
        tile_id=tile_sorted,
        num_pairs=torch.clamp(total, max=max_pairs).to(torch.int32),
        tile_start=bounds[:-1].to(torch.int32),
        tile_count=(bounds[1:] - bounds[:-1]).to(torch.int32),
        overflowed=total > max_pairs,
        exp_to_sorted=exp_to_sorted,
        exp_gauss_id=exp_gauss_id,
        gauss_last_row=gauss_last_row,
    )


# mask entries of one block of tile rows in the compact binning's tile
# level (its int64 cumsum and positions: 512 MiB each)
COMPACT_BLOCK_ELEMS = 1 << 26


def _compact(mask: torch.Tensor, values: torch.Tensor, budget: int,
             fill: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row of ``mask`` (R, M): the ``values`` (R, M) at its first
    ``budget`` True entries, in order, padded with ``fill`` → (R, budget),
    and the kept counts (R,)."""
    csum = torch.cumsum(mask, dim=1)
    pos = torch.where(mask, csum - 1, torch.full_like(csum, budget))
    out = torch.full((mask.shape[0], budget + 1), fill, dtype=values.dtype,
                     device=mask.device)
    # entries past the budget land in the spare last column
    out.scatter_(1, torch.clamp_max(pos, budget), values)
    return out[:, :budget], torch.clamp_max(csum[:, -1], budget)


def build_tile_lists_compact(proj: ProjectedGaussians, grid_x: int,
                             grid_y: int, max_per_tile: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-free binning: each tile's depth-ordered Gaussian list by
    compaction, in two levels (tile rows, then the tiles of a row).

    Counterpart of ``igs_tpu/ops/binning.py:build_tile_lists_compact``.
    Gaussians are depth-sorted once (stable; invisible ones last); a tile
    row keeps the first ``min(N, max_per_tile·grid_x)`` Gaussians whose
    rectangle spans it, a tile the first ``max_per_tile`` of its row's
    list whose rectangle spans it. Coverage is the tile rectangle alone,
    as in the JAX package, so an invisible Gaussian whose rectangle is not
    empty is listed. The lists equal the sort route's where nothing
    truncates: depth order, ties by index.

    Returns, per view, (idx_table (V, T, max_per_tile) int32 Gaussian
    indices of the view, -1 padded; counts (V, T) int32). The tile level
    runs over blocks of rows of at most ``COMPACT_BLOCK_ELEMS`` mask
    entries.
    """
    nv, n = proj.depth.shape
    dev = proj.depth.device
    depth_key = torch.where(proj.visible, proj.depth,
                            torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(depth_key, dim=-1, stable=True)  # (V, N)
    rmin = torch.gather(proj.rect_min, 1, order[..., None].expand(-1, -1, 2))
    rmax = torch.gather(proj.rect_max, 1, order[..., None].expand(-1, -1, 2))
    depth_pos = torch.arange(n, device=dev)

    # level 1: per tile row, the depth positions of the Gaussians over it
    max_per_row = min(n, max_per_tile * grid_x)
    rows = torch.arange(grid_y, dtype=torch.int32, device=dev)
    row_mask = ((rows[None, :, None] >= rmin[:, None, :, 1])
                & (rows[None, :, None] < rmax[:, None, :, 1]))  # (V, R, N)
    row_lists, row_counts = _compact(
        row_mask.reshape(nv * grid_y, n),
        depth_pos.expand(nv * grid_y, n), max_per_row, n)
    del row_mask
    # the lists' padding (position n) covers no tile, so the tile level
    # reads only the columns some row fills
    width = max(int(row_counts.max()), 1) if row_counts.numel() else 1
    row_lists = row_lists[:, :width]

    # level 2: per tile, from its row's list; position n covers no column
    big = torch.full((nv, 1), grid_x, dtype=torch.int32, device=dev)
    xmin_pad = torch.cat([rmin[..., 0], big], 1).reshape(-1)
    xmax_pad = torch.cat([rmax[..., 0], torch.full_like(big, -1)],
                         1).reshape(-1)
    view_of_row = torch.arange(nv, device=dev).repeat_interleave(grid_y)
    cols = torch.arange(grid_x, dtype=torch.int32, device=dev)
    block = max(1, COMPACT_BLOCK_ELEMS // (grid_x * width))
    lists, counts = [], []
    for r0 in range(0, nv * grid_y, block):
        rl = row_lists[r0:r0 + block]  # (Rb, width)
        at = rl + (view_of_row[r0:r0 + block] * (n + 1))[:, None]
        gx_min, gx_max = xmin_pad[at], xmax_pad[at]
        mask = ((cols[None, :, None] >= gx_min[:, None, :])
                & (cols[None, :, None] < gx_max[:, None, :]))
        tl, tc = _compact(mask.reshape(-1, width),
                          rl[:, None, :].expand(-1, grid_x, -1).reshape(
                              -1, width), max_per_tile, n)
        lists.append(tl)
        counts.append(tc)
    tile_lists = torch.cat(lists).reshape(nv, grid_y * grid_x, max_per_tile)
    tile_counts = torch.cat(counts).reshape(nv, grid_y * grid_x)
    # depth position → the view's Gaussian index; the padding n → -1
    order_pad = torch.cat([order, torch.full((nv, 1), -1, dtype=order.dtype,
                                             device=dev)], 1)
    idx_table = torch.gather(order_pad, 1, tile_lists.reshape(nv, -1).long())
    return (idx_table.reshape(nv, grid_y * grid_x, max_per_tile).to(
        torch.int32), tile_counts.to(torch.int32))
