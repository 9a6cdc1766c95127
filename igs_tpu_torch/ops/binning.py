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


def build_tile_pairs(proj: ProjectedGaussians, grid_x: int, grid_y: int,
                     max_pairs: int, segred_aux: bool = False) -> TilePairs:
    nv, n = proj.depth.shape
    num_tiles = grid_x * grid_y
    dev = proj.depth.device

    # 1. stable depth sort per view (invisible → +inf, pushed to the end)
    depth_key = torch.where(proj.visible, proj.depth,
                            torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(depth_key, dim=-1, stable=True)  # (V, N)
    rect_min = torch.gather(proj.rect_min, 1, order[..., None].expand(-1, -1, 2))
    rect_max = torch.gather(proj.rect_max, 1, order[..., None].expand(-1, -1, 2))
    tt = torch.gather(proj.tiles_touched, 1, order).to(torch.int64)

    # 2. expand (gaussian, tile) pairs in depth order under the budget
    offsets = torch.cumsum(tt, dim=1)
    total = offsets[:, -1]
    base = offsets - tt
    kept = torch.clamp(torch.minimum(tt, max_pairs - base), min=0).reshape(-1)
    rows = torch.repeat_interleave(
        torch.arange(nv * n, device=dev), kept)  # one host sync (its size)
    row_start = torch.cumsum(kept, 0) - kept
    local = torch.arange(rows.shape[0], device=dev) - row_start[rows]
    view = rows // n
    x0 = rect_min[..., 0].reshape(-1)[rows].to(torch.int64)
    y0 = rect_min[..., 1].reshape(-1)[rows].to(torch.int64)
    rw = torch.clamp(rect_max[..., 0] - rect_min[..., 0], min=1).reshape(-1)[
        rows].to(torch.int64)
    q = torch.div(local, rw, rounding_mode="floor")
    tile = view * num_tiles + (y0 + q) * grid_x + x0 + (local - q * rw)
    slot = view * max_pairs + base.reshape(-1)[rows] + local

    tile_full = torch.full((nv * max_pairs,), nv * num_tiles,
                           dtype=torch.int32, device=dev)
    tile_full[slot] = tile.to(torch.int32)
    gauss_full = torch.full((nv * max_pairs,), -1, dtype=torch.int32,
                            device=dev)
    gauss_full[slot] = (view * n + order.reshape(-1)[rows]).to(torch.int32)

    # 3. stable tile sort — depth order preserved within each tile
    tile_sorted, perm = torch.sort(tile_full, stable=True)
    gauss_sorted = gauss_full[perm]

    # 4. tile ranges by binary search over the sorted ids
    bounds = torch.searchsorted(
        tile_sorted, torch.arange(nv * num_tiles + 1, dtype=torch.int32,
                                  device=dev))

    # 5. segmented grad-reduction aux: the inverse of the tile sort, and
    # per (V·N) row the slot of its last kept pair (rows in original order)
    if segred_aux:
        exp_to_sorted = torch.empty_like(perm)
        exp_to_sorted[perm] = torch.arange(perm.shape[0], device=dev)
        view_base = torch.arange(nv, device=dev)[:, None] * max_pairs
        last = view_base + torch.clamp(offsets, max=max_pairs) - 1
        last = torch.where(kept.reshape(nv, n) > 0, last,
                           torch.full_like(last, -1))
        gauss_last_row = torch.empty_like(last)
        gauss_last_row.scatter_(1, order, last)
        gauss_last_row = gauss_last_row.reshape(-1)
        exp_gauss_id = gauss_full
    else:
        exp_to_sorted = gauss_last_row = torch.zeros(
            0, dtype=torch.int64, device=dev)
        exp_gauss_id = torch.zeros(0, dtype=torch.int32, device=dev)
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
