"""Per-tile index tables of the tile renderer.

Counterpart of ``igs_tpu/ops/render_tiles.py``, of which only
``pairs_to_idx_table`` is ported: the profiler's binning stage builds it.
The rest of that module, the XLA tile renderer behind the
``impl="tiles"`` oracle, is not ported (ROADMAP A6).
"""

from __future__ import annotations

import torch

from igs_tpu_torch.ops.binning import TilePairs


def pairs_to_idx_table(pairs: TilePairs, max_per_tile: int) -> torch.Tensor:
    """(T, max_per_tile) int32 per-tile Gaussian ids from the sorted pairs,
    -1 past each tile's count (pairs past ``max_per_tile`` dropped)."""
    j = torch.arange(max_per_tile, dtype=torch.int32,
                     device=pairs.tile_start.device)
    pos = pairs.tile_start[:, None] + j[None, :]
    in_range = j[None, :] < pairs.tile_count[:, None]
    pos = torch.clamp_max(pos, pairs.gauss_id.shape[0] - 1)
    return torch.where(in_range, pairs.gauss_id[pos.long()],
                       torch.full_like(pos, -1))
