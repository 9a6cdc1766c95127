"""Seeded expansion ids for checking the segmented scan
(``ops/segred.py``): contiguous runs of equal ids with ``-1`` pad runs, as
``build_tile_pairs`` lays them out, and the cases at the edges of the
CUDA kernel's tiles (1024 pairs at 16 lanes, 512 at 32) and of its
look-back window (128 tiles). ``chip_smoke.py`` holds the kernel to its
plain version on them at 2^20 and 2^21 rows; the CPU tests hold the plain
version to the JAX kernel on the same patterns at a few thousand rows.
"""

from __future__ import annotations

import numpy as np


def synthetic_scan_ids(seed, n=1 << 21):
    """(n,) int32 ids with runs of 1 to 5 000 rows, many spanning several
    1 024-row tiles, and pad runs (id -1) between them."""
    rng = np.random.RandomState(seed)
    kind = rng.choice(3, size=max(n // 8, 1), p=[0.7, 0.25, 0.05])
    lengths = np.where(kind == 0, rng.randint(1, 30, kind.size),
                       np.where(kind == 1, rng.randint(30, 1000, kind.size),
                                rng.randint(1000, 5000, kind.size)))
    lengths = lengths[:np.searchsorted(np.cumsum(lengths), n)]
    ids = np.where(rng.rand(lengths.size) < 0.1, -1, np.arange(lengths.size))
    out = np.repeat(ids, lengths)
    return np.concatenate([out, np.full(n - out.size, -1)]).astype(np.int32)


def scan_edge_ids(seed=0, n=1 << 20):
    """{case: (rows,) int32 ids}: one run over a quarter of the rows (256
    tiles of 1024 at n = 2^20, past the look-back window) between short
    runs; runs that each end on a 512-row edge; singletons only; ``n - 77``
    rows (no multiple of a tile, nor of the kernel's 4-pair vectors: its
    scalar path) of synthetic runs; a leading pad run (id -1) over a
    quarter of the rows before synthetic runs."""
    rng = np.random.RandomState(seed)
    short = rng.randint(1, 30, n // 8)
    long_run = np.concatenate([short[:n // 200], [n // 4], short[n // 200:]])
    edges = 512 * rng.randint(1, 9, max(n // 512, 1))
    pad = np.full(n // 4, -1)

    def runs(lengths, m):
        lengths = lengths[:np.searchsorted(np.cumsum(lengths), m) + 1]
        return np.repeat(np.arange(lengths.size), lengths)[:m]

    return {
        "long_run": runs(long_run, n).astype(np.int32),
        "tile_edges": runs(edges, n).astype(np.int32),
        "singletons": np.arange(n, dtype=np.int32),
        "ragged": synthetic_scan_ids(seed, n)[:n - 77],
        "leading_pad": np.concatenate(
            [pad, synthetic_scan_ids(seed, n - pad.size)]).astype(np.int32),
    }
