"""Contribution counting (LightGaussian importance): the CUDA kernel, its
plain PyTorch version, and the per-Gaussian rows they read.

Counterpart of ``count_contributions_pallas`` in
``igs_tpu/ops/pallas_blend.py`` (the ``_count_kernel`` Pallas kernel and
the ``segment_sum`` after it). Per (view, Gaussian) row: the number of
pixels whose accepted contributor set holds the row, walking each tile's
depth-ordered pair segment as the forward blend does. Pixels outside the
image start done.

The JAX package walks a windowed ``(T, max_per_tile)`` index table and so
counts at most ``max_per_tile`` pairs of a tile; the port walks the packed
pair list (``TilePairs``) and counts every pair of every tile.

On CUDA tensors ``count_contributions_packed`` launches the count entry
of ``csrc/blend_fwd.cu`` (the packed forward's walk in a count mode) or
raises; on CPU tensors it runs the plain version, vectorised over tiles
and pixels with 128-pair chunks whose transmittance is the log-space
prefix sum.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from igs_tpu_torch.ops.blend import LOG_TERM, MIN_ALPHA, P
from igs_tpu_torch.ops.projection import ProjectedGaussians, TILE_X, TILE_Y
from igs_tpu_torch.utils.profiling import launched

LANES = 6  # xy, conic (3), opacity


def count_rows(proj: ProjectedGaussians) -> torch.Tensor:
    """(V·N, 6) contiguous rows [x, y, c0, c1, c2, opacity]."""
    rows = torch.cat([proj.means2d, proj.conic, proj.opacity.unsqueeze(-1)],
                     dim=-1)
    return rows.reshape(-1, LANES).contiguous()


def _check(rows, gauss_id, tile_start, tile_count, grid_x, grid_y):
    if rows.dim() != 2 or rows.shape[1] != LANES or rows.dtype != torch.float32:
        raise ValueError(f"rows must be float32 (R, {LANES}), got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    for name, x in (("gauss_id", gauss_id), ("tile_start", tile_start),
                    ("tile_count", tile_count)):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
    if tile_start.shape != tile_count.shape:
        raise ValueError("tile_start and tile_count differ in shape")
    if tile_count.shape[0] % (grid_x * grid_y):
        raise ValueError(f"{tile_count.shape[0]} tiles are not whole views of "
                         f"{grid_x}x{grid_y} tiles")


def count_contributions_packed_cuda(rows, gauss_id, tile_start, tile_count,
                                    grid_x: int, grid_y: int, width: int,
                                    height: int) -> torch.Tensor:
    """Launch ``csrc/blend_fwd.cu``'s count entry on the current stream →
    (R,) int32.

    The packed forward's walk (B1: candidate-box skip, ``cp.async``
    stages of 256 pairs, deepest tiles first, 8×4 warp rectangles, two
    pairs in flight, the early exit) with each pair's row read through
    ``gauss_id`` and the pixels outside the image started done. Per
    walked pair each warp adds the popcount of its accepting pixels to a
    shared counter; after the stage one integer ``atomicAdd`` per pair
    with a nonzero count: exact, so bitwise repeatable. Every pixel takes
    the forward's pairs with its rounding (C7), so the total equals the
    packed forward's accepted pixel-pairs inside the image.
    """
    _check(rows, gauss_id, tile_start, tile_count, grid_x, grid_y)
    for name, x in (("rows", rows), ("gauss_id", gauss_id),
                    ("tile_start", tile_start), ("tile_count", tile_count)):
        if not x.is_cuda or x.device != rows.device:
            raise ValueError(f"{name} must be on {rows.device} (CUDA)")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fn, error_string = _kernel()
    num_tiles = tile_count.shape[0]
    counts = torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
    order = torch.empty(num_tiles, dtype=torch.int32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), gauss_id.data_ptr(), tile_start.data_ptr(),
                 tile_count.data_ptr(), order.data_ptr(), num_tiles, grid_x,
                 grid_x * grid_y, width, height, counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("count_contributions_packed launch failed: "
                           + error_string(err).decode())
    if num_tiles:
        launched(count_contributions_packed_cuda)
    return counts


# launches of the kernel since the last reset
count_contributions_packed_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    from igs_tpu_torch.ops.cuda_build import load

    lib = load("blend_fwd.cu")
    fn = lib.igs_count_contributions_packed
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    err = lib.igs_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def count_contributions_packed_plain(rows, gauss_id, tile_start, tile_count,
                                     grid_x: int, grid_y: int, width: int,
                                     height: int, chunk: int = 128,
                                     tile_block: int = 1024) -> torch.Tensor:
    """Same inputs and output as the kernel, in plain PyTorch."""
    _check(rows, gauss_id, tile_start, tile_count, grid_x, grid_y)
    dev = rows.device
    num_tiles = tile_count.shape[0]
    tiles_per_view = grid_x * grid_y
    mp = gauss_id.shape[0]
    counts = torch.zeros(rows.shape[0], dtype=torch.int64, device=dev)
    pidx = torch.arange(P, device=dev)
    kk = torch.arange(chunk, device=dev)
    for t0 in range(0, num_tiles, tile_block):
        tiles = torch.arange(t0, min(num_tiles, t0 + tile_block), device=dev)
        start = tile_start[tiles].long()
        count = tile_count[tiles].long()
        lt = tiles % tiles_per_view
        px = ((lt % grid_x) * TILE_X)[:, None] + pidx % TILE_X
        py = ((lt // grid_x) * TILE_Y)[:, None] + pidx // TILE_X
        done = (px >= width) | (py >= height)
        px, py = px.float(), py.float()
        logt = torch.zeros(done.shape, device=dev)
        nmax = int(count.max()) if tiles.numel() else 0
        for c0 in range(0, nmax, chunk):
            act = torch.nonzero((count > c0) & ~done.all(dim=1))[:, 0]
            if act.numel() == 0:
                break
            slot = c0 + kk
            live = slot[None, :] < count[act, None]  # (A, K)
            col = torch.clamp(start[act, None] + slot[None, :],
                              max=max(mp - 1, 0))
            gid = gauss_id[col].long()
            live = live & (gid >= 0)
            f = rows[gid.clamp_min(0)]  # (A, K, 6)
            dx = f[:, None, :, 0] - px[act][:, :, None]  # (A, P, K)
            dy = f[:, None, :, 1] - py[act][:, :, None]
            power = (-0.5 * (f[:, None, :, 2] * dx * dx
                             + f[:, None, :, 4] * dy * dy)
                     - f[:, None, :, 3] * dx * dy)
            alpha = torch.clamp_max(
                f[:, None, :, 5] * torch.exp(torch.clamp_max(power, 0.0)),
                0.99)
            cand = live[:, None, :] & (power <= 0.0) & (alpha >= MIN_ALPHA)
            a = torch.where(cand, alpha, torch.zeros_like(alpha))
            log1m = torch.log1p(-a)
            cum = logt[act][:, :, None] + torch.cumsum(log1m, dim=-1)
            alive = cum >= LOG_TERM
            accept = cand & alive & ~done[act][:, :, None]
            per_slot = accept.sum(dim=1)  # (A, K) pixels per pair
            counts.index_add_(0, gid[live], per_slot[live])
            logt[act] = logt[act] + torch.where(
                accept, log1m, torch.zeros_like(log1m)).sum(-1)
            done[act] = done[act] | (cand & ~alive).any(dim=-1)
    return counts.to(torch.int32)


def count_contributions_packed(rows, gauss_id, tile_start, tile_count,
                               grid_x: int, grid_y: int, width: int,
                               height: int) -> torch.Tensor:
    """(R,) int32 accepted-contribution counts per row: a CUDA tensor goes
    to the kernel, a CPU tensor to the plain version."""
    if rows.is_cuda:
        return count_contributions_packed_cuda(
            rows, gauss_id, tile_start, tile_count, grid_x, grid_y, width,
            height)
    if rows.device.type != "cpu":
        raise ValueError(f"no contribution count for device {rows.device}")
    return count_contributions_packed_plain(
        rows, gauss_id, tile_start, tile_count, grid_x, grid_y, width, height)
