"""Windowed blend, forward and backward: the CUDA kernels, their plain
PyTorch versions, and the window gather around them.

Counterpart of the windowed half of ``igs_tpu/ops/pallas_blend.py``:
``gather_tile_windows``, ``blend_raw`` with its VJP ``_blend_raw_bwd``,
and ``render_tiles_pallas`` (``impl="pallas"``).

Each tile reads a window of ``max_per_tile`` rows of 32 feature lanes:
row r of tile t is pair ``tile_start[t] + r`` of the tile-sorted pair
list, and the tile walks rows ``[0, counts[t])`` with ``counts =
min(tile_count, max_per_tile)``; pairs past the window are dropped (the
rasterizer reports the truncated tiles). Rows past a tile's count alias
the next tile's pairs and are never read; the last tile's window runs
into ``max_per_tile`` zero rows of padding.

The raw block is (T, 256, 24) in every mode, as the TPU kernel writes it:
[C(3) | W | coord(3) | D | nrm(3) | mcoord(3) | mdepth_t | logT |
n_contrib | med_pos | pad(6)], the geometry lanes zero in color mode and
the median lanes zero (med_pos -1) outside full mode.

``_BlendRaw`` is the ``torch.autograd.Function`` over the pair features:
its forward gathers the windows and blends them, its backward gathers
them again (a pure gather, rebuilt rather than kept: one view's windows
at 512² and ``max_per_tile`` 8192 take 1 GiB), runs the backward and
folds the per-slot grads back to pair rows. A live row is exactly one
pair, so the fold is a copy, not a sum. On CUDA tensors forward and
backward launch the hand-written kernels (``csrc/blend_win_fwd.cu``,
``csrc/blend_win_bwd.cu``) or raise; on CPU tensors they run the plain
versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from igs_tpu_torch.ops.binning import TilePairs
from igs_tpu_torch.ops.blend import (
    MODES, P, RenderOutputs, pack_features, plain_tiles, plain_tiles_bwd,
    raw_to_outputs)
from igs_tpu_torch.ops.projection import ProjectedGaussians, TILE_X, TILE_Y
from igs_tpu_torch.ops.segred import gather_pairs

LANES = 32  # feature lanes of a window row
RAW_LANES = 24


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------


def gather_tile_windows(feats_t: torch.Tensor, tile_start: torch.Tensor,
                        max_per_tile: int) -> torch.Tensor:
    """(lanes, pairs) pair features → (T, max_per_tile, lanes) windows:
    row r of tile t is pair ``tile_start[t] + r``, zero past the list."""
    lanes = feats_t.shape[0]
    rows = torch.cat([feats_t.t(), feats_t.new_zeros((max_per_tile, lanes))])
    idx = (tile_start.long()[:, None]
           + torch.arange(max_per_tile, device=feats_t.device))
    return rows[idx]


def fold_tile_windows(dwindows: torch.Tensor, tile_start: torch.Tensor,
                      counts: torch.Tensor, num_pairs: int) -> torch.Tensor:
    """The gather's transpose on the live rows: (T, max_per_tile, lanes)
    per-slot grads → (lanes, num_pairs), pair ``tile_start[t] + r`` taking
    row r of tile t for r < counts[t]; other pairs take zero. Live rows
    of different tiles are different pairs, so no sum is needed."""
    maxpt = dwindows.shape[1]
    live = (torch.arange(maxpt, device=dwindows.device)[None, :]
            < counts.long()[:, None])
    cols = (tile_start.long()[:, None]
            + torch.arange(maxpt, device=dwindows.device))[live]
    out = dwindows.new_zeros((dwindows.shape[2], num_pairs))
    out[:, cols] = dwindows[live].t()
    return out


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _check_windows(windows, counts, grid_x, grid_y, mode):
    if mode not in MODES:
        raise ValueError(f"unknown blend mode {mode!r}")
    if windows.dim() != 3 or windows.shape[2] != LANES:
        raise ValueError(f"windows must be (tiles, max_per_tile, {LANES}), "
                         f"got {tuple(windows.shape)}")
    if windows.dtype != torch.float32:
        raise TypeError(f"windows must be float32, got {windows.dtype}")
    if counts.dtype != torch.int32 or counts.dim() != 1:
        raise TypeError("counts must be a 1-D int32 tensor")
    if counts.shape[0] != windows.shape[0]:
        raise ValueError(f"{counts.shape[0]} counts for {windows.shape[0]} "
                         "windows")
    if counts.shape[0] % (grid_x * grid_y):
        raise ValueError(f"{counts.shape[0]} tiles are not whole views of "
                         f"{grid_x}x{grid_y} tiles")


def _check_raw(windows, raw, cot):
    want = (windows.shape[0], P, RAW_LANES)
    for name, x in (("raw", raw), ("cot", cot)):
        if tuple(x.shape) != want or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {want}, got "
                             f"{x.dtype} {tuple(x.shape)}")


def _check_cuda(ref, named):
    for name, x in named:
        if not x.is_cuda or x.device != ref.device:
            raise ValueError(f"{name} must be on {ref.device} (CUDA)")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ref.data_ptr() % 16:  # the kernels move window rows as float4
        raise ValueError("windows must be 16-byte aligned")


def _library(source: str, symbol: str, n_ptr_args: int):
    from igs_tpu_torch.ops.cuda_build import load

    lib = load(source)
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * n_ptr_args)
    fn.restype = ctypes.c_int
    err = lib.igs_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    return _library("blend_win_fwd.cu", "igs_blend_fwd_windowed", 2)


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    return _library("blend_win_bwd.cu", "igs_blend_bwd_windowed", 4)


def blend_raw_cuda(windows: torch.Tensor, counts: torch.Tensor, grid_x: int,
                   grid_y: int, mode: str) -> torch.Tensor:
    """Launch ``csrc/blend_win_fwd.cu`` on the current stream →
    (T, 256, 24) raw accumulators."""
    _check_windows(windows, counts, grid_x, grid_y, mode)
    _check_cuda(windows, (("windows", windows), ("counts", counts)))
    fn, error_string = _fwd_kernel()
    num_tiles = counts.shape[0]
    out = torch.empty((num_tiles, P, RAW_LANES), dtype=torch.float32,
                      device=windows.device)
    with torch.cuda.device(windows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(windows.data_ptr(), windows.shape[1], counts.data_ptr(),
                 num_tiles, grid_x, grid_x * grid_y, MODES[mode],
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("blend_fwd_win launch failed: "
                           + error_string(err).decode())
    if num_tiles:
        blend_raw_cuda.launches += 1
        blend_raw_cuda.launches_by_mode[mode] += 1
    return out


# launches of the kernel (and per mode) since the last reset; the
# comparison runs of chip_smoke.py reset them before each path
blend_raw_cuda.launches = 0
blend_raw_cuda.launches_by_mode = dict.fromkeys(MODES, 0)


def blend_raw_bwd_cuda(windows: torch.Tensor, counts: torch.Tensor,
                       grid_x: int, grid_y: int, mode: str, raw: torch.Tensor,
                       cot: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/blend_win_bwd.cu`` on the current stream → per-slot
    grads shaped like ``windows``; slots the walk never reaches, and the
    lanes the mode does not read, come back zero."""
    _check_windows(windows, counts, grid_x, grid_y, mode)
    _check_raw(windows, raw, cot)
    _check_cuda(windows, (("windows", windows), ("counts", counts),
                          ("raw", raw), ("cot", cot)))
    fn, error_string = _bwd_kernel()
    num_tiles = counts.shape[0]
    dwindows = torch.empty_like(windows)
    with torch.cuda.device(windows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(windows.data_ptr(), windows.shape[1], counts.data_ptr(),
                 num_tiles, grid_x, grid_x * grid_y, MODES[mode],
                 raw.data_ptr(), cot.data_ptr(), dwindows.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("blend_bwd_win launch failed: "
                           + error_string(err).decode())
    if num_tiles:
        blend_raw_bwd_cuda.launches += 1
        blend_raw_bwd_cuda.launches_by_mode[mode] += 1
    return dwindows


blend_raw_bwd_cuda.launches = 0
blend_raw_bwd_cuda.launches_by_mode = dict.fromkeys(MODES, 0)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _window_fetch(windows, tiles, chunk):
    """Chunk reader of the windows of ``tiles`` → ((A, K, 32) rows, (K,)
    slots); the last chunk of a window may be short."""
    def fetch(act, c0):
        f = windows[tiles[act], c0:c0 + chunk]
        return f, c0 + torch.arange(f.shape[1], device=windows.device)
    return fetch


def blend_raw_plain(windows: torch.Tensor, counts: torch.Tensor, grid_x: int,
                    grid_y: int, mode: str, chunk: int = 128,
                    tile_block: int = 1024) -> torch.Tensor:
    """Same inputs and output as the forward kernel, in plain PyTorch:
    vectorised over tiles and pixels, ``chunk``-row chunks with log-space
    prefix sums inside a chunk, as the TPU kernel."""
    _check_windows(windows, counts, grid_x, grid_y, mode)
    num_tiles = counts.shape[0]
    out = torch.zeros((num_tiles, P, RAW_LANES), dtype=torch.float32,
                      device=windows.device)
    for t0 in range(0, num_tiles, tile_block):
        tiles = torch.arange(t0, min(num_tiles, t0 + tile_block),
                             device=windows.device)
        out[tiles] = plain_tiles(_window_fetch(windows, tiles, chunk),
                                 counts[tiles].long(), tiles, grid_x,
                                 grid_x * grid_y, mode, chunk, RAW_LANES)
    return out


def blend_raw_bwd_plain(windows: torch.Tensor, counts: torch.Tensor,
                        grid_x: int, grid_y: int, mode: str,
                        raw: torch.Tensor, cot: torch.Tensor,
                        chunk: int = 128,
                        tile_block: int = 1024) -> torch.Tensor:
    """Same inputs and output as the backward kernel, in plain PyTorch:
    the walk back from each tile's largest ``n_contrib``, T recovered from
    the final logT and the suffix sums carried in float64."""
    _check_windows(windows, counts, grid_x, grid_y, mode)
    _check_raw(windows, raw, cot)
    num_tiles = counts.shape[0]
    dwindows = torch.zeros_like(windows)
    for t0 in range(0, num_tiles, tile_block):
        tiles = torch.arange(t0, min(num_tiles, t0 + tile_block),
                             device=windows.device)
        def store(act, slot, live, grads, tiles=tiles):
            ai, ki = torch.nonzero(live, as_tuple=True)
            dwindows[tiles[act][ai], slot[ki], :grads.shape[-1]] = grads[ai, ki]

        plain_tiles_bwd(_window_fetch(windows, tiles, chunk), store,
                        counts[tiles].long(), tiles, grid_x, grid_x * grid_y,
                        mode, chunk, raw[tiles], cot[tiles])
    return dwindows


def blend_raw_fwd(windows, counts, grid_x, grid_y, mode, chunk=128):
    """A CUDA tensor goes to the forward kernel, a CPU tensor to its plain
    version."""
    if windows.is_cuda:
        return blend_raw_cuda(windows, counts, grid_x, grid_y, mode)
    if windows.device.type != "cpu":
        raise ValueError(f"no windowed blend for device {windows.device}")
    return blend_raw_plain(windows, counts, grid_x, grid_y, mode, chunk)


def blend_raw_bwd(windows, counts, grid_x, grid_y, mode, raw, cot, chunk=128):
    """A CUDA tensor goes to the backward kernel, a CPU tensor to its plain
    version."""
    if windows.is_cuda:
        return blend_raw_bwd_cuda(windows, counts, grid_x, grid_y, mode, raw,
                                  cot)
    if windows.device.type != "cpu":
        raise ValueError(f"no windowed blend backward for device "
                         f"{windows.device}")
    return blend_raw_bwd_plain(windows, counts, grid_x, grid_y, mode, raw,
                               cot, chunk)


class _BlendRaw(torch.autograd.Function):
    """(lanes, pairs) pair features → (T, 256, 24) raw, through the windows
    of ``max_per_tile`` rows, with the analytic backward."""

    @staticmethod
    def forward(ctx, feats_t, tile_start, counts, max_per_tile, grid_x,
                grid_y, mode, chunk):
        windows = gather_tile_windows(feats_t, tile_start, max_per_tile)
        raw = blend_raw_fwd(windows, counts, grid_x, grid_y, mode, chunk)
        ctx.save_for_backward(feats_t, tile_start, counts, raw)
        ctx.static = (max_per_tile, grid_x, grid_y, mode, chunk)
        return raw

    @staticmethod
    def backward(ctx, cot):
        feats_t, tile_start, counts, raw = ctx.saved_tensors
        max_per_tile, grid_x, grid_y, mode, chunk = ctx.static
        windows = gather_tile_windows(feats_t, tile_start, max_per_tile)
        dwindows = blend_raw_bwd(windows, counts, grid_x, grid_y, mode, raw,
                                 cot.contiguous(), chunk)
        del windows
        dfeats = fold_tile_windows(dwindows, tile_start, counts,
                                   feats_t.shape[1])
        return dfeats, None, None, None, None, None, None, None


def blend_raw(feats_t, tile_start, counts, max_per_tile: int, grid_x: int,
              grid_y: int, mode: str = "full", chunk: int = 128):
    """Windowed blend of the (lanes, pairs) pair features, differentiable
    with respect to ``feats_t``; ``counts`` ≤ ``max_per_tile``."""
    return _BlendRaw.apply(feats_t, tile_start, counts, max_per_tile, grid_x,
                           grid_y, mode, chunk)


def render_tiles_windowed(proj: ProjectedGaussians, pairs: TilePairs,
                          height: int, width: int, focal_x, focal_y,
                          bg: torch.Tensor, max_per_tile: int,
                          mode: str = "full",
                          chunk: int = 128) -> RenderOutputs:
    """Gather per-pair features, blend every view's tile windows in one
    launch, untile (the 24-lane raw in every mode, as the TPU path)."""
    grid_x = (width + TILE_X - 1) // TILE_X
    grid_y = (height + TILE_Y - 1) // TILE_Y
    views = proj.depth.shape[0]
    rows = pack_features(proj).reshape(-1, LANES).t().contiguous()
    if pairs.gauss_last_row.numel():
        # backward: inverse permutation + segmented scan, no scatter
        feats_t = gather_pairs(rows, pairs.gauss_id, pairs.exp_to_sorted,
                               pairs.exp_gauss_id, pairs.gauss_last_row)
    else:
        feats_t = torch.index_select(rows, 1,
                                     pairs.gauss_id.clamp_min(0).long())
    counts = torch.clamp_max(pairs.tile_count, max_per_tile)
    raw = blend_raw(feats_t, pairs.tile_start, counts, max_per_tile, grid_x,
                    grid_y, mode, chunk)
    return raw_to_outputs(raw, views, grid_x, grid_y, height, width, focal_x,
                          focal_y, bg)
