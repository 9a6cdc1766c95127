"""Windowed blend, forward and backward: the CUDA kernels, their plain
PyTorch versions, and the window gather of the plain versions.

Counterpart of the windowed half of ``igs_tpu/ops/pallas_blend.py``:
``gather_tile_windows``, ``blend_raw`` with its VJP ``_blend_raw_bwd``,
and ``render_tiles_pallas`` (``impl="pallas"``).

On the TPU each tile reads a window of ``max_per_tile`` rows of 32
feature lanes: row r of tile t is pair ``tile_start[t] + r`` of the
tile-sorted pair list, and the tile walks rows ``[0, counts[t])`` with
``counts = min(tile_count, max_per_tile)``; pairs past the window are
dropped (the rasterizer reports the truncated tiles). Rows past a tile's
count alias the next tile's pairs and are never read; the last tile's
window runs into ``max_per_tile`` zero rows of padding.

The raw block is (T, 256, 24) in every mode, as the TPU kernel writes it:
[C(3) | W | coord(3) | D | nrm(3) | mcoord(3) | mdepth_t | logT |
n_contrib | med_pos | pad(6)], the geometry lanes zero in color mode and
the median lanes zero (med_pos -1) outside full mode.

``_BlendRaw`` is the ``torch.autograd.Function`` over the pair features.
The port gathers no window: its forward and backward kernels read the
pair rows at ``tile_start`` (a live row is exactly one pair) and the
backward writes (32, pairs) grads directly, so neither the window (one
view's at 512² and ``max_per_tile`` 8192 takes 1 GiB) nor the fold of
the per-slot grads through the gather exists. On CUDA tensors forward
and backward launch the hand-written kernels (``csrc/blend_fwd.cu``'s
and ``csrc/blend_bwd.cu``'s windowed entries: the packed kernels' bodies
with the windowed raw layout) or raise; on CPU tensors they run the
plain versions, which gather the tiles' largest count of rows and run
the TPU kernels' computation over those windows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from igs_tpu_torch.ops.binning import TilePairs
from igs_tpu_torch.ops.blend import (
    MODES, P, RenderOutputs, _check_inputs, pack_features, plain_tiles,
    plain_tiles_bwd, raw_to_outputs)
from igs_tpu_torch.ops.projection import ProjectedGaussians, TILE_X, TILE_Y
from igs_tpu_torch.ops.segred import gather_pairs
from igs_tpu_torch.utils.profiling import launched

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


def _check_raw(num_tiles, raw, cot):
    want = (num_tiles, P, RAW_LANES)
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


def _library(source: str, symbol: str, argtypes):
    from igs_tpu_torch.ops.cuda_build import load

    lib = load(source)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = lib.igs_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    # blend_fwd.cu's windowed entry: the packed forward's arguments
    return _library("blend_fwd.cu", "igs_blend_fwd_windowed",
                    [_PTR, ctypes.c_longlong] + [_PTR] * 3 + [_INT] * 4
                    + [_PTR] * 2)


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    # blend_bwd.cu's windowed entry: the packed backward's arguments
    return _library("blend_bwd.cu", "igs_blend_bwd_windowed",
                    [_PTR, ctypes.c_longlong] + [_PTR] * 3 + [_INT] * 4
                    + [_PTR] * 4)


def _check_pairs(feats_t, tile_start, counts, grid_x, grid_y, mode):
    # the packed route's checks, with counts as the tile counts, and the
    # windowed route's 32-lane pack
    _check_inputs(feats_t, tile_start, counts, grid_x, grid_y, mode)
    if feats_t.shape[0] != LANES:
        raise ValueError(f"feats_t must be ({LANES}, pairs), got "
                         f"{tuple(feats_t.shape)}")


def blend_raw_cuda(feats_t: torch.Tensor, tile_start: torch.Tensor,
                   counts: torch.Tensor, grid_x: int, grid_y: int,
                   mode: str) -> torch.Tensor:
    """Launch ``csrc/blend_fwd.cu``'s windowed entry on the current stream
    → (T, 256, 24) raw accumulators: tile t blends pairs ``tile_start[t]
    + r``, ``r < counts[t]``, the rows of its window the TPU kernel reads.

    The packed forward's kernel (B1: candidate-box skip, ``cp.async``
    stages, deepest tiles first, 8×4 warp rectangles, two pairs in flight,
    the early exit; ``blend.blend_raw_packed_cuda``) with the windowed raw
    layout, 24 lanes in every mode, and ``tile_count := counts``. Where no
    tile truncates, bit-equal to the packed forward in every lane both
    write. No window is gathered.
    """
    _check_pairs(feats_t, tile_start, counts, grid_x, grid_y, mode)
    _check_cuda(feats_t, (("feats_t", feats_t), ("tile_start", tile_start),
                          ("counts", counts)))
    fn, error_string = _fwd_kernel()
    num_tiles = counts.shape[0]
    out = torch.empty((num_tiles, P, RAW_LANES), dtype=torch.float32,
                      device=feats_t.device)
    order = torch.empty(num_tiles, dtype=torch.int32, device=feats_t.device)
    with torch.cuda.device(feats_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feats_t.data_ptr(), feats_t.shape[1], tile_start.data_ptr(),
                 counts.data_ptr(), order.data_ptr(), num_tiles, grid_x,
                 grid_x * grid_y, MODES[mode], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("blend_fwd_win launch failed: "
                           + error_string(err).decode())
    if num_tiles:
        launched(blend_raw_cuda, mode)
    return out


# launches of the kernel (and per mode) since the last reset; the
# comparison runs of chip_smoke.py reset them before each path
blend_raw_cuda.launches = 0
blend_raw_cuda.launches_by_mode = dict.fromkeys(MODES, 0)


def _check_pairs_bwd(feats_t, tile_start, counts, grid_x, grid_y, mode, raw,
                     cot):
    _check_pairs(feats_t, tile_start, counts, grid_x, grid_y, mode)
    _check_raw(counts.shape[0], raw, cot)


def blend_raw_bwd_cuda(feats_t: torch.Tensor, tile_start: torch.Tensor,
                       counts: torch.Tensor, grid_x: int, grid_y: int,
                       mode: str, raw: torch.Tensor,
                       cot: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/blend_bwd.cu``'s windowed entry on the current stream
    → (32, pairs) grads of the pair features: pair ``tile_start[t] + r``
    with ``r < counts[t]`` takes the TPU kernel's grad of row r of tile
    t's window; every other entry (rows the walk never reaches, pairs past
    a truncated window, padding, the lanes the mode does not read) is
    zero.

    The packed backward's kernel (B2: candidate-box skip, ``cp.async``
    stages, deepest tiles first, 8×4 warp rectangles, transpose-reduce,
    Kahan T recovery; ``blend.blend_raw_packed_bwd_cuda``) with the
    windowed raw layout, (T, 256, 24) in every mode, and ``tile_count :=
    counts``. Each pair is written by the one block that owns its tile:
    bitwise repeatable.
    """
    _check_pairs_bwd(feats_t, tile_start, counts, grid_x, grid_y, mode, raw,
                     cot)
    _check_cuda(feats_t, (("feats_t", feats_t), ("tile_start", tile_start),
                          ("counts", counts), ("raw", raw), ("cot", cot)))
    fn, error_string = _bwd_kernel()
    num_tiles = counts.shape[0]
    dfeats = torch.zeros_like(feats_t)
    order = torch.empty(num_tiles, dtype=torch.int32, device=feats_t.device)
    with torch.cuda.device(feats_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feats_t.data_ptr(), feats_t.shape[1], tile_start.data_ptr(),
                 counts.data_ptr(), order.data_ptr(), num_tiles, grid_x,
                 grid_x * grid_y, MODES[mode], raw.data_ptr(), cot.data_ptr(),
                 dfeats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("blend_bwd_win launch failed: "
                           + error_string(err).decode())
    if num_tiles:
        launched(blend_raw_bwd_cuda, mode)
    return dfeats


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
    """The TPU kernel's own output in plain PyTorch: the VJP with respect
    to the windows, shaped like ``windows`` (per-slot grads, zero past each
    tile's walk and in the lanes the mode does not read). The walk goes
    back from each tile's largest ``n_contrib``, T recovered from the
    final logT and the suffix sums carried in float64."""
    _check_windows(windows, counts, grid_x, grid_y, mode)
    _check_raw(windows.shape[0], raw, cot)
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


def blend_raw_pairs_plain(feats_t: torch.Tensor, tile_start: torch.Tensor,
                          counts: torch.Tensor, grid_x: int, grid_y: int,
                          mode: str, chunk: int = 128) -> torch.Tensor:
    """Same inputs and output as the forward kernel, in plain PyTorch: the
    TPU route's composition, ``gather_tile_windows`` then
    ``blend_raw_plain``. The windows hold the tiles' largest count of rows;
    no row past a tile's count is read."""
    _check_pairs(feats_t, tile_start, counts, grid_x, grid_y, mode)
    rows = max(int(counts.max()), 1) if counts.numel() else 1
    windows = gather_tile_windows(feats_t, tile_start, rows)
    return blend_raw_plain(windows, counts, grid_x, grid_y, mode, chunk)


def blend_raw_bwd_pairs_plain(feats_t: torch.Tensor,
                              tile_start: torch.Tensor, counts: torch.Tensor,
                              grid_x: int, grid_y: int, mode: str,
                              raw: torch.Tensor, cot: torch.Tensor,
                              chunk: int = 128) -> torch.Tensor:
    """Same inputs and output as the backward kernel, in plain PyTorch: the
    TPU route's composition, the windows' VJP (``blend_raw_bwd_plain``)
    folded back through the gather to (32, pairs). The windows hold the
    tiles' largest count of rows; no row past a tile's count is read."""
    _check_pairs_bwd(feats_t, tile_start, counts, grid_x, grid_y, mode, raw,
                     cot)
    rows = max(int(counts.max()), 1) if counts.numel() else 1
    windows = gather_tile_windows(feats_t, tile_start, rows)
    dwindows = blend_raw_bwd_plain(windows, counts, grid_x, grid_y, mode, raw,
                                   cot, chunk)
    return fold_tile_windows(dwindows, tile_start, counts, feats_t.shape[1])


def blend_raw_fwd(feats_t, tile_start, counts, grid_x, grid_y, mode,
                  chunk=128):
    """(T, 256, 24) raw: a CUDA tensor goes to the forward kernel, a CPU
    tensor to its plain version."""
    if feats_t.is_cuda:
        return blend_raw_cuda(feats_t, tile_start, counts, grid_x, grid_y,
                              mode)
    if feats_t.device.type != "cpu":
        raise ValueError(f"no windowed blend for device {feats_t.device}")
    return blend_raw_pairs_plain(feats_t, tile_start, counts, grid_x, grid_y,
                                 mode, chunk)


def blend_raw_bwd(feats_t, tile_start, counts, grid_x, grid_y, mode, raw,
                  cot, chunk=128):
    """(32, pairs) grads of the pair features: a CUDA tensor goes to the
    backward kernel, a CPU tensor to its plain version."""
    if feats_t.is_cuda:
        return blend_raw_bwd_cuda(feats_t, tile_start, counts, grid_x, grid_y,
                                  mode, raw, cot)
    if feats_t.device.type != "cpu":
        raise ValueError(f"no windowed blend backward for device "
                         f"{feats_t.device}")
    return blend_raw_bwd_pairs_plain(feats_t, tile_start, counts, grid_x,
                                     grid_y, mode, raw, cot, chunk)


class _BlendRaw(torch.autograd.Function):
    """(32, pairs) pair features → (T, 256, 24) raw, each tile's pairs up
    to its count, with the analytic backward straight to the pair
    features."""

    @staticmethod
    def forward(ctx, feats_t, tile_start, counts, grid_x, grid_y, mode,
                chunk):
        raw = blend_raw_fwd(feats_t, tile_start, counts, grid_x, grid_y,
                            mode, chunk)
        ctx.save_for_backward(feats_t, tile_start, counts, raw)
        ctx.static = (grid_x, grid_y, mode, chunk)
        return raw

    @staticmethod
    def backward(ctx, cot):
        feats_t, tile_start, counts, raw = ctx.saved_tensors
        grid_x, grid_y, mode, chunk = ctx.static
        dfeats = blend_raw_bwd(feats_t, tile_start, counts, grid_x, grid_y,
                               mode, raw, cot.contiguous(), chunk)
        return dfeats, None, None, None, None, None, None


def blend_raw(feats_t, tile_start, counts, grid_x: int, grid_y: int,
              mode: str = "full", chunk: int = 128):
    """Windowed blend of the (32, pairs) pair features, differentiable
    with respect to ``feats_t``: tile t blends pairs ``tile_start[t] + r``,
    ``r < counts[t]`` (``counts = min(tile_count, max_per_tile)``)."""
    return _BlendRaw.apply(feats_t, tile_start, counts, grid_x, grid_y, mode,
                           chunk)


def render_tiles_windowed(proj: ProjectedGaussians, pairs: TilePairs,
                          height: int, width: int, focal_x, focal_y,
                          bg: torch.Tensor, max_per_tile: int,
                          mode: str = "full",
                          chunk: int = 128) -> RenderOutputs:
    """Gather per-pair features, blend every view's tiles, each up to
    ``max_per_tile`` pairs, in one launch, untile (the 24-lane raw in every
    mode, as the TPU path)."""
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
    raw = blend_raw(feats_t, pairs.tile_start, counts, grid_x, grid_y, mode,
                    chunk)
    return raw_to_outputs(raw, views, grid_x, grid_y, height, width, focal_x,
                          focal_y, bg)
