"""Pair → Gaussian gradient reduction without a scatter.

Counterpart of ``igs_tpu/ops/segred.py``. The packed rasterizer gathers
per-pair features with ``rows[:, gauss_id]``; the transpose of that gather
is a scatter-add over pairs, which on the card means float atomics and
bits that change from run to run. Binning depth-sorts the Gaussians before
it expands them into pairs, so in expansion order the pairs of each
Gaussian (row of the (V·N) features) form one contiguous run. The
backward of ``gather_pairs`` is then

  1. an inverse permutation of the per-pair grads to expansion order,
  2. a segmented inclusive scan over those runs (``segmented_scan``: the
     kernel ``csrc/segscan.cu`` on a CUDA tensor, the plain version on a
     CPU tensor),
  3. a gather of each row's last slot.

Layout: the port keeps (lanes, pairs) with the pairs contiguous, the
transpose of the JAX package's (MP, L); the function is the same.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from igs_tpu_torch.utils.profiling import launched


def _check(x: torch.Tensor, ids: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"x must be a (lanes, pairs) float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise TypeError("ids must be a 1-D int32 tensor")
    if ids.shape[0] != x.shape[1]:
        raise ValueError(f"{ids.shape[0]} ids for {x.shape[1]} pairs")


def segmented_scan_cuda(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/segscan.cu`` on the current stream → (lanes, pairs).

    One launch, one pass: a block owns a tile of pairs (1024 at 16 lanes,
    512 at 32) for every lane row, loads the ids once, and takes the carry
    into its tile from a chained look-back over its predecessors'
    published sums, added oldest first (bitwise repeatable). The kernel
    takes 16 or 32 lanes, the packed route's color and full packs.
    """
    _check(x, ids)
    for name, t in (("x", x), ("ids", ids)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lanes, mp = x.shape
    if lanes not in (16, 32):
        raise ValueError(f"the scan kernel takes 16 or 32 lanes, got {lanes}")
    fn, tiles_of, error_string = _kernel()
    out = torch.empty_like(x)
    if mp == 0:
        return out
    tiles = tiles_of(lanes, mp)
    # the tiles' statuses and the ticket, zero on entry; the published sums
    state = torch.zeros(tiles + 1, dtype=torch.int32, device=x.device)
    agg = torch.empty((tiles, lanes), dtype=torch.float32, device=x.device)
    incl = torch.empty_like(agg)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), ids.data_ptr(), mp, lanes, out.data_ptr(),
                 state.data_ptr(), agg.data_ptr(), incl.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("segmented_scan launch failed: "
                           + error_string(err).decode())
    launched(segmented_scan_cuda)
    return out


# launches since the last reset (chip_smoke.py resets it before the main path)
segmented_scan_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    from igs_tpu_torch.ops.cuda_build import load

    lib = load("segscan.cu")
    fn = lib.igs_segmented_scan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tiles = lib.igs_segscan_tiles
    tiles.argtypes = [ctypes.c_int, ctypes.c_longlong]
    tiles.restype = ctypes.c_longlong
    err = lib.igs_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, tiles, err


def segmented_scan_plain(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Same function in plain PyTorch: a float64 running sum less the sum
    before each segment's first row."""
    _check(x, ids)
    mp = x.shape[1]
    if mp == 0:
        return x.clone()
    c = torch.cumsum(x.double(), dim=1)
    pos = torch.arange(mp, device=x.device)
    head = torch.ones(mp, dtype=torch.bool, device=x.device)
    head[1:] = ids[1:] != ids[:-1]
    seg_start = torch.cummax(torch.where(head, pos, torch.zeros_like(pos)),
                             dim=0).values
    before = torch.where(seg_start > 0,
                         c[:, (seg_start - 1).clamp_min(0)],
                         torch.zeros_like(c))
    return (c - before).float()


def segmented_scan(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Inclusive per-segment prefix sum of ``x`` (lanes, pairs) along the
    pairs, over contiguous runs of equal ``ids`` (pairs,).

    A CUDA tensor goes to the kernel, a CPU tensor to the plain version.
    """
    if x.is_cuda:
        return segmented_scan_cuda(x, ids)
    if x.device.type != "cpu":
        raise ValueError(f"no segmented scan for device {x.device}")
    return segmented_scan_plain(x, ids)


def segment_sum_sorted(dpair_exp: torch.Tensor, exp_gauss_id: torch.Tensor,
                       gauss_last_row: torch.Tensor) -> torch.Tensor:
    """Per-row sums (lanes, rows) of expansion-ordered per-pair grads;
    ``gauss_last_row[g]`` is row g's last expansion slot, -1 if none."""
    scan = segmented_scan(dpair_exp, exp_gauss_id)
    out = torch.index_select(scan, 1, gauss_last_row.clamp_min(0))
    return torch.where(gauss_last_row[None, :] >= 0, out,
                       torch.zeros_like(out))


class _GatherPairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, gauss_id, exp_to_sorted, exp_gauss_id,
                gauss_last_row):
        ctx.save_for_backward(exp_to_sorted, exp_gauss_id, gauss_last_row)
        return torch.index_select(rows, 1, gauss_id.clamp_min(0).long())

    @staticmethod
    def backward(ctx, dpair):
        exp_to_sorted, exp_gauss_id, gauss_last_row = ctx.saved_tensors
        # tile-sorted order → expansion order, where each row is one run
        dpair_exp = torch.index_select(dpair.contiguous(), 1, exp_to_sorted)
        drows = segment_sum_sorted(dpair_exp, exp_gauss_id, gauss_last_row)
        return drows, None, None, None, None


def gather_pairs(rows: torch.Tensor, gauss_id: torch.Tensor,
                 exp_to_sorted: torch.Tensor, exp_gauss_id: torch.Tensor,
                 gauss_last_row: torch.Tensor) -> torch.Tensor:
    """``rows[:, gauss_id]`` (pad ids read row 0) whose backward is
    gather + segmented scan + gather, not a scatter-add."""
    return _GatherPairs.apply(rows, gauss_id, exp_to_sorted, exp_gauss_id,
                              gauss_last_row)
