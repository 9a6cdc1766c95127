"""Packed blend, forward and backward: the CUDA kernels, their plain
PyTorch versions, and the untiling around them.

Counterpart of the packed half of ``igs_tpu/ops/pallas_blend.py``:
``pack_features``, the 16-lane color pack, ``blend_raw_packed`` with its
VJP ``_blend_raw_packed_bwd``, ``_raw_to_outputs(_color)`` and
``render_tiles_pallas_packed``.

``blend_raw_packed`` walks each tile's depth-ordered pair segment and
returns raw per-pixel accumulators (T, 256, nl); normalization and the
background composite happen in ``raw_to_outputs``. It is a
``torch.autograd.Function`` whose backward is the analytic VJP. On CUDA
tensors forward and backward launch the hand-written kernels
(``csrc/blend_fwd.cu``, ``csrc/blend_bwd.cu``) or raise; on CPU tensors
they run the plain versions, which compute the same functions vectorised
over tiles and looping over 128-pair chunks.

Feature lanes (32): [xy(2) | conic(3) | opacity(1) | color(3) | vp(3) |
t(1) | cpx(3) | cpy(3) | rp(2) | nrm(3) | pad(8)]; color mode keeps the
first 16. Raw lanes: color (8) [C(3) | W | logT | n_contrib | pad(2)];
otherwise (24) [C(3) | W | coord(3) | D | nrm(3) | mcoord(3) | mdepth_t |
logT | n_contrib | med_pos | pad(6)].

Under a profiler the two dispatchers count the pairs each launch walks
(the sum of ``tile_count``) to ``raster.pairs_blended.fwd`` and
``.bwd`` (``utils/profiling.count``; a device tensor, no sync).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from igs_tpu_torch.ops.binning import TilePairs
from igs_tpu_torch.ops.projection import ProjectedGaussians, TILE_X, TILE_Y
from igs_tpu_torch.ops.segred import gather_pairs
from igs_tpu_torch.utils.profiling import count
from igs_tpu_torch.utils.safe_math import safe_norm

LOG_TERM = -9.210340371976182  # log(1e-4)
MIN_ALPHA = 1.0 / 255.0
P = TILE_X * TILE_Y  # 256 pixels per tile
MODES = {"color": 0, "color_depth": 1, "full": 2}


def raw_lanes(mode: str) -> int:
    return 8 if mode == "color" else 24


def pack_features(proj: ProjectedGaussians) -> torch.Tensor:
    """(..., N, 32) packed per-Gaussian blend features."""
    return torch.cat(
        [
            proj.means2d,
            proj.conic,
            proj.opacity.unsqueeze(-1),
            proj.color,
            proj.view_point,
            proj.t_center.unsqueeze(-1),
            proj.camera_plane[..., 0::2],  # cpx
            proj.camera_plane[..., 1::2],  # cpy
            proj.ray_plane,
            proj.normal,
            torch.zeros(proj.means2d.shape[:-1] + (8,), dtype=torch.float32,
                        device=proj.means2d.device),
        ],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def _check_inputs(feats_t, tile_start, tile_count, grid_x, grid_y, mode):
    if mode not in MODES:
        raise ValueError(f"unknown blend mode {mode!r}")
    need = 9 if mode == "color" else 24
    if feats_t.dim() != 2 or feats_t.shape[0] < need:
        raise ValueError(
            f"feats_t must be (lanes >= {need}, pairs), got {tuple(feats_t.shape)}")
    if feats_t.dtype != torch.float32:
        raise TypeError(f"feats_t must be float32, got {feats_t.dtype}")
    for name, x in (("tile_start", tile_start), ("tile_count", tile_count)):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
    if tile_start.shape != tile_count.shape:
        raise ValueError("tile_start and tile_count differ in shape")
    if tile_count.shape[0] % (grid_x * grid_y):
        raise ValueError(f"{tile_count.shape[0]} tiles are not whole views of "
                         f"{grid_x}x{grid_y} tiles")


def blend_raw_packed_cuda(feats_t, tile_start, tile_count, grid_x: int,
                          grid_y: int, mode: str) -> torch.Tensor:
    """Launch ``csrc/blend_fwd.cu`` on the current stream → (T, 256, nl).

    One block of 256 threads a tile, one pixel a thread, each warp an 8×4
    pixel rectangle. Pairs are staged through shared memory with
    ``cp.async`` in two stages (256 pairs a stage in color mode, 128
    otherwise); as a stage lands each pair gets a bit per warp whose
    rectangle meets its candidate box (``candidate_box`` is the plain
    version of ``csrc/blend_common.cuh``'s), and a warp walks only its
    pairs, two at a time through the candidate test before the chain.
    Tiles launch deepest first (``tile_order``'s keys, bucketed by a
    one-block kernel of the same call into the ``order`` scratch). Every
    pixel takes the same pairs, in the same order, with the same rounding
    as the count kernel and the backward (C7), so ``n_contrib`` and
    ``med_pos`` are bit-equal to the first kernel's and the count kernel's
    total equals the pixel-pairs this kernel accepts. Bound: bytes (the
    live pairs' lanes read, the raw block written) at every shape of
    PERF.md's kernel table. Constants (the fastest variants measured)
    and ``-Xptxas -v`` (40/48/56 registers for color/color_depth/full,
    no spills): the source's header and PERF.md, Findings. No host
    synchronisation: the geometry is fixed per mode.
    """
    _check_inputs(feats_t, tile_start, tile_count, grid_x, grid_y, mode)
    for name, x in (("feats_t", feats_t), ("tile_start", tile_start),
                    ("tile_count", tile_count)):
        if not x.is_cuda or x.device != feats_t.device:
            raise ValueError(f"{name} must be on {feats_t.device} (CUDA)")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fn, error_string = _kernel()
    num_tiles = tile_count.shape[0]
    out = torch.empty((num_tiles, P, raw_lanes(mode)), dtype=torch.float32,
                      device=feats_t.device)
    order = torch.empty(num_tiles, dtype=torch.int32, device=feats_t.device)
    with torch.cuda.device(feats_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feats_t.data_ptr(), feats_t.shape[1], tile_start.data_ptr(),
                 tile_count.data_ptr(), order.data_ptr(), num_tiles, grid_x,
                 grid_x * grid_y, MODES[mode], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("blend_fwd_packed launch failed: "
                           + error_string(err).decode())
    if num_tiles:
        blend_raw_packed_cuda.launches += 1
        blend_raw_packed_cuda.launches_by_mode[mode] += 1
    return out


# launches of the kernel (and per mode) since the last reset; the
# comparison runs of chip_smoke.py reset them before the main path
blend_raw_packed_cuda.launches = 0
blend_raw_packed_cuda.launches_by_mode = dict.fromkeys(MODES, 0)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built library's entry point and error-string function."""
    from igs_tpu_torch.ops.cuda_build import load

    lib = load("blend_fwd.cu")
    fn = lib.igs_blend_fwd_packed
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.igs_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def candidate_box(feats_t: torch.Tensor) -> torch.Tensor:
    """(pairs, 4) float32 boxes (x_lo, x_hi, y_lo, y_hi): every pixel at
    which a pair can pass the candidate test lies in its box.

    The plain version of ``csrc/blend_common.cuh``'s ``candidate_box``,
    by which both kernels skip, per warp, the pairs whose box misses the
    warp's pixels (the header gives the proof). float32 from lanes 0-5,
    but for the conic's determinant in float64 (exact products), and
    rounded outward; an empty box (lo > hi) for an opacity under 1/255,
    the whole plane for a conic that is not positive definite or any
    non-finite input.
    """
    f = feats_t[:6].float()
    mx, my, a, b, c, o = f
    inf = torch.full_like(mx, math.inf)
    det64 = a.double() * c.double() - b.double() * b.double()
    det = det64.float()
    tr = a + c
    lmax = 0.5 * (tr + torch.sqrt(torch.clamp_min(tr * tr - 4.0 * det, 0.0)))
    eps = 32.0 * 2.0 ** -24 * (1.0 + lmax * lmax / det)
    tau = torch.clamp_min(torch.log(255.0 * o), 0.0) + 1e-4
    q = 2.0 * tau * (1.0 + 1e-4) / (1.0 - eps)
    ex = torch.sqrt(q * c / det) * (1.0 + 1e-5) + 1e-3
    ey = torch.sqrt(q * a / det) * (1.0 + 1e-5) + 1e-3
    box = torch.stack([_round_out(mx.double() - ex.double(), -1),
                       _round_out(mx.double() + ex.double(), 1),
                       _round_out(my.double() - ey.double(), -1),
                       _round_out(my.double() + ey.double(), 1)], -1)
    never = o * (1.0 + 1e-6) < torch.tensor(MIN_ALPHA, dtype=torch.float32)
    bounded = (a > 0) & (c > 0) & (det64 > 0) & (eps < 0.5)
    whole = torch.stack([-inf, inf, -inf, inf], -1)
    box = torch.where(bounded[:, None], box, whole)
    box = torch.where(never[:, None], -whole, box)
    return torch.where(torch.isfinite(f).all(0)[:, None], box, whole)


def tile_order(tile_count: torch.Tensor) -> torch.Tensor:
    """(T,) int64: the tiles, deepest first, as both kernels launch them.

    The plain version of ``csrc/blend_common.cuh``'s ``tile_order_kernel``:
    tiles by descending ``depth_key``, four keys an octave of
    ``tile_count``. The kernel orders the tiles of one key by atomics;
    this is the one of its orders that keeps them by index. The order
    changes no output (each block writes only its own tile).
    """
    c = tile_count.long().clamp_min(0)
    e = torch.frexp(c.clamp_min(4).double()).exponent.long() - 1
    key = torch.where(c < 4, c, 4 * (e - 1) + ((c >> (e - 2)) & 3))
    return torch.argsort(-key, stable=True)


def _round_out(x: torch.Tensor, direction: int) -> torch.Tensor:
    """float64 → float32 rounded down (-1) or up (+1)."""
    y = x.float()
    toward = torch.full_like(y, direction * math.inf)
    off = y.double() > x if direction < 0 else y.double() < x
    return torch.where(off, torch.nextafter(y, toward), y)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def blend_raw_packed_plain(feats_t, tile_start, tile_count, grid_x: int,
                           grid_y: int, mode: str, chunk: int = 128,
                           tile_block: int = 1024) -> torch.Tensor:
    """Same inputs and outputs as the kernel, in plain PyTorch.

    Vectorised over tiles (``tile_block`` at a time) and pixels, looping
    over ``chunk``-pair windows; inside a window the transmittance is the
    log-space prefix sum, as in the TPU kernel.
    """
    _check_inputs(feats_t, tile_start, tile_count, grid_x, grid_y, mode)
    num_tiles = tile_count.shape[0]
    out = torch.zeros((num_tiles, P, raw_lanes(mode)), dtype=torch.float32,
                      device=feats_t.device)
    for t0 in range(0, num_tiles, tile_block):
        tiles = torch.arange(t0, min(num_tiles, t0 + tile_block),
                             device=feats_t.device)
        fetch = _segment_fetch(feats_t, tile_start[tiles].long(), chunk)
        out[tiles] = plain_tiles(fetch, tile_count[tiles].long(), tiles,
                                 grid_x, grid_x * grid_y, mode, chunk,
                                 raw_lanes(mode))
    return out


def _segment_fetch(feats_t, start, chunk):
    """Chunk reader of the packed layout: pairs ``start + slot`` of the
    (lanes, pairs) features → ((A, K, lanes) features, (K,) slots)."""
    kk = torch.arange(chunk, device=feats_t.device)
    last = max(feats_t.shape[1] - 1, 0)

    def fetch(act, c0):
        col = torch.clamp(start[act, None] + c0 + kk[None, :], max=last)
        return feats_t[:, col].permute(1, 2, 0), c0 + kk

    return fetch


def tile_pixels(tiles, grid_x: int, tiles_per_view: int):
    """(A, 256) pixel x and y of each tile's pixels (no +0.5)."""
    pidx = torch.arange(P, device=tiles.device)
    lt = tiles % tiles_per_view
    px = ((lt % grid_x) * TILE_X)[:, None].float() + (pidx % TILE_X).float()
    py = ((lt // grid_x) * TILE_Y)[:, None].float() + (pidx // TILE_X).float()
    return px, py


def plain_tiles(fetch, count, tiles, grid_x, tiles_per_view, mode, chunk,
                nl):
    """The forward walk of a block of tiles, shared by the packed and the
    windowed plain versions. ``fetch(act, c0)`` reads chunk ``c0`` of the
    active tiles ``act`` → ((A, K, lanes) features, (K,) slots); ``nl`` is
    the raw width: 8 (the packed color layout) or 24."""
    dev = tiles.device
    nt = tiles.shape[0]
    px, py = tile_pixels(tiles, grid_x, tiles_per_view)

    logt = torch.zeros((nt, P), device=dev)
    done = torch.zeros((nt, P), dtype=torch.bool, device=dev)
    acc_c = torch.zeros((nt, P, 4), device=dev)
    acc_cd = torch.zeros((nt, P, 4), device=dev)
    acc_n = torch.zeros((nt, P, 3), device=dev)
    acc_med = torch.zeros((nt, P, 4), device=dev)
    med_pos = torch.full((nt, P), -1.0, device=dev)
    n_contrib = torch.zeros((nt, P), device=dev)

    nmax = int(count.max()) if nt else 0
    for c0 in range(0, nmax, chunk):
        act = torch.nonzero((count > c0) & ~done.all(dim=1))[:, 0]
        if act.numel() == 0:
            break
        f, slot = fetch(act, c0)  # (A, K, lanes), (K,) local pair index
        kk = slot - c0
        live = slot[None, :] < count[act, None]  # (A, K)
        dx = f[:, None, :, 0] - px[act][:, :, None]  # (A, P, K)
        dy = f[:, None, :, 1] - py[act][:, :, None]
        power = (-0.5 * (f[:, None, :, 2] * dx * dx + f[:, None, :, 4] * dy * dy)
                 - f[:, None, :, 3] * dx * dy)
        alpha = torch.clamp_max(
            f[:, None, :, 5] * torch.exp(torch.clamp_max(power, 0.0)), 0.99)
        cand = live[:, None, :] & (power <= 0.0) & (alpha >= MIN_ALPHA)
        a = torch.where(cand, alpha, torch.zeros_like(alpha))
        log1m = torch.log1p(-a)
        cum = logt[act][:, :, None] + torch.cumsum(log1m, dim=-1)
        alive = cum >= LOG_TERM
        accept = cand & alive & ~done[act][:, :, None]
        t_before = torch.exp(cum - log1m)
        w = torch.where(accept, a * t_before, torch.zeros_like(a))

        upd = torch.cat([torch.einsum("apk,akc->apc", w, f[..., 6:9]),
                         w.sum(-1, keepdim=True)], dim=-1)
        acc_c[act] = acc_c[act] + upd
        if mode != "color":
            f_w = torch.cat([f[..., 9:12], f[..., 12:13]], dim=-1)
            f_x = torch.cat([f[..., 13:16], f[..., 19:20]], dim=-1)
            f_y = torch.cat([f[..., 16:19], f[..., 20:21]], dim=-1)
            acc_cd[act] = acc_cd[act] + (
                torch.einsum("apk,akc->apc", w, f_w)
                + torch.einsum("apk,akc->apc", w * dx, f_x)
                + torch.einsum("apk,akc->apc", w * dy, f_y))
        if mode == "full":
            acc_n[act] = acc_n[act] + torch.einsum(
                "apk,akc->apc", w, f[..., 21:24])
            med = accept & (t_before > 0.5)
            has = med.any(dim=-1)
            kidx = torch.where(med, kk, torch.full_like(kk, -1)).amax(dim=-1)
            ks = torch.clamp_min(kidx, 0)
            ai = torch.arange(act.shape[0], device=dev)[:, None]
            dxm = torch.gather(dx, -1, ks[..., None])
            dym = torch.gather(dy, -1, ks[..., None])
            med_new = f_w[ai, ks] + dxm * f_x[ai, ks] + dym * f_y[ai, ks]
            acc_med[act] = torch.where(has[..., None], med_new, acc_med[act])
            med_pos[act] = torch.where(has, (c0 + kidx).float(), med_pos[act])
        slot_f = (slot + 1).float()
        n_contrib[act] = torch.maximum(
            n_contrib[act],
            torch.where(accept, slot_f, torch.zeros_like(slot_f)).amax(dim=-1))
        logt[act] = logt[act] + torch.where(
            accept, log1m, torch.zeros_like(log1m)).sum(-1)
        done[act] = done[act] | (cand & ~alive).any(dim=-1)

    if nl == 8:
        pad = torch.zeros((nt, P, 2), device=dev)
        return torch.cat([acc_c, logt[..., None], n_contrib[..., None], pad], -1)
    pad = torch.zeros((nt, P, 6), device=dev)
    return torch.cat([acc_c, acc_cd, acc_n, acc_med, logt[..., None],
                      n_contrib[..., None], med_pos[..., None], pad], -1)


def _blend_fwd(feats_t, tile_start, tile_count, grid_x, grid_y, mode):
    count("raster.pairs_blended.fwd", tile_count)
    if feats_t.is_cuda:
        return blend_raw_packed_cuda(feats_t, tile_start, tile_count, grid_x,
                                     grid_y, mode)
    if feats_t.device.type != "cpu":
        raise ValueError(f"no blend for device {feats_t.device}")
    return blend_raw_packed_plain(feats_t, tile_start, tile_count, grid_x,
                                  grid_y, mode)


def blend_raw_packed_bwd(feats_t, tile_start, tile_count, grid_x: int,
                         grid_y: int, mode: str, raw: torch.Tensor,
                         cot: torch.Tensor) -> torch.Tensor:
    """d(loss)/d(feats_t) from the forward's raw block and its cotangent.

    A CUDA tensor goes to the kernel, a CPU tensor to the plain version.
    """
    count("raster.pairs_blended.bwd", tile_count)
    if feats_t.is_cuda:
        return blend_raw_packed_bwd_cuda(feats_t, tile_start, tile_count,
                                         grid_x, grid_y, mode, raw, cot)
    if feats_t.device.type != "cpu":
        raise ValueError(f"no blend backward for device {feats_t.device}")
    return blend_raw_packed_bwd_plain(feats_t, tile_start, tile_count, grid_x,
                                      grid_y, mode, raw, cot)


class _BlendRawPacked(torch.autograd.Function):
    """The packed blend with its analytic backward (no autograd through the
    forward's arithmetic)."""

    @staticmethod
    def forward(ctx, feats_t, tile_start, tile_count, grid_x, grid_y, mode):
        raw = _blend_fwd(feats_t, tile_start, tile_count, grid_x, grid_y,
                         mode)
        ctx.save_for_backward(feats_t, tile_start, tile_count, raw)
        ctx.grid = (grid_x, grid_y, mode)
        return raw

    @staticmethod
    def backward(ctx, cot):
        feats_t, tile_start, tile_count, raw = ctx.saved_tensors
        grid_x, grid_y, mode = ctx.grid
        dfeats = blend_raw_packed_bwd(feats_t, tile_start, tile_count, grid_x,
                                      grid_y, mode, raw, cot.contiguous())
        return dfeats, None, None, None, None, None


def blend_raw_packed(feats_t, tile_start, tile_count, grid_x: int,
                     grid_y: int, mode: str = "full") -> torch.Tensor:
    """(lanes, pairs) packed features → (T, 256, nl) raw accumulators,
    differentiable with respect to ``feats_t``.

    A CUDA tensor goes to the kernels (forward and backward), a CPU tensor
    to their plain versions.
    """
    return _BlendRawPacked.apply(feats_t, tile_start, tile_count, grid_x,
                                 grid_y, mode)


# ---------------------------------------------------------------------------
# the backward: the kernel's wrapper and the plain version
# ---------------------------------------------------------------------------


def _check_bwd(feats_t, tile_start, tile_count, grid_x, grid_y, mode, raw,
               cot):
    _check_inputs(feats_t, tile_start, tile_count, grid_x, grid_y, mode)
    want = (tile_count.shape[0], P, raw_lanes(mode))
    for name, x in (("raw", raw), ("cot", cot)):
        if tuple(x.shape) != want or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {want}, got "
                             f"{x.dtype} {tuple(x.shape)}")


def blend_raw_packed_bwd_cuda(feats_t, tile_start, tile_count, grid_x: int,
                              grid_y: int, mode: str, raw: torch.Tensor,
                              cot: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/blend_bwd.cu`` on the current stream → dfeats_t, shaped
    like ``feats_t``; pairs the walk never reaches come back zero.

    One block of 256 threads a tile, one pixel a thread, each warp an 8×4
    pixel rectangle, walking from the tile's largest ``n_contrib`` down
    over ``cp.async``-staged pairs (128 a stage in color mode, 32
    otherwise), skipping the pairs whose candidate box misses the warp as
    the forward does, tiles deepest first. A warp sums a pair's grads over
    its 32 pixels with a transpose-reduce (16 shuffles in color mode, 31
    otherwise; lane l ends with grad lane l), and the 8 warps' partials
    are added in warp order and written by the one block that owns the
    pair: no atomics, bitwise repeatable. T is recovered with Kahan sums
    (C8). Bound: bytes at every shape of PERF.md's kernel table.
    Constants (the fastest variants measured) and ``-Xptxas -v``
    (58/62/72 registers, no spills): the source's header and PERF.md,
    Findings.
    """
    _check_bwd(feats_t, tile_start, tile_count, grid_x, grid_y, mode, raw,
               cot)
    for name, x in (("feats_t", feats_t), ("tile_start", tile_start),
                    ("tile_count", tile_count), ("raw", raw), ("cot", cot)):
        if not x.is_cuda or x.device != feats_t.device:
            raise ValueError(f"{name} must be on {feats_t.device} (CUDA)")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fn, error_string = _bwd_kernel()
    num_tiles = tile_count.shape[0]
    dfeats = torch.zeros_like(feats_t)
    order = torch.empty(num_tiles, dtype=torch.int32, device=feats_t.device)
    with torch.cuda.device(feats_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feats_t.data_ptr(), feats_t.shape[1], tile_start.data_ptr(),
                 tile_count.data_ptr(), order.data_ptr(), num_tiles, grid_x,
                 grid_x * grid_y, MODES[mode], raw.data_ptr(), cot.data_ptr(),
                 dfeats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("blend_bwd_packed launch failed: "
                           + error_string(err).decode())
    if num_tiles:
        blend_raw_packed_bwd_cuda.launches += 1
        blend_raw_packed_bwd_cuda.launches_by_mode[mode] += 1
    return dfeats


blend_raw_packed_bwd_cuda.launches = 0
blend_raw_packed_bwd_cuda.launches_by_mode = dict.fromkeys(MODES, 0)


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    from igs_tpu_torch.ops.cuda_build import load

    lib = load("blend_bwd.cu")
    fn = lib.igs_blend_bwd_packed
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.igs_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def blend_raw_packed_bwd_plain(feats_t, tile_start, tile_count, grid_x: int,
                               grid_y: int, mode: str, raw: torch.Tensor,
                               cot: torch.Tensor, chunk: int = 128,
                               tile_block: int = 1024) -> torch.Tensor:
    """Same inputs and output as the backward kernel, in plain PyTorch.

    Vectorised over tiles and pixels like the forward's plain version,
    walking ``chunk``-pair windows from each tile's largest ``n_contrib``
    down. T is recovered from the final logT and the suffix sums are
    carried in float64.
    """
    _check_bwd(feats_t, tile_start, tile_count, grid_x, grid_y, mode, raw,
               cot)
    num_tiles = tile_count.shape[0]
    dfeats = torch.zeros_like(feats_t)
    last = max(feats_t.shape[1] - 1, 0)
    for t0 in range(0, num_tiles, tile_block):
        tiles = torch.arange(t0, min(num_tiles, t0 + tile_block),
                             device=feats_t.device)
        start = tile_start[tiles].long()

        def store(act, slot, live, grads, start=start):
            col = torch.clamp(start[act, None] + slot[None, :], max=last)
            ai, ki = torch.nonzero(live, as_tuple=True)
            dfeats[:grads.shape[-1], col[ai, ki]] = grads[ai, ki].t()

        plain_tiles_bwd(_segment_fetch(feats_t, start, chunk), store,
                        tile_count[tiles].long(), tiles, grid_x,
                        grid_x * grid_y, mode, chunk, raw[tiles], cot[tiles])
    return dfeats


def plain_tiles_bwd(fetch, store, count, tiles, grid_x, tiles_per_view,
                    mode, chunk, raw, cot):
    """The backward walk of a block of tiles, shared by the packed and the
    windowed plain versions: ``fetch`` as in ``plain_tiles``;
    ``store(act, slot, live, grads)`` writes the (A, K, lanes) per-pair
    grads of the live (A, K) slots. The raw layout (8 or 24 lanes) is read
    from ``raw``'s width."""
    dev = tiles.device
    nt = tiles.shape[0]
    color = mode == "color"
    narrow = raw.shape[-1] == 8
    px, py = tile_pixels(tiles, grid_x, tiles_per_view)

    ncontrib = raw[..., 5 if narrow else 16]  # (nt, P)
    logt = raw[..., 4 if narrow else 15].double()  # logT after the chunk
    u_c, u_w = cot[..., 0:3], cot[..., 3]
    u_logt = cot[..., 4 if narrow else 15].double()
    if not color:
        u_cd = cot[..., 4:8]
    if mode == "full":
        u_n, u_med, medpos = cot[..., 8:11], cot[..., 11:15], raw[..., 17]
    s_carry = torch.zeros((nt, P), dtype=torch.float64, device=dev)
    limit = torch.minimum(count, ncontrib.amax(dim=1).long()) if nt else count
    nmax = int(limit.max()) if nt else 0

    for c0 in reversed(range(0, nmax, chunk)):
        act = torch.nonzero(limit > c0)[:, 0]
        f, slot = fetch(act, c0)  # (A, K, lanes), (K,)
        live = slot[None, :] < limit[act, None]  # (A, K)
        dx = f[:, None, :, 0] - px[act][:, :, None]  # (A, P, K)
        dy = f[:, None, :, 1] - py[act][:, :, None]
        c0_, c1_, c2_ = (f[:, None, :, i] for i in (2, 3, 4))
        power = -0.5 * (c0_ * dx * dx + c2_ * dy * dy) - c1_ * dx * dy
        expp = torch.exp(torch.clamp_max(power, 0.0))
        alpha = torch.clamp_max(f[:, None, :, 5] * expp, 0.99)
        accept = (live[:, None, :] & (power <= 0.0) & (alpha >= MIN_ALPHA)
                  & ((slot + 1).float() <= ncontrib[act][:, :, None]))
        a = torch.where(accept, alpha, torch.zeros_like(alpha))
        log1m = torch.log1p(-a).double()
        suffix = torch.flip(torch.cumsum(torch.flip(log1m, [-1]), -1), [-1])
        t_i = torch.exp(logt[act][:, :, None] - suffix)  # T before each pair
        w = torch.where(accept, a * t_i.float(), torch.zeros_like(a))

        g = torch.einsum("apc,akc->apk", u_c[act], f[..., 6:9]) \
            + u_w[act][:, :, None]
        if not color:
            ucd = u_cd[act]
            gx = torch.einsum("apc,akc->apk", ucd,
                              torch.cat([f[..., 13:16], f[..., 19:20]], -1))
            gy = torch.einsum("apc,akc->apk", ucd,
                              torch.cat([f[..., 16:19], f[..., 20:21]], -1))
            g = g + torch.einsum("apc,akc->apk", ucd, f[..., 9:13]) \
                + dx * gx + dy * gy
        if mode == "full":
            g = g + torch.einsum("apc,akc->apk", u_n[act], f[..., 21:24])
        wg = (w * g).double()
        s_after = s_carry[act][:, :, None] + torch.flip(
            torch.cumsum(torch.flip(wg, [-1]), -1), [-1]) - wg  # Σ_{k>j}
        da = torch.where(
            accept,
            (t_i * g.double() - (s_after + u_logt[act][:, :, None])
             / (1.0 - a.double())).float(),
            torch.zeros_like(a))
        notclip = (alpha < 0.99).float()
        dpower = da * a * notclip
        ddx = dpower * (-(c0_ * dx + c1_ * dy))
        ddy = dpower * (-(c2_ * dy + c1_ * dx))
        if not color:
            ddx = ddx + w * gx
            ddy = ddy + w * gy
        if mode == "full":
            lastm = ((slot.float()[None, None, :] == medpos[act][:, :, None])
                     & (medpos[act][:, :, None] >= 0.0)).float()
            umed = u_med[act]
            ddx = ddx + lastm * torch.einsum(
                "apc,akc->apk", umed,
                torch.cat([f[..., 13:16], f[..., 19:20]], -1))
            ddy = ddy + lastm * torch.einsum(
                "apc,akc->apk", umed,
                torch.cat([f[..., 16:19], f[..., 20:21]], -1))

        grads = [ddx.sum(1), ddy.sum(1),
                 (dpower * (-0.5 * dx * dx)).sum(1),
                 (dpower * (-dx * dy)).sum(1),
                 (dpower * (-0.5 * dy * dy)).sum(1),
                 (da * expp * notclip).sum(1)]
        grads = torch.cat([torch.stack(grads, -1),
                           torch.einsum("apk,apc->akc", w, u_c[act])], -1)
        if not color:
            dvp = torch.einsum("apk,apc->akc", w, ucd)
            dcx = torch.einsum("apk,apc->akc", w * dx, ucd)
            dcy = torch.einsum("apk,apc->akc", w * dy, ucd)
            if mode == "full":
                dvp = dvp + torch.einsum("apk,apc->akc", lastm, umed)
                dcx = dcx + torch.einsum("apk,apc->akc", lastm * dx, umed)
                dcy = dcy + torch.einsum("apk,apc->akc", lastm * dy, umed)
            grads = torch.cat([grads, dvp, dcx[..., :3], dcy[..., :3],
                               dcx[..., 3:], dcy[..., 3:]], -1)
        if mode == "full":
            grads = torch.cat(
                [grads, torch.einsum("apk,apc->akc", w, u_n[act])], -1)
        store(act, slot, live, grads)  # (A, K, 9 | 21 | 24)

        s_carry[act] = s_carry[act] + wg.sum(-1)
        logt[act] = logt[act] - log1m.sum(-1)


# ---------------------------------------------------------------------------
# raw accumulators → images
# ---------------------------------------------------------------------------


class RenderOutputs(NamedTuple):
    """Rendered views, each with a leading (V,) axis."""

    color: torch.Tensor  # (V, 3, H, W), bg-composited
    alpha: torch.Tensor  # (V, H, W)   Σ αT
    coord: torch.Tensor  # (V, 3, H, W) expected camera-space coord
    mcoord: torch.Tensor  # (V, 3, H, W) median coord
    depth: torch.Tensor  # (V, H, W)   expected depth
    mdepth: torch.Tensor  # (V, H, W)   median depth
    normal: torch.Tensor  # (V, 3, H, W) blended unit normal
    accum_coord: torch.Tensor  # (V, 3, H, W)
    accum_depth: torch.Tensor  # (V, H, W)
    n_contrib: torch.Tensor  # (V, H, W) int32 last contributor position
    max_contrib: torch.Tensor  # (V, H, W) int32 median contributor position


def untile(raw: torch.Tensor, views: int, grid_x: int, grid_y: int,
           height: int, width: int) -> torch.Tensor:
    """(V·T, 256, c) → (V, c, H, W)."""
    c = raw.shape[-1]
    img = raw.reshape(views, grid_y, grid_x, TILE_Y, TILE_X, c)
    img = img.permute(0, 5, 1, 3, 2, 4).reshape(
        views, c, grid_y * TILE_Y, grid_x * TILE_X)
    return img[:, :, :height, :width]


def raw_to_outputs_color(raw, views, grid_x, grid_y, height, width, bg):
    """(V·T, 256, 8) color-mode raw → RenderOutputs (geometry zero)."""
    img = untile(raw, views, grid_x, grid_y, height, width)
    t_final = torch.exp(img[:, 4])
    color = img[:, 0:3] + t_final[:, None] * bg.reshape(-1, 3)[:, :, None, None]
    z1 = torch.zeros_like(img[:, 3])
    z3 = torch.zeros_like(img[:, 0:3])
    return RenderOutputs(
        color=color, alpha=img[:, 3], coord=z3, mcoord=z3, depth=z1,
        mdepth=z1, normal=z3, accum_coord=z3, accum_depth=z1,
        n_contrib=img[:, 5].to(torch.int32),
        max_contrib=torch.zeros_like(z1, dtype=torch.int32),
    )


def raw_to_outputs(raw, views, grid_x, grid_y, height, width, focal_x,
                   focal_y, bg):
    """(V·T, 256, 24) raw accumulators → RenderOutputs."""
    img = untile(raw, views, grid_x, grid_y, height, width)
    color_acc = img[:, 0:3]
    weight = img[:, 3]
    coord_acc = img[:, 4:7]
    depth_acc = img[:, 7]
    nrm_acc = img[:, 8:11]
    mcoord = img[:, 11:14]
    mdepth_t = img[:, 14]
    n_contrib = img[:, 16]
    med_pos = img[:, 17]

    t_final = torch.exp(img[:, 15])
    color = color_acc + t_final[:, None] * bg.reshape(-1, 3)[:, :, None, None]
    any_acc = n_contrib > 0.5
    wsafe = torch.where(weight > 0, weight, torch.ones_like(weight))

    dev = raw.device
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    fx = torch.as_tensor(focal_x, dtype=torch.float32, device=dev).reshape(-1, 1, 1)
    fy = torch.as_tensor(focal_y, dtype=torch.float32, device=dev).reshape(-1, 1, 1)
    lnf = torch.sqrt(((xs - width / 2.0) / fx) ** 2
                     + ((ys - height / 2.0) / fy) ** 2 + 1.0)
    depth_ln = depth_acc / lnf
    zero = torch.zeros_like(weight)
    out_depth = torch.where(any_acc, depth_ln / wsafe, zero)
    out_coord = torch.where(any_acc[:, None], coord_acc / wsafe[:, None],
                            torch.zeros_like(coord_acc))
    nlen = torch.clamp_min(safe_norm(nrm_acc, dim=1, keepdim=True), 1e-12)
    out_normal = torch.where(any_acc[:, None], nrm_acc / nlen,
                             torch.zeros_like(nrm_acc))
    return RenderOutputs(
        color=color, alpha=weight, coord=out_coord, mcoord=mcoord,
        depth=out_depth, mdepth=mdepth_t / lnf, normal=out_normal,
        accum_coord=coord_acc, accum_depth=depth_ln,
        n_contrib=n_contrib.to(torch.int32),
        max_contrib=(med_pos + 1.0).to(torch.int32),
    )


def render_tiles_packed(proj: ProjectedGaussians, pairs: TilePairs,
                        height: int, width: int, focal_x, focal_y,
                        bg: torch.Tensor, mode: str = "full") -> RenderOutputs:
    """Gather per-pair features, blend every view's tiles in one launch,
    untile."""
    grid_x = (width + TILE_X - 1) // TILE_X
    grid_y = (height + TILE_Y - 1) // TILE_Y
    views = proj.depth.shape[0]
    feats = pack_features(proj)  # (V, N, 32)
    if mode == "color":
        # color mode reads lanes 0-8 only: the 16-lane pack halves the
        # pair gather and the kernel's reads
        feats = feats[..., :16]
    lanes = feats.shape[-1]
    rows = feats.reshape(-1, lanes).t().contiguous()  # (lanes, V·N)
    if pairs.gauss_last_row.numel():
        # backward: inverse permutation + segmented scan, no scatter
        feats_t = gather_pairs(rows, pairs.gauss_id, pairs.exp_to_sorted,
                               pairs.exp_gauss_id, pairs.gauss_last_row)
    else:
        # backward: index_select's scatter-add (color_depth, as in JAX)
        feats_t = torch.index_select(rows, 1,
                                     pairs.gauss_id.clamp_min(0).long())
    raw = blend_raw_packed(feats_t, pairs.tile_start, pairs.tile_count,
                           grid_x, grid_y, mode)
    if mode == "color":
        return raw_to_outputs_color(raw, views, grid_x, grid_y, height, width,
                                    bg)
    return raw_to_outputs(raw, views, grid_x, grid_y, height, width, focal_x,
                          focal_y, bg)
