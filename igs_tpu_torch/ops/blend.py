"""Packed forward blend: the CUDA kernel, its plain PyTorch version, and the
untiling around them.

Counterpart of the forward half of ``igs_tpu/ops/pallas_blend.py``:
``pack_features``, the 16-lane color pack, ``blend_raw_packed``,
``_raw_to_outputs(_color)`` and ``render_tiles_pallas_packed``.

``blend_raw_packed`` walks each tile's depth-ordered pair segment and
returns raw per-pixel accumulators (T, 256, nl); normalization and the
background composite happen in ``raw_to_outputs``. On a CUDA tensor it
launches the hand-written kernel (``csrc/blend_fwd.cu``) or raises; on a
CPU tensor it runs the plain version, which computes the same function
vectorised over tiles and looping over 128-pair chunks.

Feature lanes (32): [xy(2) | conic(3) | opacity(1) | color(3) | vp(3) |
t(1) | cpx(3) | cpy(3) | rp(2) | nrm(3) | pad(8)]; color mode keeps the
first 16. Raw lanes: color (8) [C(3) | W | logT | n_contrib | pad(2)];
otherwise (24) [C(3) | W | coord(3) | D | nrm(3) | mcoord(3) | mdepth_t |
logT | n_contrib | med_pos | pad(6)].
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from igs_tpu_torch.ops.binning import TilePairs
from igs_tpu_torch.ops.projection import ProjectedGaussians, TILE_X, TILE_Y
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
    """Launch ``csrc/blend_fwd.cu`` on the current stream → (T, 256, nl)."""
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
    with torch.cuda.device(feats_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feats_t.data_ptr(), feats_t.shape[1], tile_start.data_ptr(),
                 tile_count.data_ptr(), num_tiles, grid_x, grid_x * grid_y,
                 MODES[mode], out.data_ptr(), stream)
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
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.igs_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


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
        out[tiles] = _plain_tiles(feats_t, tile_start[tiles].long(),
                                  tile_count[tiles].long(), tiles, grid_x,
                                  grid_x * grid_y, mode, chunk)
    return out


def _plain_tiles(feats_t, start, count, tiles, grid_x, tiles_per_view, mode,
                 chunk):
    dev = feats_t.device
    nt = tiles.shape[0]
    mp = feats_t.shape[1]
    pidx = torch.arange(P, device=dev)
    lt = tiles % tiles_per_view
    px = ((lt % grid_x) * TILE_X)[:, None].float() + (pidx % TILE_X).float()
    py = ((lt // grid_x) * TILE_Y)[:, None].float() + (pidx // TILE_X).float()

    logt = torch.zeros((nt, P), device=dev)
    done = torch.zeros((nt, P), dtype=torch.bool, device=dev)
    acc_c = torch.zeros((nt, P, 4), device=dev)
    acc_cd = torch.zeros((nt, P, 4), device=dev)
    acc_n = torch.zeros((nt, P, 3), device=dev)
    acc_med = torch.zeros((nt, P, 4), device=dev)
    med_pos = torch.full((nt, P), -1.0, device=dev)
    n_contrib = torch.zeros((nt, P), device=dev)
    kk = torch.arange(chunk, device=dev)

    nmax = int(count.max()) if nt else 0
    for c0 in range(0, nmax, chunk):
        act = torch.nonzero((count > c0) & ~done.all(dim=1))[:, 0]
        if act.numel() == 0:
            break
        slot = c0 + kk  # (K,) local pair index
        live = slot[None, :] < count[act, None]  # (A, K)
        col = torch.clamp(start[act, None] + slot[None, :], max=max(mp - 1, 0))
        f = feats_t[:, col].permute(1, 2, 0)  # (A, K, lanes)
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

    if mode == "color":
        pad = torch.zeros((nt, P, 2), device=dev)
        return torch.cat([acc_c, logt[..., None], n_contrib[..., None], pad], -1)
    pad = torch.zeros((nt, P, 6), device=dev)
    return torch.cat([acc_c, acc_cd, acc_n, acc_med, logt[..., None],
                      n_contrib[..., None], med_pos[..., None], pad], -1)


def blend_raw_packed(feats_t, tile_start, tile_count, grid_x: int,
                     grid_y: int, mode: str = "full") -> torch.Tensor:
    """(lanes, pairs) packed features → (T, 256, nl) raw accumulators.

    A CUDA tensor goes to the kernel, a CPU tensor to the plain version.
    """
    if feats_t.is_cuda:
        return blend_raw_packed_cuda(feats_t, tile_start, tile_count, grid_x,
                                     grid_y, mode)
    if feats_t.device.type != "cpu":
        raise ValueError(f"no blend for device {feats_t.device}")
    return blend_raw_packed_plain(feats_t, tile_start, tile_count, grid_x,
                                  grid_y, mode)


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
    feats_t = torch.index_select(rows, 1, pairs.gauss_id.clamp_min(0).long())
    raw = blend_raw_packed(feats_t, pairs.tile_start, pairs.tile_count,
                           grid_x, grid_y, mode)
    if mode == "color":
        return raw_to_outputs_color(raw, views, grid_x, grid_y, height, width,
                                    bg)
    return raw_to_outputs(raw, views, grid_x, grid_y, height, width, focal_x,
                          focal_y, bg)
