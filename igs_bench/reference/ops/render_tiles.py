"""The tile renderer in plain PyTorch: the ``impl="tiles"`` oracle.

Counterpart of ``igs_tpu/ops/render_tiles.py``: front-to-back blending of
each tile's depth-ordered Gaussian list, written as log-space cumulative
sums over chunks of ``chunk`` Gaussians, so a chunk's blend is a
(pixels × Gaussians) product per tile. The backward is autograd through
this formulation, with each chunk's step under
``torch.utils.checkpoint`` (the JAX package checkpoints its scan body):
a backward keeps one chunk's intermediates alive, not every chunk's.

Tiles are walked in blocks of ``BLOCK_ELEMS // (chunk·256)``, each
block through every chunk, so a chunk's intermediates stay bounded
(autograd keeps several dozen of them in the backward); the blocks
change no tile's arithmetic. Given ``tile_count``, the tiles are taken
deepest first and a block walks only the chunks its deepest tile needs,
so the work follows the pairs rather than the table's width.

The route shares no code with the blend kernels (``ops/blend.py``,
``ops/blend_windowed.py``) beyond the constants and the untiling, so it
holds them to the JAX package's semantics; it is never a fallback.
Skip and termination are the reference's: a pair is a candidate where
``power <= 0`` and ``alpha >= 1/255``; a pixel is done once its
transmittance falls below 1e-4, carried across chunks. The median is
the last accepted pair with ``T_before > 0.5``; ``n_contrib`` and
``max_contrib`` are 1-based positions in the tile's list.

The JAX package's quirk is kept: ``max_per_tile // chunk`` chunks are
walked (at least one), so a table whose width is not a multiple of
``chunk`` never reads its last ``width % chunk`` columns.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from igs_bench.reference.ops.binning import TilePairs
from igs_bench.reference.ops.blend import LOG_TERM, MIN_ALPHA, RenderOutputs, untile
from igs_bench.reference.ops.projection import ProjectedGaussians, TILE_X, TILE_Y
from igs_bench.reference.utils.safe_math import safe_norm

# elements of one (tiles, chunk, 256) intermediate: 128 MiB in float32
BLOCK_ELEMS = 1 << 25


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


def _chunk_features(proj: ProjectedGaussians, ids: torch.Tensor) -> dict:
    """Blend inputs of the pairs ``ids`` (T, G): each field (T, G, ...).
    ``proj`` holds its rows flat, (M, ...).

    Only the live slots are gathered; padding slots (-1) read zeros, where
    the JAX package reads row 0. No output depends on a padding slot's
    values (it is never a candidate, and a median read from it is
    discarded), but its gradient would be: gathering row 0 for every
    padding slot sends millions of zero gradients to one row, which the
    gather's backward then adds one by one.
    """
    pos = torch.nonzero(ids >= 0, as_tuple=True)
    rows = ids[pos].long()

    def take(x):
        out = x.new_zeros(ids.shape + x.shape[1:])
        out[pos] = torch.index_select(x, 0, rows)
        return out

    return dict(
        xy=take(proj.means2d),
        conic=take(proj.conic),
        opacity=take(proj.opacity),
        color=take(proj.color),
        vp=take(proj.view_point),
        t=take(proj.t_center),
        cp=take(proj.camera_plane),
        rp=take(proj.ray_plane),
        nrm=take(proj.normal),
        live=ids >= 0,
    )


def _take(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """x (T, G, ...) at the per-pixel slots sel (T, P) → (T, P, ...)."""
    idx = sel.reshape(sel.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(sel.shape + x.shape[2:]))


def _blend_chunk(carry: dict, feats: dict, pixf: torch.Tensor,
                 contrib_base: int, color_only: bool = False) -> dict:
    """Blend one chunk of G Gaussians into every tile's P pixels.

    carry: per-pixel state, (T, P) / (T, P, C). feats: the chunk's
    ``_chunk_features`` (T, G, ...). pixf: (T, P, 2) pixel coordinates.
    contrib_base: the chunk's offset in the tile lists.
    """
    g = feats["xy"].shape[1]
    dx = feats["xy"][:, :, 0:1] - pixf[:, None, :, 0]  # (T, G, P)
    dy = feats["xy"][:, :, 1:2] - pixf[:, None, :, 1]
    cx = feats["conic"][:, :, 0:1]
    cy = feats["conic"][:, :, 1:2]
    cz = feats["conic"][:, :, 2:3]
    power = -0.5 * (cx * dx * dx + cz * dy * dy) - cy * dx * dy
    # exp only where power <= 0 (the candidate test) keeps autograd finite
    alpha = torch.clamp_max(
        feats["opacity"][:, :, None] * torch.exp(torch.clamp_max(power, 0.0)),
        0.99)
    cand = feats["live"][:, :, None] & (power <= 0.0) & (alpha >= MIN_ALPHA)
    zero = torch.zeros_like(alpha)
    a = torch.where(cand, alpha, zero)
    log1m = torch.log1p(-a)  # 0 for non-candidates
    cum_incl = carry["logT"][:, None, :] + torch.cumsum(log1m, dim=1)
    cum_excl = cum_incl - log1m
    alive = cum_incl >= LOG_TERM
    accept = cand & alive & ~carry["done"][:, None, :]
    t_before = torch.exp(cum_excl)
    w = torch.where(accept, a * t_before, zero)  # (T, G, P)
    if color_only:
        # color and alpha alone: the geometry and the median stay as they
        # are, only the transmittance, the count and ``done`` go on
        f = torch.cat([feats["color"], torch.ones_like(feats["t"][..., None])],
                      dim=-1)  # (T, G, 4)
        acc = torch.bmm(w.transpose(1, 2), f)  # (T, P, 4)
        out = dict(carry, color=carry["color"] + acc[..., 0:3],
                   weight=carry["weight"] + acc[..., 3])
        gidx = torch.arange(1, g + 1, dtype=torch.int32,
                            device=w.device)[None, :, None]
        izero = torch.zeros((), dtype=torch.int32, device=w.device)
        lastg = torch.amax(torch.where(accept, gidx, izero), dim=1)
        out["n_contrib"] = torch.where(lastg > 0, contrib_base + lastg,
                                       carry["n_contrib"])
        out["logT"] = carry["logT"] + torch.sum(
            torch.where(accept, log1m, zero), dim=1)
        out["done"] = carry["done"] | torch.any(cand & ~alive, dim=1)
        return out
    wdx = w * dx
    wdy = w * dy

    f1 = torch.cat([feats["color"], feats["vp"], feats["t"][..., None],
                    feats["nrm"], torch.ones_like(feats["t"][..., None])],
                   dim=-1)  # (T, G, 11)
    f2 = torch.cat([feats["cp"][..., 0::2], feats["rp"][..., 0:1]], dim=-1)
    f3 = torch.cat([feats["cp"][..., 1::2], feats["rp"][..., 1:2]], dim=-1)
    # the three (pixels × Gaussians) products as one, block-diagonal in
    # the features: a product that no loss reads would otherwise keep its
    # (T, G, P) operands for a backward that never runs, and under the
    # checkpoint every chunk's (a color-only loss never reads acc2, acc3)
    z = lambda c: torch.zeros(f1.shape[:2] + (c,), dtype=f1.dtype,
                              device=f1.device)
    feats_all = torch.cat([torch.cat([f1, z(8)], -1),
                           torch.cat([z(11), f2, z(4)], -1),
                           torch.cat([z(15), f3], -1)], dim=1)  # (T, 3G, 19)
    acc = torch.bmm(torch.cat([w, wdx, wdy], dim=1).transpose(1, 2),
                    feats_all)  # (T, P, 19)
    acc1, acc2, acc3 = acc[..., :11], acc[..., 11:15], acc[..., 15:]

    out = dict(
        color=carry["color"] + acc1[..., 0:3],
        coord=carry["coord"] + acc1[..., 3:6] + acc2[..., 0:3]
        + acc3[..., 0:3],
        depth=carry["depth"] + acc1[..., 6] + acc2[..., 3] + acc3[..., 3],
        normal=carry["normal"] + acc1[..., 7:10],
        weight=carry["weight"] + acc1[..., 10],
    )

    # median: the last accepted pair with T_before > 0.5 records its values
    med = accept & (t_before > 0.5)
    gidx = torch.arange(1, g + 1, dtype=torch.int32,
                        device=w.device)[None, :, None]
    izero = torch.zeros((), dtype=torch.int32, device=w.device)
    sel1 = torch.amax(torch.where(med, gidx, izero), dim=1)  # (T, P), 0 = none
    has = sel1 > 0
    gsel = torch.clamp_min(sel1 - 1, 0).long()
    # dx, dy at the selected slot, recomputed from the slot's mean (the
    # same subtraction, so the same bits): a gather from the (T, G, P)
    # dx would keep dx for a backward that never runs when no loss reads
    # the median, and under the checkpoint every chunk's copy of it
    xys = _take(feats["xy"], gsel)  # (T, P, 2)
    dxs = xys[..., 0] - pixf[..., 0]
    dys = xys[..., 1] - pixf[..., 1]
    rp = _take(feats["rp"], gsel)
    cp = _take(feats["cp"], gsel)
    t_sel = _take(feats["t"], gsel) + rp[..., 0] * dxs + rp[..., 1] * dys
    coord_sel = (_take(feats["vp"], gsel) + cp[..., 0::2] * dxs[..., None]
                 + cp[..., 1::2] * dys[..., None])
    out["mdepth"] = torch.where(has, t_sel, carry["mdepth"])
    out["mcoord"] = torch.where(has[..., None], coord_sel, carry["mcoord"])
    out["max_contrib"] = torch.where(has, contrib_base + sel1,
                                     carry["max_contrib"])

    # last contributor: the position of the last accepted pair
    lastg = torch.amax(torch.where(accept, gidx, izero), dim=1)
    out["n_contrib"] = torch.where(lastg > 0, contrib_base + lastg,
                                   carry["n_contrib"])
    out["logT"] = carry["logT"] + torch.sum(
        torch.where(accept, log1m, zero), dim=1)
    out["done"] = carry["done"] | torch.any(cand & ~alive, dim=1)
    return out


def _tile_pixf(num_tiles: int, grid_x: int, device) -> torch.Tensor:
    """(num_tiles, 256, 2) float pixel coordinates of the tiles of a grid
    ``grid_x`` tiles wide, row-major in each tile."""
    tid = torch.arange(num_tiles, dtype=torch.int32, device=device)
    tx0 = (tid % grid_x) * TILE_X
    ty0 = torch.div(tid, grid_x, rounding_mode="floor") * TILE_Y
    py, px = torch.meshgrid(
        torch.arange(TILE_Y, dtype=torch.float32, device=device),
        torch.arange(TILE_X, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([tx0[:, None].float() + px.reshape(-1)[None, :],
                        ty0[:, None].float() + py.reshape(-1)[None, :]], -1)


def render_tiles(proj: ProjectedGaussians, idx_table: torch.Tensor,
                 height: int, width: int, focal_x, focal_y, bg: torch.Tensor,
                 chunk: int = 256, tile_count=None,
                 color_only: bool = False) -> RenderOutputs:
    """Blend every view's tiles through their Gaussian lists.

    proj: (V, N, ...) per view. idx_table: (V·T, max_per_tile) int32 rows
    of the (V·N) flattened Gaussians, -1 padded, view v's tiles at
    v·T … v·T + T−1. focal_x, focal_y: () or (V,). bg: (3,) or (V, 3).
    """
    grid_x = (width + TILE_X - 1) // TILE_X
    grid_y = (height + TILE_Y - 1) // TILE_Y
    num_tiles = grid_x * grid_y
    views = proj.depth.shape[0]
    max_per_tile = idx_table.shape[1]
    if max_per_tile < chunk:
        # the JAX package's dynamic slice of `chunk` columns refuses it
        raise ValueError(f"max_per_tile {max_per_tile} < chunk {chunk}")
    n_chunks = max(1, max_per_tile // chunk)
    dev = proj.depth.device
    flat = ProjectedGaussians(*(x.reshape((-1,) + x.shape[2:]) for x in proj))
    pixf = _tile_pixf(num_tiles, grid_x, dev).repeat(views, 1, 1)

    vt = views * num_tiles
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in flat if x.is_floating_point())

    def step(carry, ids, pix, c0):
        return _blend_chunk(carry, _chunk_features(flat, ids), pix, c0,
                            color_only)

    # tiles are independent: walking them in blocks bounds a chunk's
    # (tiles, chunk, 256) intermediates, which autograd keeps several
    # dozen of, without changing any tile's arithmetic
    block = max(1, BLOCK_ELEMS // (chunk * 256))
    if tile_count is None:
        order = None
        need = [n_chunks] * vt
    else:
        order = torch.argsort(tile_count.to(torch.int64), descending=True,
                              stable=True)
        depth = tile_count.to(torch.int64)[order].cpu().tolist()
        need = [max(1, -(-d // chunk)) for d in depth]
        idx_table = idx_table[order]
        pixf_walk = pixf[order]
    carries = []
    for t0 in range(0, vt, block):
        nb = min(block, vt - t0)
        zeros = lambda *s: torch.zeros((nb, 256) + s, dtype=torch.float32,
                                       device=dev)
        izeros = torch.zeros((nb, 256), dtype=torch.int32, device=dev)
        carry = dict(logT=zeros(), done=torch.zeros(
            (nb, 256), dtype=torch.bool, device=dev), color=zeros(3),
            coord=zeros(3), depth=zeros(), normal=zeros(3), weight=zeros(),
            mdepth=zeros(), mcoord=zeros(3), max_contrib=izeros,
            n_contrib=izeros)
        pix = (pixf if order is None else pixf_walk)[t0:t0 + nb]
        for c0 in range(0, min(n_chunks, need[t0]) * chunk, chunk):
            ids = idx_table[t0:t0 + nb, c0:c0 + chunk]
            if grad:
                carry = checkpoint(step, carry, ids, pix, c0,
                                   use_reentrant=False)
            else:
                carry = step(carry, ids, pix, c0)
        carries.append(carry)
    carry = {k: torch.cat([c[k] for c in carries]) for k in carries[0]}
    if order is not None:
        inv = torch.argsort(order)
        carry = {k: v[inv] for k, v in carry.items()}

    # finalize (the reference's forward.cu:631-692)
    per_tile = lambda x: torch.as_tensor(
        x, dtype=torch.float32, device=dev).reshape(-1, 1).expand(
        views, num_tiles).reshape(vt, 1)
    fx, fy = per_tile(focal_x), per_tile(focal_y)
    bg_t = bg.to(torch.float32).reshape(-1, 1, 3).expand(
        views, num_tiles, 3).reshape(vt, 1, 3)
    t_final = torch.exp(carry["logT"])
    any_acc = carry["n_contrib"] > 0
    color = carry["color"] + t_final[..., None] * bg_t
    weight = carry["weight"]
    wsafe = torch.where(weight > 0, weight, torch.ones_like(weight))
    out_coord = torch.where(any_acc[..., None],
                            carry["coord"] / wsafe[..., None],
                            torch.zeros_like(carry["coord"]))
    # per-pixel ray norm (forward.cu:466-467), at W/2 and H/2 exactly
    lnf = torch.sqrt(((pixf[..., 0] - width / 2.0) / fx) ** 2
                     + ((pixf[..., 1] - height / 2.0) / fy) ** 2 + 1.0)
    depth_ln = carry["depth"] / lnf
    out_depth = torch.where(any_acc, depth_ln / wsafe,
                            torch.zeros_like(depth_ln))
    out_mdepth = carry["mdepth"] / lnf
    nlen = torch.clamp_min(safe_norm(carry["normal"], keepdim=True), 1e-12)
    out_normal = torch.where(any_acc[..., None], carry["normal"] / nlen,
                             torch.zeros_like(carry["normal"]))

    def img(x):
        if x.dim() == 3:
            return untile(x, views, grid_x, grid_y, height, width)
        return untile(x[..., None], views, grid_x, grid_y, height,
                      width)[:, 0]

    return RenderOutputs(
        color=img(color), alpha=img(weight), coord=img(out_coord),
        mcoord=img(carry["mcoord"]), depth=img(out_depth),
        mdepth=img(out_mdepth), normal=img(out_normal),
        accum_coord=img(carry["coord"]), accum_depth=img(depth_ln),
        n_contrib=img(carry["n_contrib"]),
        max_contrib=img(carry["max_contrib"]),
    )
