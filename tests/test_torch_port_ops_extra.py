"""The last op and core helpers against the JAX package.

Compact binning (``build_tile_lists_compact``) bit for bit against JAX's,
with depth ties (ties go by index) and at a window that truncates, and
against ``pairs_to_idx_table`` of the sort route where nothing truncates;
the windowed route on compact lists against JAX's (interpret mode).
``select_anchors_no_fps`` and ``knn_weights`` exactly (the port's exact
KNN is JAX's on the CPU, ROADMAP C1; weights within 1e-6), and the
camera helpers ``focal2fov``, ``world_to_view``, ``intrinsic_to_fov``,
``get_ray_directions`` and ``get_rays`` within 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.core import camera as jcam_mod
from igs_tpu.ops.anchors import select_anchors_no_fps as jax_no_fps
from igs_tpu.ops.binning import build_tile_lists_compact as jax_compact
from igs_tpu.ops.knn import knn_weights as jax_knn_weights
from igs_tpu.ops.projection import project as jax_project
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu_torch.core import camera as cam_mod
from igs_tpu_torch.ops import binning
from igs_tpu_torch.ops.anchors import select_anchors_no_fps
from igs_tpu_torch.ops.binning import (
    build_tile_lists_compact, build_tile_pairs, image_tile_grid)
from igs_tpu_torch.ops.knn import knn_weights
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.ops.render_tiles import pairs_to_idx_table
from tests.test_torch_port_render_tiles import (
    H, W, _cams, _check_forward, _jax_run, _jax_args, _port_run, _scene)
from tests.torch_port_common import to_torch_gaussians

torch.set_num_threads(2)


def _tied_scene(n=500):
    """The test scene with every third Gaussian's z copied from its
    neighbour (x and y kept): under an unrotated camera (``yaw=0``) the
    depth sort meets exact ties."""
    jg, _ = _scene(n=n)
    xyz = np.asarray(jg.xyz).copy()
    xyz[1::3, 2] = xyz[0:-1:3, 2][: len(xyz[1::3])]
    jg = jg.replace(xyz=jnp.asarray(xyz))
    return jg, to_torch_gaussians(jg)


def _projections(jg, tg, yaw=0.0):
    jcam, tcam = _cams(yaw)
    jp = jax_project(jg.get_xyz, jg.get_scaling, jg.get_rotation,
                     jg.get_opacity, jcam, shs=jg.shs, valid=jg.valid)
    tp = project(tg.get_xyz, tg.get_scaling, tg.get_rotation, tg.get_opacity,
                 tcam.batched(), shs=tg.shs, valid=tg.valid)
    return jp, tp


@pytest.mark.parametrize("max_per_tile", [96, 512])
def test_compact_lists_equal_jax(max_per_tile, monkeypatch):
    jg, tg = _tied_scene()
    jp, tp = _projections(jg, tg)
    depth = np.asarray(jp.depth)[np.asarray(jp.visible)]
    assert len(np.unique(depth)) < len(depth)  # ties in the sort key
    gx, gy = image_tile_grid(H, W)
    want_idx, want_cnt = jax.jit(jax_compact, static_argnums=(1, 2, 3))(
        jp, gx, gy, max_per_tile)
    got_idx, got_cnt = build_tile_lists_compact(tp, gx, gy, max_per_tile)
    np.testing.assert_array_equal(got_idx[0].numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_cnt[0].numpy(), np.asarray(want_cnt))
    truncates = bool((np.asarray(want_cnt) == max_per_tile).any())
    assert truncates == (max_per_tile == 96)
    # the tile level in blocks of one row gives the same lists
    monkeypatch.setattr(binning, "COMPACT_BLOCK_ELEMS", 1)
    one_row = build_tile_lists_compact(tp, gx, gy, max_per_tile)
    assert torch.equal(one_row[0], got_idx) and torch.equal(one_row[1],
                                                            got_cnt)


def test_compact_lists_equal_the_sort_route():
    """Two views at once; where no tile truncates, each view's lists are
    the sort route's idx table (its rows are of the stacked Gaussians, so
    view v's ids are offset by v·N)."""
    _, tg = _tied_scene()
    _, tcam0 = _cams(0.0)
    _, tcam1 = _cams(-0.2)
    cams = cam_mod.Camera.stack([tcam0, tcam1])
    tp = project(tg.get_xyz, tg.get_scaling, tg.get_rotation, tg.get_opacity,
                 cams, shs=tg.shs, valid=tg.valid)
    gx, gy = image_tile_grid(H, W)
    n = tg.xyz.shape[0]
    idx, cnt = build_tile_lists_compact(tp, gx, gy, 512)
    pairs = build_tile_pairs(tp, gx, gy, 1 << 16)
    want = pairs_to_idx_table(pairs, 512).reshape(2, gx * gy, 512)
    offset = torch.arange(2, dtype=torch.int32)[:, None, None] * n
    assert int(pairs.tile_count.max()) < 512
    assert torch.equal(torch.where(idx >= 0, idx + offset, idx), want)
    assert torch.equal(cnt.reshape(-1), pairs.tile_count)


def test_windowed_route_on_compact_lists_matches_jax():
    """``impl="pallas"`` with compact binning reads each tile's list in
    place as its window; JAX's windowed kernels in interpret mode on its
    compact table. Full outputs, a window that truncates (overflow 0 on
    compact binning in both)."""
    jg, tg = _scene()
    jcam, tcam = _cams()
    kw = dict(image_height=H, image_width=W, impl="pallas", binning="compact",
              max_pairs=1 << 14, max_per_tile=96, chunk=32)
    want, _ = _jax_run(_jax_args(jg), jg.valid, jcam,
                       JSettings(pallas_interpret=True, **kw))
    got, _ = _port_run(tg, tcam, RasterSettings(**kw), grad=False)
    for k in ("color", "alpha", "depth", "mdepth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-5, rtol=1e-3, err_msg=k)
    np.testing.assert_array_equal(got["n_contrib"].numpy(),
                                  np.asarray(want["n_contrib"]))
    assert int(got["overflow_tiles"]) == int(want["overflow_tiles"]) == 0
    tiles_kw = dict(kw, impl="tiles")
    tiles, _ = _port_run(tg, tcam, RasterSettings(**tiles_kw), grad=False)
    want_tiles, _ = _jax_run(_jax_args(jg), jg.valid, jcam,
                             JSettings(**tiles_kw))
    _check_forward(tiles, want_tiles)


@pytest.mark.parametrize("anchor_size", [16, 64])
def test_select_anchors_no_fps_matches_jax(anchor_size):
    """16 slots: the in-bbox points overflow the budget and the rest stay
    static; 64: every in-bbox point self-anchors."""
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-1.5, 1.5, (160, 3)).astype(np.float32)
    valid = np.ones(160, bool)
    valid[::7] = False
    bbox = np.float32([[-1, -1, -1], [1, 1, 1]])
    want = jax_no_fps(jnp.asarray(xyz), jnp.asarray(bbox),
                      valid=jnp.asarray(valid), anchor_size=anchor_size, k=4)
    got = select_anchors_no_fps(torch.from_numpy(xyz), torch.from_numpy(bbox),
                                valid=torch.from_numpy(valid),
                                anchor_size=anchor_size, k=4)
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    in_bbox = int(np.asarray(want.mask).sum())
    assert (in_bbox == anchor_size) == (anchor_size == 16)


def test_knn_weights_matches_jax():
    rng = np.random.RandomState(2)
    anchors = rng.normal(size=(32, 3)).astype(np.float32)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    w_want, i_want = jax_knn_weights(jnp.asarray(anchors), jnp.asarray(pts),
                                     k=8, temperature=7.0)
    w_got, i_got = knn_weights(torch.from_numpy(anchors),
                               torch.from_numpy(pts), k=8, temperature=7.0)
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_want))
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_want), atol=1e-6)
    np.testing.assert_allclose(w_got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_camera_helpers_match_jax():
    rng = np.random.RandomState(4)
    f = np.float32(rng.uniform(300, 900, 3))
    np.testing.assert_allclose(
        cam_mod.focal2fov(torch.from_numpy(f), 512).numpy(),
        np.asarray(jcam_mod.focal2fov(jnp.asarray(f), 512)), atol=1e-6)
    assert cam_mod.focal2fov(700.0, 512) == float(
        np.float64(2 * np.arctan(512 / 1400.0)))

    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    r = np.float32([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]])
    t = rng.normal(size=3).astype(np.float32)
    np.testing.assert_array_equal(
        cam_mod.world_to_view(torch.from_numpy(r), torch.from_numpy(t)).numpy(),
        np.asarray(jcam_mod.world_to_view(jnp.asarray(r), jnp.asarray(t))))

    for got, want in zip(cam_mod.intrinsic_to_fov(600.0, 650.0, 1352, 1014),
                         jcam_mod.intrinsic_to_fov(600.0, 650.0, 1352, 1014)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = r
    c2w[:3, 3] = t
    for kw in (dict(focal=40.0), dict(focal=(40.0, 38.0),
                                      principal=(13.0, 9.5)),
               dict(focal=40.0, use_pixel_centers=False)):
        d_want = jcam_mod.get_ray_directions(20, 28, **kw)
        d_got = cam_mod.get_ray_directions(20, 28, **kw)
        np.testing.assert_allclose(d_got.numpy(), np.asarray(d_want),
                                   atol=1e-6)
        for keepdim in (True, False):
            for g, w_ in zip(cam_mod.get_rays(d_got, torch.from_numpy(c2w),
                                              keepdim=keepdim),
                             jcam_mod.get_rays(d_want, jnp.asarray(c2w),
                                               keepdim=keepdim)):
                assert g.shape == w_.shape
                np.testing.assert_allclose(g.numpy(), np.asarray(w_),
                                           atol=1e-6)
