"""Port contribution counting (``ops/count.py``, ``rasterize.count_gaussians``)
against ``igs_tpu/ops/rasterize.py``'s ``count_gaussians`` (the Pallas
count kernel in interpret mode) and both packages' dense oracles.

Counts are integers and must be equal; scores (count · projected opacity)
agree within atol/rtol 1e-4. The JAX package walks at most
``max_per_tile`` pairs of a tile and the port walks every pair: where a
tile holds more, the JAX counts equal the port's counts over the
truncated segments and fall short of the oracle.
"""

import numpy as np
import pytest
import torch

from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.ops.rasterize import count_gaussians as jax_count
from igs_tpu.ops.rasterize import count_gaussians_dense as jax_count_dense
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
from igs_tpu_torch.ops.blend import LOG_TERM, MIN_ALPHA, candidate_box
from igs_tpu_torch.ops.count import (
    count_contributions_packed, count_contributions_packed_plain, count_rows)
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.rasterize import (
    RasterSettings, count_gaussians, count_gaussians_dense)
from tests.conftest import make_camera, random_gaussians
from tests.torch_port_common import to_torch_gaussians

torch.set_num_threads(2)


def _inputs(n, seed, hw):
    jg = random_gaussians(n=n, seed=seed)
    tg = to_torch_gaussians(jg)
    jcam = make_camera(height=hw[0], width=hw[1])
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 4.0
    tcam = Camera.from_w2c(w2c, 0.8, 0.8, hw[0], hw[1], device="cpu")
    jargs = (jg.get_xyz, jg.get_opacity, jg.get_scaling, jg.get_rotation,
             jcam)
    targs = (tg.get_xyz, tg.get_opacity, tg.get_scaling, tg.get_rotation,
             tcam)
    return jargs, targs, jg.valid, tg.valid


def _jax_settings(hw, max_per_tile=256, chunk=64):
    return JSettings(image_height=hw[0], image_width=hw[1], impl="tiles",
                     pallas_interpret=True, max_per_tile=max_per_tile,
                     chunk=chunk, max_pairs=1 << 14)


@pytest.mark.parametrize("hw", [(32, 32), (40, 56)])
def test_count_gaussians_matches_jax_and_dense(hw):
    """~100 Gaussians; 40×56 has partial tiles on the right and bottom."""
    jargs, targs, jvalid, tvalid = _inputs(100, 2, hw)
    ts = RasterSettings(image_height=hw[0], image_width=hw[1],
                        max_pairs=1 << 14)
    count, score = count_gaussians(*targs, valid=tvalid, settings=ts)
    d_count, d_score = count_gaussians_dense(*targs, valid=tvalid,
                                             settings=ts)
    j_count, j_score = jax_count(*jargs, valid=jvalid,
                                 settings=_jax_settings(hw))
    jd_count, _ = jax_count_dense(*jargs, valid=jvalid,
                                  settings=_jax_settings(hw))
    assert count.dtype == torch.int32 and count.shape == (100,)
    assert int(count.sum()) > 0
    np.testing.assert_array_equal(count.numpy(), np.asarray(j_count))
    np.testing.assert_array_equal(count.numpy(), d_count.numpy())
    np.testing.assert_array_equal(count.numpy(), np.asarray(jd_count))
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(score.numpy(), d_score.numpy(),
                               atol=1e-4, rtol=1e-4)


def test_jax_truncates_dense_tiles_port_counts_every_pair():
    hw = (32, 32)
    jargs, targs, jvalid, tvalid = _inputs(100, 3, hw)
    max_per_tile = 32
    ts = RasterSettings(image_height=hw[0], image_width=hw[1],
                        max_pairs=1 << 14)
    xyz, opacity, scaling, rotation, cam = targs
    proj = project(xyz, scaling, rotation, opacity, cam.batched(),
                   colors_precomp=torch.zeros(100, 3), valid=tvalid,
                   geometry=False)
    gx, gy = image_tile_grid(*hw)
    pairs = build_tile_pairs(proj, gx, gy, ts.max_pairs)
    assert int(pairs.tile_count.max()) > max_per_tile

    count, _ = count_gaussians(*targs, valid=tvalid, settings=ts)
    d_count, _ = count_gaussians_dense(*targs, valid=tvalid, settings=ts)
    j_count, _ = jax_count(*jargs, valid=jvalid,
                           settings=_jax_settings(hw, max_per_tile, 16))
    truncated = count_contributions_packed_plain(
        count_rows(proj), pairs.gauss_id, pairs.tile_start,
        torch.clamp(pairs.tile_count, max=max_per_tile), gx, gy, hw[1], hw[0])
    np.testing.assert_array_equal(count.numpy(), d_count.numpy())
    np.testing.assert_array_equal(np.asarray(j_count), truncated.numpy())
    assert int(np.asarray(j_count).sum()) < int(count.sum())


def _direct_counts(rows, gauss_id, start, count, grid_x, grid_y, width,
                   height):
    """One pixel at a time, one pair at a time, in float32."""
    f32 = np.float32
    out = np.zeros(rows.shape[0], np.int64)
    for t in range(count.shape[0]):
        lt = t % (grid_x * grid_y)
        for p in range(256):
            x = (lt % grid_x) * 16 + p % 16
            y = (lt // grid_x) * 16 + p // 16
            if x >= width or y >= height:
                continue
            logt = f32(0.0)
            for j in range(start[t], start[t] + count[t]):
                g = gauss_id[j]
                mx, my, c0, c1, c2, o = rows[g]
                dx, dy = f32(mx - f32(x)), f32(my - f32(y))
                power = f32(f32(-0.5) * f32(f32(c0 * dx) * dx
                                            + f32(c2 * dy) * dy)
                            - f32(c1 * dx) * dy)
                if power > 0:
                    continue
                alpha = min(f32(0.99), f32(o * f32(np.exp(power))))
                if alpha < f32(MIN_ALPHA):
                    continue
                nxt = f32(logt + f32(np.log1p(f32(-alpha))))
                if nxt < f32(LOG_TERM):
                    break
                logt = nxt
                out[g] += 1
    return out


def test_count_plain_matches_direct_loop():
    """Two views of a 20×16 image (a partial tile each), seeded pairs of
    high opacity so that many pixels saturate and stop."""
    rng = np.random.RandomState(0)
    width, height, grid_x, grid_y = 20, 16, 2, 1
    n_rows = 30
    conic_a = rng.uniform(0.02, 0.2, n_rows)
    conic_c = rng.uniform(0.02, 0.2, n_rows)
    conic_b = rng.uniform(-0.5, 0.5, n_rows) * np.sqrt(conic_a * conic_c)
    rows = np.stack([rng.uniform(-2, 22, n_rows), rng.uniform(-2, 18, n_rows),
                     conic_a, conic_b, conic_c,
                     rng.uniform(0.3, 0.99, n_rows)], 1).astype(np.float32)
    segs = [rng.choice(n_rows, size=k, replace=False) for k in (14, 9, 20, 0)]
    gauss_id = np.concatenate(segs).astype(np.int32)
    count = np.array([len(s) for s in segs], np.int32)
    start = (np.cumsum(count) - count).astype(np.int32)
    want = _direct_counts(rows, gauss_id, start, count, grid_x, grid_y,
                          width, height)
    assert want.sum() > 0
    got = count_contributions_packed(
        torch.from_numpy(rows), torch.from_numpy(gauss_id),
        torch.from_numpy(start), torch.from_numpy(count), grid_x, grid_y,
        width, height)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # small chunks: the walk carries logT and the done flags across chunks
    again = count_contributions_packed_plain(
        torch.from_numpy(rows), torch.from_numpy(gauss_id),
        torch.from_numpy(start), torch.from_numpy(count), grid_x, grid_y,
        width, height, chunk=4, tile_block=3)
    np.testing.assert_array_equal(again.numpy(), want)


def _box_skipped_counts(rows, gauss_id, start, count, grid_x, grid_y, width,
                        height):
    """The count kernel's walk: warp w of a tile holds the 8×4 pixels x0 +
    (w&1)·8 + 0..7, y0 + (w>>1)·4 + 0..3 and skips every pair whose
    ``candidate_box`` misses them; pixels outside the image start done;
    each pixel's chain in float32, one pair at a time. → (counts, pixel-
    pairs skipped)."""
    out = torch.zeros(rows.shape[0], dtype=torch.int64)
    skipped = 0
    p = torch.arange(256)
    lx, ly = p % 16, p // 16
    rx = lx // 8 * 8  # the pixel's warp rectangle
    ry = ly // 4 * 4
    for t in range(count.shape[0]):
        lt = t % (grid_x * grid_y)
        tx0, ty0 = (lt % grid_x) * 16, (lt // grid_x) * 16
        px, py = (tx0 + lx).float(), (ty0 + ly).float()
        x0, y0 = (tx0 + rx).float(), (ty0 + ry).float()
        done = (tx0 + lx >= width) | (ty0 + ly >= height)
        logt = torch.zeros(256)
        for j in range(int(start[t]), int(start[t] + count[t])):
            g = int(gauss_id[j])
            if g < 0:
                continue
            f = rows[g]
            box = candidate_box(f[:, None])[0]
            walk = ~((box[0] > x0 + 7) | (box[1] < x0) | (box[2] > y0 + 3)
                     | (box[3] < y0))
            skipped += int((~walk & ~done).sum())
            dx, dy = f[0] - px, f[1] - py
            power = -0.5 * (f[2] * dx * dx + f[4] * dy * dy) - f[3] * dx * dy
            alpha = torch.clamp_max(f[5] * torch.exp(power), 0.99)
            cand = walk & ~done & (power <= 0) & (alpha >= MIN_ALPHA)
            nxt = logt + torch.log1p(-alpha)
            stop = cand & (nxt < LOG_TERM)
            take = cand & ~stop
            done |= stop
            logt = torch.where(take, nxt, logt)
            out[g] += int(take.sum())
    return out.to(torch.int32), skipped


def test_box_skipped_walk_counts_as_the_plain_version():
    """The count kernel skips, per warp, the pairs whose candidate box
    (``blend_common.cuh``; plain version ``ops/blend.candidate_box``)
    misses the warp's 8×4 pixels. Emulated on the 40×56 image (partial
    tiles, whose outside pixels start done), the skipped walk gives the
    plain version's per-row counts."""
    hw = (40, 56)
    _, targs, _, tvalid = _inputs(100, 2, hw)
    xyz, opacity, scaling, rotation, cam = targs
    proj = project(xyz, scaling, rotation, opacity, cam.batched(),
                   colors_precomp=torch.zeros(100, 3), valid=tvalid,
                   geometry=False)
    gx, gy = image_tile_grid(*hw)
    pairs = build_tile_pairs(proj, gx, gy, 1 << 14)
    args = (count_rows(proj), pairs.gauss_id, pairs.tile_start,
            pairs.tile_count, gx, gy, hw[1], hw[0])
    want = count_contributions_packed_plain(*args)
    got, skipped = _box_skipped_counts(*args)
    assert int(want.sum()) > 0 and skipped > 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_count_wrapper_rejects_bad_inputs():
    rows = torch.zeros(4, 6)
    ids = torch.zeros(3, dtype=torch.int32)
    tiles = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        count_contributions_packed(torch.zeros(4, 5), ids, tiles, tiles, 2, 1,
                                   20, 16)
    with pytest.raises(TypeError):
        count_contributions_packed(rows, ids.long(), tiles, tiles, 2, 1, 20,
                                   16)
    with pytest.raises(ValueError):
        count_contributions_packed(rows, ids, tiles, tiles, 3, 1, 20, 16)
