"""Port rasterizer against JAX ``rasterize(impl="pallas_packed")`` in
interpret mode, on the same Gaussians and camera.

Binning outputs must match exactly. Images are held at 2e-4 absolute (the
JAX kernel's bf16 split-dot envelope), except at pixels whose
``n_contrib`` flips at the termination threshold, which are counted.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.core.camera import Camera as JCamera
from igs_tpu.ops.binning import build_tile_pairs as jax_build_pairs
from igs_tpu.ops.projection import project as jax_project
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.ops.rasterize import build_pairs_packed as jax_build_pairs_packed
from igs_tpu.ops.rasterize import rasterize as jax_rasterize
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.ops.binning import build_tile_pairs
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.rasterize import (
    RasterSettings, build_pairs_packed, rasterize)
from tests.conftest import random_gaussians

torch.set_num_threads(2)

H, W = 40, 56  # partial edge tiles on both axes


def _w2c(radius=4.0, yaw=0.15):
    c, s = np.cos(yaw), np.sin(yaw)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    w2c[2, 3] = radius
    return w2c


def _scene(seed=0, n=300):
    jg = random_gaussians(n=n, seed=seed)
    valid = np.ones(n, bool)
    valid[::17] = False
    tg = Gaussians.create(np.asarray(jg.xyz), np.asarray(jg.opacity),
                          np.asarray(jg.rotation), np.asarray(jg.scaling),
                          np.asarray(jg.shs), valid=valid, device="cpu")
    jg = jg.replace(valid=jnp.asarray(valid))
    jcam = JCamera.from_w2c(_w2c(), 0.8, 0.7, height=H, width=W)
    tcam = Camera.from_w2c(_w2c(), 0.8, 0.7, height=H, width=W, device="cpu")
    return jg, tg, jcam, tcam


def _args(g):
    return dict(means3d=g.get_xyz, opacity=g.get_opacity,
                scaling=g.get_scaling, rotation=g.get_rotation)


def test_projection_matches():
    jg, tg, jcam, tcam = _scene()
    want = jax_project(**{k: v for k, v in _args(jg).items()}, camera=jcam,
                       shs=jg.shs, valid=jg.valid)
    got = project(tg.get_xyz, tg.get_scaling, tg.get_rotation,
                  tg.get_opacity, tcam, shs=tg.shs, valid=tg.valid)
    for name in want._fields:
        w_, g_ = np.asarray(getattr(want, name)), getattr(got, name)[0].numpy()
        if w_.dtype in (np.int32, np.bool_):
            np.testing.assert_array_equal(g_, w_, err_msg=name)
        else:
            np.testing.assert_allclose(g_, w_, rtol=1e-4, atol=1e-4,
                                       err_msg=name)


def test_binning_matches_exactly():
    jg, tg, jcam, tcam = _scene(seed=3)
    jp = jax_project(**_args(jg), camera=jcam, shs=jg.shs, valid=jg.valid)
    tp = project(tg.get_xyz, tg.get_scaling, tg.get_rotation,
                 tg.get_opacity, tcam, shs=tg.shs, valid=tg.valid)
    gx, gy = (W + 15) // 16, (H + 15) // 16
    for budget in (1 << 14, 256):  # roomy and overflowing
        want = jax_build_pairs(jp, gx, gy, budget)
        got = build_tile_pairs(tp, gx, gy, budget)
        np.testing.assert_array_equal(got.gauss_id.numpy(),
                                      np.asarray(want.gauss_id))
        np.testing.assert_array_equal(got.tile_start.numpy(),
                                      np.asarray(want.tile_start))
        np.testing.assert_array_equal(got.tile_count.numpy(),
                                      np.asarray(want.tile_count))
        assert int(got.num_pairs[0]) == int(want.num_pairs)
        assert bool(got.overflowed[0]) == bool(want.overflowed)
    assert bool(got.overflowed[0])  # the small budget did overflow


@pytest.mark.parametrize("mode", ["color", "color_depth"])
@pytest.mark.parametrize("override", [False, True])
def test_rasterize_matches_jax(mode, override):
    jg, tg, jcam, tcam = _scene(seed=1)
    js = JSettings(image_height=H, image_width=W, impl="pallas_packed",
                   pallas_interpret=True, outputs=mode, max_pairs=1 << 14)
    ts = RasterSettings(image_height=H, image_width=W, outputs=mode,
                        max_pairs=1 << 14)
    jpairs = tpairs = None
    if override:
        # pairs binned from a shifted copy: a stale list, as the shared
        # window pairs are for later candidates
        shift = np.float32([0.05, -0.03, 0.0])
        jpairs = jax_build_pairs_packed(
            jg.get_xyz + shift, jg.get_opacity, jg.get_scaling,
            jg.get_rotation, jcam, valid=jg.valid, settings=js)
        tpairs = build_pairs_packed(
            tg.get_xyz + torch.from_numpy(shift), tg.get_opacity,
            tg.get_scaling, tg.get_rotation, tcam, valid=tg.valid,
            settings=ts)
        np.testing.assert_array_equal(tpairs.gauss_id.numpy(),
                                      np.asarray(jpairs.gauss_id))
    bg = np.float32([0.1, 0.2, 0.3])
    want = jax_rasterize(**_args(jg), camera=jcam, shs=jg.shs,
                         valid=jg.valid, bg=jnp.asarray(bg), settings=js,
                         pairs_override=jpairs)
    got = rasterize(**_args(tg), camera=tcam, shs=tg.shs, valid=tg.valid,
                    bg=torch.from_numpy(bg), settings=ts,
                    pairs_override=tpairs)
    flips = got["n_contrib"].numpy() != np.asarray(want["n_contrib"])
    assert flips.sum() <= 2
    ok = ~flips
    keys = ["color", "alpha"] + (["coord", "depth"] if mode != "color" else [])
    for k in keys:
        w_, g_ = np.asarray(want[k]), got[k].numpy()
        np.testing.assert_allclose(g_[..., ok], w_[..., ok], atol=2e-4,
                                   rtol=0, err_msg=k)
    assert int(got["overflow_tiles"]) == int(want["overflow_tiles"]) == 0
    np.testing.assert_array_equal(got["radii"].numpy(),
                                  np.asarray(want["radii"]))


def test_overflow_surfaced():
    jg, tg, jcam, tcam = _scene(seed=2)
    ts = RasterSettings(image_height=H, image_width=W, outputs="color",
                        max_pairs=128)
    got = rasterize(**_args(tg), camera=tcam, shs=tg.shs, valid=tg.valid,
                    settings=ts)
    assert int(got["overflow_tiles"]) == 1 << 20


def test_stacked_views_match_one_by_one():
    """Two views binned together and blended in one pass equal two
    separate renders (the depth-carry views' batched path)."""
    _, tg, _, _ = _scene(seed=4)
    cams = [Camera.from_w2c(_w2c(yaw=y), 0.8, 0.7, height=H, width=W,
                            device="cpu") for y in (0.1, -0.2)]
    ts = RasterSettings(image_height=H, image_width=W, outputs="color_depth",
                        max_pairs=1 << 13)
    both = rasterize(**_args(tg), camera=Camera.stack(cams), shs=tg.shs,
                     valid=tg.valid, settings=ts)
    for i, cam in enumerate(cams):
        one = rasterize(**_args(tg), camera=cam, shs=tg.shs, valid=tg.valid,
                        settings=ts)
        for k in ("color", "depth", "n_contrib"):
            np.testing.assert_allclose(both[k][i].numpy(), one[k].numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)


def test_cuda_entry_without_gpu_raises():
    from igs_tpu_torch.builders import build_model
    from igs_tpu_torch.stream.pipeline import StreamConfig, StreamingPipeline
    from igs_tpu_torch.stream.refine import RefineConfig
    from igs_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model({})
    model = build_model({"backbone": {"feature_channels": 32}}, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingPipeline(model, None, StreamConfig(), RefineConfig(),
                          RasterSettings())
    assert resolve_device("cpu").type == "cpu"
