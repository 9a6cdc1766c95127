"""Port frame-0 build (``igs_tpu_torch/train/frame0.py``,
``igs_tpu_torch/build_frame0.py``) against ``igs_tpu/train/frame0.py`` and
``build_frame0.py``.

The JAX side renders with ``impl="tiles"`` and runs its count kernel in
interpret mode (the settings of ``tests/test_frame0.py``); the port runs
the plain versions of its kernels. States cross from JAX to the port
through ``state_from_numpy``. Tolerances:
  * init, position lr, 3D filter, filter fusion, depth normals: 1e-5
    relative;
  * one step: loss 1e-4 relative, grads (first moments) and densify
    statistics atol 2e-5 / rtol 1e-3, parameters where |g| > 1e-4 (Adam's
    first step is lr·sign(g), ROADMAP C9);
  * eight steps: losses 1e-3 relative;
  * densify, reset, importance prune: the same live rows.
The whole build is held to ``build_frame0.py`` in
``tests/test_torch_port_build_frame0.py``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.core.gaussians import fuse_3d_filter as jax_fuse
from igs_tpu.data.ply import save_gaussian_ply as jax_save_ply
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.stream import refine as jref
from igs_tpu.train import frame0 as jf0
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import fuse_3d_filter
from igs_tpu_torch.data.ply import load_gaussian_ply
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.stream import refine as tref
from igs_tpu_torch.train import frame0 as tf0
from tests.conftest import make_camera, random_gaussians
from tests.torch_port_common import to_torch_gaussians

torch.set_num_threads(2)

HW = 32
JS = JSettings(image_height=HW, image_width=HW, impl="tiles",
               max_pairs=1 << 14, max_per_tile=256, chunk=64,
               pallas_interpret=True)
TS = RasterSettings(image_height=HW, image_width=HW, max_pairs=1 << 14)
RADII = (4.0, 4.5)


def _cams():
    jcams = [make_camera(height=HW, width=HW, radius=r) for r in RADII]
    tcams = []
    for r in RADII:
        w2c = np.eye(4, dtype=np.float32)
        w2c[2, 3] = r
        tcams.append(Camera.from_w2c(w2c, 0.8, 0.8, HW, HW, device="cpu"))
    return jcams, Camera.stack(tcams)


def _points(n=48, seed=1):
    rng = np.random.RandomState(seed)
    target = random_gaussians(n=n, seed=seed)
    pts = np.asarray(target.xyz) + 0.05 * rng.normal(size=(n, 3)).astype(
        np.float32)
    cols = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    return target, pts, cols


def _port_state(jst):
    return tf0.state_from_numpy(
        to_torch_gaussians(jst.gaussians),
        {k: np.asarray(v) for k, v in jst.adam_m.items()},
        {k: np.asarray(v) for k, v in jst.adam_v.items()},
        step=int(jst.step), max_radii2d=np.asarray(jst.max_radii2d),
        xyz_grad_accum=np.asarray(jst.xyz_grad_accum),
        denom=np.asarray(jst.denom), device="cpu")


def _gts(jcams, target):
    from igs_tpu.ops.rasterize import rasterize as jax_rasterize

    return np.stack([np.asarray(jax_rasterize(
        means3d=target.get_xyz, opacity=target.get_opacity,
        scaling=target.get_scaling, rotation=target.get_rotation, camera=c,
        shs=target.shs, valid=target.valid, settings=JS)["color"])
        for c in jcams])


@functools.lru_cache(maxsize=None)
def _jax_step(reg_on):
    """The JAX frame0_step, jitted once per regulariser setting for every
    test of this file."""
    return jax.jit(lambda st, cam, gt, fl, lr: jf0.frame0_step(
        st, cam, gt, jnp.zeros(3), fl, jf0.Frame0Config(), JS, lr, reg_on))


def _assert_rel(got, want, rtol=1e-5, atol=1e-7, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("n,capacity", [(48, 64), (80, 60)])
def test_create_from_points_matches_jax(n, capacity):
    """(80, 60): more points than slots, the uniform downsample."""
    _, pts, cols = _points(n)
    jg = jf0.create_from_points(pts, cols, capacity)
    tg = tf0.create_from_points(pts, cols, capacity, device="cpu")
    np.testing.assert_array_equal(tg.valid.numpy(), np.asarray(jg.valid))
    for name in ("xyz", "opacity", "rotation", "scaling", "shs"):
        _assert_rel(getattr(tg, name).numpy(), getattr(jg, name), msg=name)


def test_position_lr_matches_jax():
    cfg = tf0.Frame0Config()
    for step in (0, 1, 700, 6000, 30_000, 40_000):
        for scale in (1.0, 2.37):
            want = float(jf0.position_lr(step, jf0.Frame0Config(), scale))
            assert abs(tf0.position_lr(step, cfg, scale) - want) <= 1e-5 * want


def test_filter_fusion_and_depth_normals_match_jax():
    jcams, tcams = _cams()
    jg = random_gaussians(n=64, seed=6).pad_to(80)
    tg = to_torch_gaussians(jg)
    jfilt = jf0.compute_3d_filter(jg.xyz, jg.valid, jcams)
    tfilt = tf0.compute_3d_filter(tg.xyz, tg.valid, tcams)
    _assert_rel(tfilt.numpy(), jfilt, msg="filter")
    _assert_rel(fuse_3d_filter(tg.scaling, tg.opacity, tfilt)[0].numpy(),
                jax_fuse(jg.scaling, jg.opacity, jfilt)[0], msg="fused scale")
    for got, want in zip(tf0.fused_render_args(tg, tfilt),
                         jf0.fused_render_args(jg, jfilt)):
        _assert_rel(got.numpy(), want)
    depth = np.random.RandomState(0).uniform(3, 5, (HW, HW + 8)).astype(
        np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 4.0
    jcam = make_camera(height=HW, width=HW + 8)
    tcam = Camera.from_w2c(w2c, 0.8, 0.8, HW, HW + 8, device="cpu")
    _assert_rel(tf0.depth_to_normal(torch.from_numpy(depth), tcam).numpy(),
                jf0.depth_to_normal(jnp.asarray(depth), jcam), atol=1e-6)


@pytest.mark.parametrize("reg_on", [False, True])
def test_frame0_step_matches_jax(reg_on):
    jcams, tcams = _cams()
    target, pts, cols = _points()
    gts = _gts(jcams, target)
    jst = jref.init_refine_state(jf0.create_from_points(pts, cols, 64), 64)
    filt = jf0.compute_3d_filter(jst.gaussians.xyz, jst.gaussians.valid,
                                 jcams)
    lr = jf0.position_lr(1, jf0.Frame0Config(), 1.0)
    jnext, jloss = _jax_step(reg_on)(jst, jcams[0], jnp.asarray(gts[0]),
                                     filt, lr)
    tst = _port_state(jst)
    tnext, tloss = tf0.frame0_step(
        tst, tcams.view(0), torch.from_numpy(gts[0]), torch.zeros(3),
        torch.from_numpy(np.asarray(filt)), tf0.Frame0Config(), TS,
        tf0.position_lr(1, tf0.Frame0Config(), 1.0), reg_on=reg_on)
    assert abs(float(tloss) - float(jloss)) <= 1e-4 * float(jloss)
    valid = np.asarray(jst.gaussians.valid)
    for name in tref.TRAINABLE:
        g_j = np.asarray(jnext.adam_m[name]) / 0.1
        np.testing.assert_allclose(tnext.adam_m[name].numpy()[valid] / 0.1,
                                   g_j[valid], atol=2e-5, rtol=1e-3,
                                   err_msg=name)
        sure = np.abs(g_j) > 1e-4
        np.testing.assert_allclose(
            getattr(tnext.gaussians, name).numpy()[sure],
            np.asarray(getattr(jnext.gaussians, name))[sure], atol=1e-6,
            err_msg=name)
    for name in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(tnext, name).numpy(),
                                   np.asarray(getattr(jnext, name)),
                                   atol=2e-5, rtol=1e-3, err_msg=name)
    assert tnext.step == int(jnext.step) == 1


def test_color_and_full_mode_steps_agree():
    """Without the regulariser the port renders color only; a full-render
    step (the regulariser on at weight 0) gives the same loss and
    update."""
    jcams, tcams = _cams()
    target, pts, cols = _points()
    gts = _gts(jcams, target)
    g = tf0.create_from_points(pts, cols, 64, device="cpu")
    st = tref.init_refine_state(g, 64)
    filt = tf0.compute_3d_filter(g.xyz, g.valid, tcams)
    args = (st, tcams.view(1), torch.from_numpy(gts[1]), torch.zeros(3),
            filt)
    color, loss_c = tf0.frame0_step(*args, tf0.Frame0Config(), TS, 1e-4,
                                    reg_on=False)
    full, loss_f = tf0.frame0_step(
        *args, tf0.Frame0Config(lambda_depth_normal=0.0), TS, 1e-4,
        reg_on=True)
    assert abs(float(loss_c) - float(loss_f)) <= 1e-7
    for name in tref.TRAINABLE:
        np.testing.assert_allclose(color.adam_m[name].numpy(),
                                   full.adam_m[name].numpy(), atol=1e-9,
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(color.xyz_grad_accum.numpy(),
                               full.xyz_grad_accum.numpy(), rtol=1e-5,
                               atol=1e-9)


def test_frame0_trajectory_matches_jax(tmp_path):
    """Eight steps over two views from the same init; the initial Gaussians
    cross from JAX to the port through a PLY file."""
    jcams, tcams = _cams()
    target, pts, cols = _points()
    gts = _gts(jcams, target)
    jg = jf0.create_from_points(pts, cols, 48)
    jax_save_ply(str(tmp_path / "init.ply"), jg)
    tg = load_gaussian_ply(str(tmp_path / "init.ply"))
    jst = jref.init_refine_state(jg, 64)
    tst = tref.init_refine_state(tg, 64)
    jfilt = jf0.compute_3d_filter(jst.gaussians.xyz, jst.gaussians.valid,
                                  jcams)
    tfilt = tf0.compute_3d_filter(tst.gaussians.xyz, tst.gaussians.valid,
                                  tcams)
    want, got = [], []
    for it in range(1, 9):
        v = it % 2
        jst, jl = _jax_step(False)(
            jst, jcams[v], jnp.asarray(gts[v]), jfilt,
            jf0.position_lr(it, jf0.Frame0Config(), 1.0))
        tst, tl = tf0.frame0_step(
            tst, tcams.view(v), torch.from_numpy(gts[v]), torch.zeros(3),
            tfilt, tf0.Frame0Config(), TS,
            tf0.position_lr(it, tf0.Frame0Config(), 1.0), reg_on=False)
        want.append(float(jl))
        got.append(float(tl))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]


def test_reset_opacity_matches_jax():
    jg = random_gaussians(n=16, seed=2)
    jst = jref.init_refine_state(jg, 20)
    rng = np.random.RandomState(3)
    jst = jst.replace(adam_m={k: jnp.asarray(rng.normal(size=v.shape),
                                             jnp.float32)
                              for k, v in jst.adam_m.items()})
    want = jf0.reset_opacity(jst)
    got = tf0.reset_opacity(_port_state(jst))
    np.testing.assert_array_equal(got.gaussians.opacity.numpy(),
                                  np.asarray(want.gaussians.opacity))
    for k in tref.TRAINABLE:
        np.testing.assert_array_equal(got.adam_m[k].numpy(),
                                      np.asarray(want.adam_m[k]))
    assert float(got.gaussians.get_opacity.max()) <= 0.01 + 1e-6


@pytest.mark.parametrize("size_threshold", [None, 20.0])
def test_frame0_densify_and_prune_matches_jax(size_threshold):
    """Clone (small rows), split (big rows) and the z-cull in one event,
    fed the JAX PRNG's split samples; with a size threshold the world-scale
    prune runs too."""
    rng = np.random.RandomState(9)
    jg = random_gaussians(n=40, seed=8, scale_rng=(-4.0, -1.0))
    z = np.asarray(jg.xyz)[:, 2] + 5.0
    z[:6] = 4.0  # below the z-cull plane
    jg = jg.replace(xyz=jg.xyz.at[:, 2].set(jnp.asarray(z))).pad_to(64)
    accum = rng.uniform(0, 6e-4, 64).astype(np.float32)
    denom = rng.randint(1, 3, 64).astype(np.float32)
    jst = jref.init_refine_state(jg, 64).replace(
        xyz_grad_accum=jnp.asarray(accum), denom=jnp.asarray(denom))
    cfg = jf0.Frame0Config(percent_dense=0.05)
    extent = 2.0
    want = jf0.frame0_densify_and_prune(jst, cfg, extent, size_threshold)
    n = 64
    _, _, k2a, k2b = jax.random.split(jst.rng, 4)
    samples = tuple(torch.tensor(np.asarray(jax.random.normal(k, (n, 3))))
                    for k in (k2a, k2b))
    got = tf0.frame0_densify_and_prune(
        _port_state(jst), tf0.Frame0Config(percent_dense=0.05), extent,
        size_threshold, samples=samples)
    valid_before = np.asarray(jg.valid)
    live = np.asarray(want.gaussians.valid)
    assert (live & ~valid_before).sum() > 0  # rows were added
    assert (~live & valid_before).sum() > 0  # and pruned
    np.testing.assert_array_equal(got.gaussians.valid.numpy(), live)
    for name in tref.TRAINABLE:
        np.testing.assert_allclose(
            getattr(got.gaussians, name).numpy()[live],
            np.asarray(getattr(want.gaussians, name))[live], atol=1e-6,
            rtol=1e-6, err_msg=name)


def test_lightgaussian_importance_and_prune_match_jax():
    jcams, tcams = _cams()
    jg = random_gaussians(n=64, seed=5).pad_to(72)
    tg = to_torch_gaussians(jg)
    filt = jf0.compute_3d_filter(jg.xyz, jg.valid, jcams)
    want = jax.jit(lambda g, f: jf0.lightgaussian_importance(
        g, f, jcams, JS))(jg, filt)
    got = tf0.lightgaussian_importance(tg, torch.from_numpy(np.asarray(filt)),
                                       tcams, TS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for percent in (0.25, 0.45):
        kept_j = jf0.prune_by_importance(jg, want, percent)
        kept_t = tf0.prune_by_importance(tg, got, percent)
        np.testing.assert_array_equal(kept_t.valid.numpy(),
                                      np.asarray(kept_j.valid))
        assert int(kept_t.num_valid) == 64 - tf0.pruned_count(64, percent)
