"""Port key-frame refine against ``igs_tpu/stream/refine.py`` and its
losses against ``igs_tpu/train/losses.py``.

The JAX side renders with ``impl="pallas_packed"`` in interpret mode,
color outputs, as the streaming refine does. Tolerances:
  * losses 1e-6 (both float32, same separable blur; the SSIM map per
    pixel 5e-6);
  * one step's loss, parameter grads and densify statistics at the JAX
    package's gradient gate (atol 2e-5, rtol 1e-3);
  * densify with the JAX PRNG's split samples injected: the same rows
    selected and filled, parameters to 1e-6;
  * ten steps: per-step loss within 1e-3 relative, final PSNR within
    0.05 dB.
With eps 1e-15 Adam's first update is lr·sign(g) for any nonzero g, so a
gradient at its rounding floor can move a parameter a full lr either way
(the Adam sign trap): updated parameters are compared only where |g| is
far above the floor, and trajectories by loss and image.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.core.camera import Camera as JCamera
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.ops.rasterize import build_pairs_packed as jax_build_pairs
from igs_tpu.ops.rasterize import rasterize as jax_rasterize
from igs_tpu.stream import refine as jref
from igs_tpu.train import losses as jloss
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.stream import refine as tref
from igs_tpu_torch.train import losses as tloss
from tests.conftest import random_gaussians
from tests.torch_port_common import to_torch_gaussians

torch.set_num_threads(2)

HW = 64
BG = np.float32([0.1, 0.2, 0.3])
JS = JSettings(image_height=HW, image_width=HW, impl="pallas_packed",
               pallas_interpret=True, outputs="color", max_pairs=1 << 13)
TS = RasterSettings(image_height=HW, image_width=HW, outputs="color",
                    max_pairs=1 << 13)


def _w2c(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    w2c[2, 3] = 4.0
    return w2c


YAWS = (-0.25, 0.0, 0.3)


def _scene(n=200, capacity=240):
    """Gaussians, cameras of three views, and ground truth rendered from a
    perturbed copy of the Gaussians."""
    jg = random_gaussians(n=n, seed=4).pad_to(capacity)
    tg = to_torch_gaussians(jg)
    jcams = [JCamera.from_w2c(_w2c(y), 0.8, 0.8, HW, HW) for y in YAWS]
    tcam = Camera.stack([Camera.from_w2c(_w2c(y), 0.8, 0.8, HW, HW,
                                         device="cpu") for y in YAWS])
    rng = np.random.RandomState(5)
    shift = torch.from_numpy(rng.normal(0, 0.03, (capacity, 3)).astype(
        np.float32))
    gts = np.stack([np.clip(rasterize(
        tg.get_xyz + shift, tg.get_opacity, tg.get_scaling, tg.get_rotation,
        tcam.view(i), shs=tg.shs, bg=torch.from_numpy(BG), valid=tg.valid,
        settings=TS)["color"].numpy(), 0, 1) for i in range(len(YAWS))])
    return jg, tg, jcams, tcam, gts


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX refine_step, jitted once for every test of this file (the
    interpret-mode kernels dominate its compile); densify stays outside."""
    return jax.jit(lambda st, cam, gt, pv: jref.refine_step(
        st, cam, gt, jnp.asarray(BG), jref.RefineConfig(), JS,
        pairs_override=pv))


def _jax_pairs(st, cam):
    g = st.gaussians
    return jax_build_pairs(g.get_xyz, g.get_opacity, g.get_scaling,
                           g.get_rotation, cam, valid=g.valid, settings=JS)


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 1, (2, 3, 32, 40)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    s_t, map_t = tloss.ssim(ta, tb)
    s_j, map_j = jloss.ssim(ja, jb)
    # per pixel, σ² = blur(x²) − μ² cancels: the two convolutions' sums,
    # taken in other orders, leave a few 1e-6 in the map
    np.testing.assert_allclose(map_t.numpy(), np.asarray(map_j), atol=5e-6)
    pairs = [(float(s_t), float(s_j)),
             (float(tloss.rgb_ssim_loss(ta, tb)),
              float(jloss.rgb_ssim_loss(ja, jb))),
             (float(tloss.l1_loss(ta, tb)), float(jloss.l1_loss(ja, jb))),
             (float(tloss.l2_loss(ta, tb)), float(jloss.l2_loss(ja, jb))),
             (float(tloss.psnr(ta, tb)) / 100, float(jloss.psnr(ja, jb)) / 100)]
    np.testing.assert_allclose(
        tloss.ssim(ta, tb, size_average=False).numpy(),
        np.asarray(jloss.ssim(ja, jb, size_average=False)), atol=1e-6)
    q1 = rng.normal(size=(50, 4)).astype(np.float32)
    q2 = rng.normal(size=(50, 4)).astype(np.float32)
    pairs.append((float(tloss.quaternion_loss(torch.from_numpy(q1),
                                              torch.from_numpy(q2))),
                  float(jloss.quaternion_loss(jnp.asarray(q1),
                                              jnp.asarray(q2)))))
    for got, want in pairs:
        assert abs(got - want) <= 1e-6, (got, want)


def test_ssim_loss_gradient_matches_jax():
    """The refine differentiates 1 − SSIM through the blur's own backward
    (TF32 off on the card); held to JAX's autodiff of its ssim."""
    rng = np.random.RandomState(1)
    a = rng.uniform(0, 1, (3, 32, 40)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta = torch.from_numpy(a).requires_grad_(True)
    (got,) = torch.autograd.grad(
        tloss.rgb_ssim_loss(ta, torch.from_numpy(b)), [ta])
    want = np.asarray(jax.grad(lambda x: jloss.rgb_ssim_loss(
        x, jnp.asarray(b)))(jnp.asarray(a)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale)


def test_refine_step_matches_jax():
    """One step from zero moments: the JAX grads are its first moments
    over (1 − β1), the screen-offset grad norms its densify accumulator."""
    jg, tg, jcams, tcam, gts = _scene()
    cfg = tref.RefineConfig()
    jstate = jref.init_refine_state(jg, capacity=jg.xyz.shape[0])
    jnext, jm = _jax_step()(jstate, jcams[1], jnp.asarray(gts[1]),
                            _jax_pairs(jstate, jcams[1]))

    tstate = tref.init_refine_state(tg, capacity=tg.num_capacity)
    loss_t, grads_t, m2o_t, radii_t, _, _ = tref.loss_and_grads(
        tg, tcam.view(1), torch.from_numpy(gts[1]), torch.from_numpy(BG),
        cfg, TS)
    tnext, tm = tref.refine_step(tstate, tcam.view(1),
                                 torch.from_numpy(gts[1]),
                                 torch.from_numpy(BG), cfg, TS)

    assert abs(float(loss_t) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    assert float(tm["loss"]) == float(loss_t)
    valid = np.asarray(jg.valid)
    for name in tref.TRAINABLE:
        g_t = grads_t[name].numpy()
        assert np.isfinite(g_t).all()
        g_j = np.asarray(jnext.adam_m[name]) / (1 - cfg.beta1)
        np.testing.assert_allclose(g_t[valid], g_j[valid], atol=2e-5,
                                   rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(tnext.adam_m[name].numpy(),
                                   np.asarray(jnext.adam_m[name]),
                                   atol=2e-6, rtol=1e-3, err_msg=name)
        # Adam's first step is lr·sign(g): compare where the sign is sure
        sure = np.abs(g_j) > 1e-4
        np.testing.assert_allclose(
            getattr(tnext.gaussians, name).numpy()[sure],
            np.asarray(getattr(jnext.gaussians, name))[sure], atol=1e-6)
    vis = (radii_t.numpy() > 0) & valid
    np.testing.assert_allclose(
        np.where(vis, np.linalg.norm(m2o_t.numpy(), axis=-1), 0.0),
        np.asarray(jnext.xyz_grad_accum), atol=2e-5, rtol=1e-3)
    for name in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(tnext, name).numpy(),
                                   np.asarray(getattr(jnext, name)),
                                   atol=2e-5, rtol=1e-3, err_msg=name)
    assert tnext.step == int(jnext.step) == 1
    assert float(tnext.xyz_grad_accum.sum()) > 0


@pytest.mark.parametrize("percent_dense", [0.0, 0.1])
def test_densify_and_prune_matches_jax_with_injected_samples(percent_dense):
    """200 live rows in 240 slots: more rows are selected than slots are
    free, so the max-points bound drops some; percent_dense 0.1 makes the
    smaller Gaussians clones and the rest splits."""
    jg, tg, _, _, _ = _scene()
    n = jg.xyz.shape[0]
    rng = np.random.RandomState(11)
    accum = rng.uniform(0, 4e-4, n).astype(np.float32)
    denom = rng.randint(0, 3, n).astype(np.float32)
    moments = {k: rng.normal(size=np.asarray(getattr(jg, k)).shape).astype(
        np.float32) for k in tref.TRAINABLE}
    opacity = np.asarray(jg.opacity).copy()
    opacity[::13] = -8.0  # some rows fall under min_opacity
    jg = jg.replace(opacity=jnp.asarray(opacity))
    tg.opacity = torch.from_numpy(opacity)
    cfg = tref.RefineConfig(percent_dense=percent_dense,
                            densify_grad_threshold=2e-4)
    jcfg = jref.RefineConfig(percent_dense=percent_dense,
                             densify_grad_threshold=2e-4)

    jstate = jref.init_refine_state(jg, capacity=n).replace(
        xyz_grad_accum=jnp.asarray(accum), denom=jnp.asarray(denom),
        adam_m={k: jnp.asarray(v) for k, v in moments.items()},
        adam_v={k: jnp.asarray(v) ** 2 for k, v in moments.items()})
    want = jref.densify_and_prune(jstate, jcfg, jnp.float32(1.0))
    _, _, k2a, k2b = jax.random.split(jstate.rng, 4)
    samples = tuple(torch.tensor(np.asarray(jax.random.normal(k, (n, 3))))
                    for k in (k2a, k2b))

    tstate = tref.init_refine_state(tg, capacity=n)
    tstate.xyz_grad_accum = torch.from_numpy(accum)
    tstate.denom = torch.from_numpy(denom)
    tstate.adam_m = {k: torch.from_numpy(v) for k, v in moments.items()}
    tstate.adam_v = {k: torch.from_numpy(v) ** 2 for k, v in moments.items()}
    got = tref.densify_and_prune(tstate, cfg, 1.0, samples=samples)

    valid_before = np.asarray(jg.valid)
    np.testing.assert_array_equal(got.gaussians.valid.numpy(),
                                  np.asarray(want.gaussians.valid))
    filled = np.asarray(want.gaussians.valid) & ~valid_before
    assert filled.sum() > 0
    np.testing.assert_array_equal(got.init_valid.numpy(),
                                  np.asarray(want.init_valid))
    for name in tref.TRAINABLE:
        np.testing.assert_allclose(
            getattr(got.gaussians, name).numpy(),
            np.asarray(getattr(want.gaussians, name)), atol=1e-6, rtol=1e-6,
            err_msg=name)
        for mom in ("adam_m", "adam_v"):
            np.testing.assert_array_equal(
                getattr(got, mom)[name].numpy(),
                np.asarray(getattr(want, mom)[name]), err_msg=f"{mom} {name}")
    assert not got.denom.any() and not got.xyz_grad_accum.any()


def _psnr(img, gt):
    return float(-10 * np.log10(np.mean((np.clip(img, 0, 1) - gt) ** 2)))


@pytest.mark.parametrize("rebin_every", [1, 3])
def test_refine_run_matches_jax(rebin_every):
    iters = 10
    jg, tg, jcams, tcam, gts = _scene()
    rng = np.random.RandomState(0)
    order = (list(rng.permutation(3)) * 4)[:iters]
    cfg = tref.RefineConfig(use_densify=False, rebin_every=rebin_every)
    bg = jnp.asarray(BG)

    # JAX: refine_step in a loop for the per-step losses, with the pair
    # cache schedule of its refine_run (rebin_every 1: fresh every step)
    jstate = jref.init_refine_state(jg, capacity=jg.xyz.shape[0])
    cache = {v: (_jax_pairs(jstate, jcams[v]), 0) for v in range(3)}
    want_losses = []
    for it, v in enumerate(order):
        if it - cache[v][1] >= rebin_every:
            cache[v] = (_jax_pairs(jstate, jcams[v]), it)
        jstate, m = _jax_step()(jstate, jcams[v], jnp.asarray(gts[v]),
                                cache[v][0])
        want_losses.append(float(m["loss"]))

    tstate = tref.init_refine_state(tg, capacity=tg.num_capacity)
    got_losses = []
    tstate = tref.refine_run(
        tstate, tcam, torch.from_numpy(gts), order, torch.from_numpy(BG),
        cfg, TS, 1.0, iters,
        on_step=lambda it, st, m: got_losses.append(float(m["loss"])))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-3)
    assert got_losses[-1] < got_losses[0]

    for v in range(3):
        jgs, tgs = jstate.gaussians, tstate.gaussians
        want = jax_rasterize(
            means3d=jgs.get_xyz, opacity=jgs.get_opacity,
            scaling=jgs.get_scaling, rotation=jgs.get_rotation,
            camera=jcams[v], shs=jgs.shs, bg=bg, valid=jgs.valid,
            settings=JS)["color"]
        got = rasterize(tgs.get_xyz, tgs.get_opacity, tgs.get_scaling,
                        tgs.get_rotation, tcam.view(v), shs=tgs.shs,
                        bg=torch.from_numpy(BG), valid=tgs.valid,
                        settings=TS)["color"]
        assert abs(_psnr(got.numpy(), gts[v])
                   - _psnr(np.asarray(want), gts[v])) < 0.05


def test_refine_run_with_densify_matches_jax(monkeypatch):
    """Nine steps with a densify after steps 5 and 9 (interval 4): the JAX
    loop draws its split samples from its PRNG, and the port's densify is
    fed the same draws. More rows pass the threshold than slots are free
    at the second densify, so the capacity bound is crossed too."""
    iters = 9
    jg, tg, jcams, tcam, gts = _scene(capacity=320)
    rng = np.random.RandomState(1)
    order = (list(rng.permutation(3)) * 4)[:iters]
    cfg = tref.RefineConfig(densification_interval=4,
                            densify_grad_threshold=3e-3)
    jcfg = jref.RefineConfig(densification_interval=4,
                             densify_grad_threshold=3e-3)
    bg = jnp.asarray(BG)

    jstate = jref.init_refine_state(jg, capacity=jg.xyz.shape[0])
    n = jg.xyz.shape[0]
    want_losses, samples, live = [], [], []
    for it, v in enumerate(order):
        jstate, m = _jax_step()(jstate, jcams[v], jnp.asarray(gts[v]),
                                _jax_pairs(jstate, jcams[v]))
        want_losses.append(float(m["loss"]))
        if tref._densify_now(cfg, it):
            _, _, k2a, k2b = jax.random.split(jstate.rng, 4)
            samples.append(tuple(
                torch.tensor(np.asarray(jax.random.normal(k, (n, 3))))
                for k in (k2a, k2b)))
            live.append(int(jstate.gaussians.valid.sum()))
            jstate = jref.densify_and_prune(jstate, jcfg, jnp.float32(1.0))
    # the first densify fits in the free slots, the second reaches the bound
    assert len(samples) == 2 and live[0] < live[1] < n
    assert int(jstate.gaussians.valid.sum()) == n

    fed = iter(samples)
    densify = tref.densify_and_prune
    monkeypatch.setattr(tref, "densify_and_prune",
                        lambda st, c, extent: densify(st, c, extent,
                                                      next(fed)))
    tstate = tref.init_refine_state(tg, capacity=tg.num_capacity)
    got_losses = []
    tstate = tref.refine_run(
        tstate, tcam, torch.from_numpy(gts), order, torch.from_numpy(BG),
        cfg, TS, 1.0, iters,
        on_step=lambda it, st, m: got_losses.append(float(m["loss"])))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-3)
    np.testing.assert_array_equal(tstate.gaussians.valid.numpy(),
                                  np.asarray(jstate.gaussians.valid))
    for v in range(3):
        jgs, tgs = jstate.gaussians, tstate.gaussians
        want = jax_rasterize(
            means3d=jgs.get_xyz, opacity=jgs.get_opacity,
            scaling=jgs.get_scaling, rotation=jgs.get_rotation,
            camera=jcams[v], shs=jgs.shs, bg=bg, valid=jgs.valid,
            settings=JS)["color"]
        got = rasterize(tgs.get_xyz, tgs.get_opacity, tgs.get_scaling,
                        tgs.get_rotation, tcam.view(v), shs=tgs.shs,
                        bg=torch.from_numpy(BG), valid=tgs.valid,
                        settings=TS)["color"]
        assert abs(_psnr(got.numpy(), gts[v])
                   - _psnr(np.asarray(want), gts[v])) < 0.05
