"""Port ``rasterize(impl="tiles")`` against the JAX package's, on the same
numpy-seeded Gaussians and camera (40×56: partial tiles on both axes).

Forward: every map within 1e-5 absolute, the integer maps (n_contrib,
radii, overflow_tiles) equal, at a window of 96 rows and chunks of 32 that
truncate some tiles, in full and color outputs (color projects without the
geometry planes, as in JAX), with sort and compact binning, and at a window
of 80 whose last 80 % 32 columns the renderer never reads (the JAX
package's quirk). Gradients of the six inputs within 1e-4 of each
tensor's largest entry (ROADMAP C18's bound), with the ±15 clamp on (a loss
scaled so that it binds) and off. A stacked camera against per-view calls.
The JAX synthetic writer's renders (``impl="tiles"``, a 512-row window,
chunks of 64).
"""

import json
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.core.camera import Camera as JCamera
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.ops.rasterize import rasterize as jax_rasterize
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from tests.conftest import random_gaussians
from tests.torch_port_common import to_torch_gaussians

torch.set_num_threads(2)

H, W = 40, 56
BG = np.float32([0.1, 0.2, 0.3])
MAPS = ("color", "alpha", "coord", "mcoord", "depth", "mdepth", "normal")
INTS = ("n_contrib", "radii", "overflow_tiles")
WEIGHTS = (1.0, 0.05, 0.05, 0.1, 0.2, 0.1, 0.05)
NAMES = ("xyz", "opacity", "scaling", "rotation", "shs", "means2d_offset")
SCALE = 4000.0  # pushes the largest gradients past the clamp


def _w2c(yaw=0.15, radius=4.0):
    c, s = np.cos(yaw), np.sin(yaw)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    w2c[2, 3] = radius
    return w2c


def _scene(n=500, seed=0):
    jg = random_gaussians(n=n, seed=seed)
    valid = np.ones(n, bool)
    valid[::19] = False
    jg = jg.replace(valid=jnp.asarray(valid))
    return jg, to_torch_gaussians(jg)


def _cams(yaw=0.15):
    return (JCamera.from_w2c(_w2c(yaw), 0.8, 0.7, height=H, width=W),
            Camera.from_w2c(_w2c(yaw), 0.8, 0.7, height=H, width=W,
                            device="cpu"))


def _settings(cls, **kw):
    base = dict(image_height=H, image_width=W, impl="tiles",
                max_pairs=1 << 14, max_per_tile=96, chunk=32)
    return cls(**dict(base, **kw))


def _loss(out, xp):
    return SCALE * sum(wt * xp.mean(xp.abs(out[k]) if k == "color"
                                    else out[k])
                       for k, wt in zip(MAPS, WEIGHTS))


@partial(jax.jit, static_argnames=("settings",))
def _jax_run(args, valid, cam, settings):
    """(outputs, gradients of the six inputs) through JAX rasterize."""
    def f(a):
        xyz, op, sc, ro, shs, m2o = a
        out = jax_rasterize(
            means3d=xyz, opacity=jax.nn.sigmoid(op), scaling=jnp.exp(sc),
            rotation=ro / jnp.linalg.norm(ro, axis=-1, keepdims=True),
            camera=cam, shs=shs, bg=jnp.asarray(BG), means2d_offset=m2o,
            valid=valid, settings=settings)
        return _loss(out, jnp), out

    (_, out), grads = jax.value_and_grad(f, has_aux=True)(args)
    return out, grads


def _jax_args(jg):
    n = jg.xyz.shape[0]
    return tuple(getattr(jg, k) for k in NAMES[:5]) + (
        jnp.zeros((n, 2), jnp.float32),)


def _port_run(tg, tcam, settings, grad=True):
    n = tg.xyz.shape[0]
    leaves = [getattr(tg, k).clone().requires_grad_(grad) for k in NAMES[:5]]
    leaves.append(torch.zeros((n, 2), requires_grad=grad))
    xyz, op, sc, ro, shs, m2o = leaves
    out = rasterize(xyz, torch.sigmoid(op), torch.exp(sc),
                    ro / torch.linalg.norm(ro, dim=-1, keepdim=True), tcam,
                    shs=shs, bg=torch.from_numpy(BG), means2d_offset=m2o,
                    valid=tg.valid, settings=settings)
    if not grad:
        return out, None
    return out, torch.autograd.grad(_loss(out, torch), leaves)


def _check_forward(got, want):
    for k in MAPS:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    for k in INTS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _check_grads(got, want):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("outputs,max_per_tile,binning", [
    ("full", 96, "sort"), ("color", 96, "sort"), ("full", 96, "compact")])
def test_forward_matches_jax(outputs, max_per_tile, binning):
    jg, tg = _scene()
    jcam, tcam = _cams()
    kw = dict(outputs=outputs, max_per_tile=max_per_tile, binning=binning)
    want, _ = _jax_run(_jax_args(jg), jg.valid, jcam,
                       _settings(JSettings, **kw))
    got, _ = _port_run(tg, tcam, _settings(RasterSettings, **kw),
                       grad=False)
    _check_forward(got, want)
    if binning == "sort":
        assert int(want["overflow_tiles"]) > 0  # some tiles truncate
    if outputs == "color":  # the geometry planes are zero
        assert not np.asarray(want["normal"]).any()


@pytest.mark.parametrize("clamp", [True, False])
def test_gradients_match_jax(clamp):
    jg, tg = _scene()
    jcam, tcam = _cams()
    want_out, want = _jax_run(_jax_args(jg), jg.valid, jcam,
                              _settings(JSettings, clamp_grads=clamp))
    got_out, got = _port_run(tg, tcam,
                             _settings(RasterSettings, clamp_grads=clamp))
    _check_forward(got_out, want_out)
    _check_grads(got, want)
    bound = max(float(np.abs(np.asarray(w)).max()) for w in want[:5])
    if clamp:
        assert bound == 15.0  # the clamp binds
    else:
        assert bound > 15.0


def test_table_tail_is_never_read():
    """A window of 80 with chunks of 32 walks two chunks: columns 64-79
    are never read, so the render equals a window of 64's, yet tiles with
    more than 64 pairs exist and only those past 80 count as truncated;
    the port keeps this as JAX does, forward and gradients."""
    jg, tg = _scene()
    jcam, tcam = _cams()
    s80 = dict(max_per_tile=80, chunk=32)
    want_out, want = _jax_run(_jax_args(jg), jg.valid, jcam,
                              _settings(JSettings, **s80))
    got_out, got = _port_run(tg, tcam, _settings(RasterSettings, **s80))
    _check_forward(got_out, want_out)
    _check_grads(got, want)
    at64, _ = _port_run(tg, tcam, _settings(RasterSettings, max_per_tile=64))
    for k in MAPS:
        np.testing.assert_array_equal(got_out[k].detach().numpy(),
                                      at64[k].detach().numpy(), err_msg=k)
    assert int(at64["overflow_tiles"]) > int(got_out["overflow_tiles"])
    with pytest.raises(ValueError, match="chunk"):
        _port_run(tg, tcam, _settings(RasterSettings, max_per_tile=16),
                  grad=False)


def test_stacked_camera_matches_per_view_calls():
    _, tg = _scene()
    tcams = [_cams(yaw)[1] for yaw in (0.15, -0.1, 0.3)]
    s = _settings(RasterSettings)
    stacked, g_stacked = _port_run(tg, Camera.stack(tcams), s)
    views = [_port_run(tg, c, s) for c in tcams]
    for k in MAPS + ("n_contrib", "overflow_tiles"):
        want = np.stack([v[0][k].detach().numpy() for v in views])
        np.testing.assert_allclose(stacked[k].detach().numpy(), want,
                                   atol=1e-5, rtol=0, err_msg=k)
    # the stacked loss averages over the views, so its gradient is the
    # per-view gradients' mean
    for name, g, *per_view in zip(NAMES, g_stacked,
                                  *(v[1] for v in views)):
        want = torch.stack(per_view).mean(0).numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=name)


def test_synthetic_writer_renders_match(tmp_path):
    """The JAX synthetic writer renders through ``impl="tiles"`` with a
    512-row window (igs_tpu/data/synthetic.py:118-124) and drops the pairs
    of denser tiles; the port's tiles route at those settings gives its
    uint8 images and uint16 depth (±1 level, quantisation) on the same
    Gaussians."""
    from PIL import Image

    from igs_tpu.data.synthetic import _scene_gaussians, build_synthetic_scene

    n, hw = 2000, 64
    build_synthetic_scene(str(tmp_path), n_frames=2, n_cams=3,
                          n_gaussians=n, height=hw, width=hw, interval=1)
    scene = tmp_path / "toy_scene"
    s = RasterSettings(image_height=hw, image_width=hw, impl="tiles",
                       max_pairs=1 << 15, max_per_tile=512, chunk=64)
    truncated = 0
    for f in range(2):
        tg = to_torch_gaussians(_scene_gaussians(n, seed=0, t=0.4 * f))
        frame = scene / f"colmap_{f}"
        cams = json.loads((frame / "3dgs_rade" / "cameras.json").read_text())
        for i, cam in enumerate(cams):
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = np.array(cam["rotation"])
            c2w[:3, 3] = np.array(cam["position"])
            fov = 2 * np.arctan(hw / (2 * cam["fx"]))
            out = rasterize(
                tg.get_xyz, tg.get_opacity, tg.get_scaling, tg.get_rotation,
                Camera.from_c2w(c2w, (fov, fov), (hw, hw), device="cpu"),
                shs=tg.shs, valid=tg.valid, settings=s)
            truncated += int(out["overflow_tiles"])
            img = torch.clamp(out["color"], 0, 1).numpy()
            u8 = (img.transpose(1, 2, 0) * 255).astype(np.uint8)
            want = np.asarray(Image.open(frame / "images_512"
                                         / f"{cam['img_name']}.png"))
            diff = np.abs(u8.astype(int) - want.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01
            dmm = np.clip(out["depth"].numpy() * 1000.0, 0, 65535).astype(
                np.uint16)
            want = np.asarray(Image.open(
                frame / "3dgs_rade" / "train" / "ours_6000_compress"
                / "depth_expected_mm" / f"{i:05d}.png")).astype(int)
            diff = np.abs(dmm.astype(int) - want)
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert truncated > 0  # the 512-row window drops pairs, as in JAX



def test_tile_blocks_change_nothing(monkeypatch):
    """Walking the tiles in blocks (here 5 tiles a block, 12 tiles a view,
    so blocks straddle views) bounds memory and changes no tile's
    arithmetic: the forward is equal bit for bit; the gradients sum the
    same per-pair parts in another order (within 1e-6 of each tensor's
    largest entry)."""
    from igs_tpu_torch.ops import render_tiles as rt

    _, tg = _scene()
    cams = Camera.stack([_cams(yaw)[1] for yaw in (0.15, -0.1)])
    s = _settings(RasterSettings)
    whole, g_whole = _port_run(tg, cams, s)
    monkeypatch.setattr(rt, "BLOCK_ELEMS", s.chunk * 256 * 5)
    blocks, g_blocks = _port_run(tg, cams, s)
    for k in MAPS + ("n_contrib",):
        assert torch.equal(blocks[k], whole[k]), k
    for name, a, b in zip(NAMES, g_blocks, g_whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()),
                                   err_msg=name)
