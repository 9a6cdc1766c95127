"""Port ``rasterize(impl="pallas")``, the windowed route, against the JAX
package's ``rasterize(impl="pallas", pallas_interpret=True)``: every
output, the overflow count and the gradients of all six inputs, with the
±15 clamp on and a loss scaled so that some gradients pass 15; at a
window that truncates tiles and at one that truncates none. The windowed
route against the packed one in the port where nothing truncates; the
clamp per view through ``render_views``; the oracle routes ("tiles",
"reference") against the windowed one where nothing truncates.

Gate: the packed parity tests' (atol 2e-5, rtol 1e-3) on outputs; on
gradients rtol 1e-3 with atol 2e-5 of each gradient's largest magnitude,
since the loss is scaled up. The clamp must bind (some gradients sit at
±15) and ``means2d_offset`` must not be clamped.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.models.renderer import render_views as jax_render_views
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.ops.rasterize import rasterize as jax_rasterize
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.models.renderer import render_views
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from tests.conftest import make_camera, random_gaussians
from tests.torch_port_common import to_torch_gaussians

torch.set_num_threads(2)

HW = 32
BG = np.float32([0.1, 0.2, 0.3])
OUTPUTS = ("color", "alpha", "depth", "mdepth", "mcoord", "normal", "coord")
WEIGHTS = (1.0, 0.05, 0.2, 0.1, 0.1, 0.05, 0.05)
SCALE = 4000.0  # pushes the largest gradients past the clamp
NAMES = ("xyz", "opacity", "scaling", "rotation", "shs", "means2d_offset")


def _scene(n=192, seed=4, dead=16):
    jg = random_gaussians(n=n, seed=seed).pad_to(n + dead)
    tg = to_torch_gaussians(jg)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 4.0
    tcam = Camera.from_w2c(w2c, 0.8, 0.8, height=HW, width=HW, device="cpu")
    return jg, tg, make_camera(height=HW, width=HW), tcam


def _settings(maxpt, mode="full", impl="pallas"):
    return RasterSettings(image_height=HW, image_width=HW, max_pairs=1 << 12,
                          impl=impl, max_per_tile=maxpt, chunk=64,
                          clamp_grads=True, outputs=mode)


def _jax_settings(maxpt, mode="full"):
    return JSettings(image_height=HW, image_width=HW, max_pairs=1 << 12,
                     impl="pallas", pallas_interpret=True, max_per_tile=maxpt,
                     chunk=64, clamp_grads=True, outputs=mode)


def _loss(out, xp):
    return SCALE * sum(wt * xp.mean(xp.abs(out[k]) if k == "color"
                                    else out[k])
                       for k, wt in zip(OUTPUTS, WEIGHTS))


def _jax_run(jg, jcam, settings):
    def f(args):
        xyz, op, sc, ro, shs, m2o = args
        out = jax_rasterize(
            means3d=xyz, opacity=jax.nn.sigmoid(op), scaling=jnp.exp(sc),
            rotation=ro / jnp.linalg.norm(ro, axis=-1, keepdims=True),
            camera=jcam, shs=shs, bg=jnp.asarray(BG), means2d_offset=m2o,
            valid=jg.valid, settings=settings)
        return _loss(out, jnp), out

    n = jg.xyz.shape[0]
    args = tuple(getattr(jg, k) for k in NAMES[:5]) + (jnp.zeros((n, 2)),)
    (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(args)
    return out, grads


def _port_run(tg, tcam, settings):
    n = tg.xyz.shape[0]
    args = [getattr(tg, k).clone().requires_grad_(True) for k in NAMES[:5]]
    args.append(torch.zeros((n, 2), requires_grad=True))
    xyz, op, sc, ro, shs, m2o = args
    out = rasterize(
        means3d=xyz, opacity=torch.sigmoid(op), scaling=torch.exp(sc),
        rotation=ro / torch.linalg.norm(ro, dim=-1, keepdim=True),
        camera=tcam, shs=shs, bg=torch.from_numpy(BG), means2d_offset=m2o,
        valid=tg.valid, settings=settings)
    grads = torch.autograd.grad(_loss(out, torch), args)
    return out, grads


@pytest.mark.parametrize("maxpt", [64, 256])
def test_windowed_rasterize_matches_jax_with_clamp(maxpt):
    jg, tg, jcam, tcam = _scene()
    want_out, want_grads = _jax_run(jg, jcam, _jax_settings(maxpt))
    got_out, got_grads = _port_run(tg, tcam, _settings(maxpt))

    assert int(got_out["overflow_tiles"]) == int(want_out["overflow_tiles"])
    if maxpt == 64:
        assert 0 < int(got_out["overflow_tiles"]) < 1 << 20  # truncated
    else:
        assert int(got_out["overflow_tiles"]) == 0
    for k in OUTPUTS + ("n_contrib",):
        np.testing.assert_allclose(got_out[k].detach().numpy(),
                                   np.asarray(want_out[k]), atol=2e-5,
                                   rtol=1e-3, err_msg=k)
    clamped = 0
    for name, g, w in zip(NAMES, got_grads, want_grads):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=1e-3,
                                   atol=2e-5 * float(np.abs(w).max()),
                                   err_msg=f"grad {name}")
        if name != "means2d_offset":
            assert np.abs(g).max() <= 15.0, name
            clamped += int((np.abs(g) == 15.0).sum())
    assert clamped > 0, "no gradient reached the clamp"
    # the screen-space offset is exempt from the clamp
    assert float(got_grads[5].abs().max()) > 15.0


def test_windowed_color_mode_matches_jax():
    jg, tg, jcam, tcam = _scene(seed=6)
    want_out, want_grads = _jax_run(jg, jcam, _jax_settings(64, "color"))
    got_out, got_grads = _port_run(tg, tcam, _settings(64, "color"))
    assert int(got_out["overflow_tiles"]) == int(want_out["overflow_tiles"])
    for k in OUTPUTS:
        np.testing.assert_allclose(got_out[k].detach().numpy(),
                                   np.asarray(want_out[k]), atol=2e-5,
                                   rtol=1e-3, err_msg=k)
    for name, g, w in zip(NAMES, got_grads, want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=2e-5 * float(np.abs(w).max()),
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("mode", ["color", "full"])
def test_windowed_route_equals_packed_where_nothing_truncates(mode):
    _, tg, _, tcam = _scene(seed=8)
    win_out, win_grads = _port_run(tg, tcam, _settings(512, mode))
    pk_out, pk_grads = _port_run(tg, tcam, _settings(512, mode,
                                                     "pallas_packed"))
    assert int(win_out["overflow_tiles"]) == 0
    for k in ("color", "alpha", "n_contrib") + (
            OUTPUTS if mode == "full" else ()):
        torch.testing.assert_close(win_out[k], pk_out[k], rtol=0, atol=1e-6)
    for name, g, p in zip(NAMES, win_grads, pk_grads):
        torch.testing.assert_close(g, p, rtol=1e-5,
                                   atol=1e-6 * float(p.abs().max()),
                                   msg=f"grad {name}")


def test_clamp_acts_per_view_in_render_views():
    """Two views render through two ``rasterize`` calls: each call's
    gradient is clamped before the sum, as JAX's ``lax.map`` over views."""
    jg, tg, _, _ = _scene(seed=9)
    c2w = np.stack([np.eye(4, dtype=np.float32)] * 2)
    c2w[:, 2, 3] = -4.0
    c2w[1, 0, 3] = 0.3
    from igs_tpu.core.camera import Camera as JCamera

    jcams = jax.tree.map(lambda *x: jnp.stack(x), *[
        JCamera.from_c2w(jnp.asarray(c), (0.8, 0.8), (HW, HW)) for c in c2w])
    tcams = Camera.stack([Camera.from_c2w(c, (0.8, 0.8), (HW, HW),
                                          device="cpu") for c in c2w])
    js = _jax_settings(64)

    def jloss(xyz):
        out = jax_render_views(jg.replace(xyz=xyz), jcams, jnp.asarray(BG),
                               js)
        return SCALE * jnp.mean(out["images_pred"])

    want = np.asarray(jax.jit(jax.grad(jloss))(jg.xyz))
    xyz = tg.xyz.clone().requires_grad_(True)
    from dataclasses import replace

    out = render_views(replace(tg, xyz=xyz), tcams, torch.from_numpy(BG),
                       _settings(64))
    (got,) = torch.autograd.grad(SCALE * out["images_pred"].mean(), xyz)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                               atol=2e-5 * float(np.abs(want).max()))
    assert np.abs(want).max() > 15.0  # the sum of two clamped views


def test_routes_not_ported_raise():
    """The oracle routes, once refused here, render: "tiles" and
    "reference" agree with the windowed route at a window where nothing
    truncates (the JAX package's tiled-parity tolerances, 2e-4 absolute
    and 1e-3 relative); a route the port does not have still raises."""
    _, tg, _, tcam = _scene()
    args = (tg.get_xyz, tg.get_opacity, tg.get_scaling, tg.get_rotation,
            tcam)
    want = rasterize(*args, shs=tg.shs, valid=tg.valid,
                     settings=_settings(256))
    assert int(want["overflow_tiles"]) == 0
    for impl in ("tiles", "reference"):
        got = rasterize(*args, shs=tg.shs, valid=tg.valid,
                        settings=_settings(256, impl=impl))
        assert int(got["overflow_tiles"]) == 0
        for k in OUTPUTS:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=2e-4, rtol=1e-3,
                                       err_msg=f"{impl}/{k}")
    with pytest.raises(ValueError, match="impl="):
        rasterize(*args, shs=tg.shs, valid=tg.valid,
                  settings=_settings(64, impl="cuda"))
