"""Port ``rasterize(impl="reference")``, the O(N·P) oracle, against the JAX
package's on the same numpy-seeded Gaussians (40×56, partial tiles):
every map within 1e-5, the integer maps equal, gradients of the six inputs
within 1e-4 of each tensor's largest entry, clamp on and off, and a
stacked camera against per-view calls. Then the port's own cross-checks:
tiles against reference at the JAX package's tolerances
(tests/test_rasterize.py:187,279: maps 2e-4 absolute + 1e-3 relative,
gradients 5e-4 + 5e-3), and the packed route (its plain versions here)
against the reference on the same scene.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.ops.rasterize import rasterize as jax_rasterize
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.ops.rasterize import RasterSettings
from tests.test_torch_port_render_tiles import (
    BG, MAPS, NAMES, _cams, _check_forward, _check_grads, _jax_args, _loss,
    _port_run, _scene)

torch.set_num_threads(2)

H, W = 40, 56


def _settings(cls, **kw):
    base = dict(image_height=H, image_width=W, impl="reference",
                max_pairs=1 << 14)
    return cls(**dict(base, **kw))


@partial(jax.jit, static_argnames=("settings",))
def _jax_run(args, valid, cam, settings):
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


@pytest.mark.parametrize("clamp", [True, False])
def test_reference_matches_jax(clamp):
    jg, tg = _scene()
    jcam, tcam = _cams()
    want_out, want = _jax_run(_jax_args(jg), jg.valid, jcam,
                              _settings(JSettings, clamp_grads=clamp))
    got_out, got = _port_run(tg, tcam,
                             _settings(RasterSettings, clamp_grads=clamp))
    _check_forward(got_out, want_out)
    _check_grads(got, want)
    assert int(got_out["overflow_tiles"]) == 0


def test_reference_stacked_camera_matches_per_view_calls():
    _, tg = _scene(n=200)
    tcams = [_cams(yaw)[1] for yaw in (0.15, -0.2)]
    s = _settings(RasterSettings)
    stacked, g_stacked = _port_run(tg, Camera.stack(tcams), s)
    views = [_port_run(tg, c, s) for c in tcams]
    for k in MAPS + ("n_contrib",):
        want = np.stack([v[0][k].detach().numpy() for v in views])
        np.testing.assert_allclose(stacked[k].detach().numpy(), want,
                                   atol=1e-5, rtol=0, err_msg=k)
    for name, g, *per_view in zip(NAMES, g_stacked, *(v[1] for v in views)):
        want = torch.stack(per_view).mean(0).numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["tiles", "pallas_packed"])
def test_routes_match_reference(impl):
    """Nothing truncates (a window of 512 rows), so each route takes the
    reference's pairs in the reference's order."""
    _, tg = _scene()
    _, tcam = _cams()
    ref_out, ref = _port_run(tg, tcam, _settings(RasterSettings))
    got_out, got = _port_run(tg, tcam, _settings(
        RasterSettings, impl=impl, max_per_tile=512, chunk=64))
    assert int(got_out["overflow_tiles"]) == 0
    for k in MAPS:
        np.testing.assert_allclose(got_out[k].detach().numpy(),
                                   ref_out[k].detach().numpy(), atol=2e-4,
                                   rtol=1e-3, err_msg=k)
    # n_contrib counts positions in a tile's list on the tile routes and in
    # the whole depth order on the reference: compare where it is nonzero
    flips = ((got_out["n_contrib"] > 0) != (ref_out["n_contrib"] > 0))
    assert float(flips.float().mean()) <= 1e-3
    for name, g, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=5e-4,
                                   rtol=5e-3, err_msg=name)
