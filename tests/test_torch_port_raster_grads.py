"""Port rasterize gradients against the JAX package's
``rasterize(impl="pallas_packed")`` in interpret mode: every output and
all five parameters in full mode, and color mode (the refine's, with the
segmented-scan backward) with the screen-space offset. The gate is the JAX
package's own (``tests/test_pallas_blend.py``: atol 2e-5, rtol 1e-3);
the padded dead rows' grads must be finite.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.ops.rasterize import rasterize as jax_rasterize
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from tests.conftest import make_camera, random_gaussians
from tests.torch_port_common import to_torch_gaussians

torch.set_num_threads(2)

XLA = JSettings(image_height=32, image_width=32, max_pairs=1 << 12)
BG = np.float32([0.1, 0.2, 0.3])


def _scene(n, seed, dead=16):
    jg = random_gaussians(n=n, seed=seed).pad_to(n + dead)
    tg = to_torch_gaussians(jg)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 4.0
    tcam = Camera.from_w2c(w2c, 0.8, 0.8, height=32, width=32, device="cpu")
    return jg, tg, make_camera(height=32, width=32), tcam


def _check_grads(got, want, names):
    for name, g_, w_ in zip(names, got, want):
        g_ = g_.numpy()
        assert np.isfinite(g_).all(), name
        np.testing.assert_allclose(g_, np.asarray(w_), atol=2e-5, rtol=1e-3,
                                   err_msg=f"grad {name}")


def test_rasterize_full_gradients_match_jax():
    """The loss of test_pallas_blend.py::test_packed_full_gradient_parity,
    every output and all five parameters."""
    jg, tg, jcam, tcam = _scene(96, seed=5)

    def jloss(args):
        xyz, op, sc, ro, shs = args
        out = jax_rasterize(
            means3d=xyz, opacity=jax.nn.sigmoid(op), scaling=jnp.exp(sc),
            rotation=ro / jnp.linalg.norm(ro, axis=-1, keepdims=True),
            camera=jcam, shs=shs, bg=jnp.asarray(BG), valid=jg.valid,
            settings=XLA._replace(impl="pallas_packed",
                                  pallas_interpret=True))
        return (jnp.mean(jnp.abs(out["color"])) + 0.2 * jnp.mean(out["depth"])
                + 0.1 * jnp.mean(out["mdepth"]) + 0.1 * jnp.mean(out["mcoord"])
                + 0.05 * jnp.mean(out["alpha"]) + 0.05 * jnp.mean(out["normal"])
                + 0.05 * jnp.mean(out["coord"]))

    names = ("xyz", "opacity", "scaling", "rotation", "shs")
    want = jax.jit(jax.grad(jloss))(tuple(getattr(jg, k) for k in names))

    args = [getattr(tg, k).clone().requires_grad_(True) for k in names]
    xyz, op, sc, ro, shs = args
    out = rasterize(
        means3d=xyz, opacity=torch.sigmoid(op), scaling=torch.exp(sc),
        rotation=ro / torch.linalg.norm(ro, dim=-1, keepdim=True),
        camera=tcam, shs=shs, bg=torch.from_numpy(BG), valid=tg.valid,
        settings=RasterSettings(image_height=32, image_width=32,
                                max_pairs=1 << 12))
    loss = (out["color"].abs().mean() + 0.2 * out["depth"].mean()
            + 0.1 * out["mdepth"].mean() + 0.1 * out["mcoord"].mean()
            + 0.05 * out["alpha"].mean() + 0.05 * out["normal"].mean()
            + 0.05 * out["coord"].mean())
    _check_grads(torch.autograd.grad(loss, args), want, names)


def test_rasterize_color_gradients_and_screen_offset_match_jax():
    """Color mode (the refine's) with the segmented-scan backward; the
    screen-space offset's gradient is the densify statistic."""
    jg, tg, jcam, tcam = _scene(128, seed=1)
    n = jg.xyz.shape[0]
    rng = np.random.RandomState(3)
    target = rng.uniform(0, 1, (3, 32, 32)).astype(np.float32)

    def jloss(xyz, m2o):
        out = jax_rasterize(
            means3d=xyz, opacity=jg.get_opacity, scaling=jg.get_scaling,
            rotation=jg.get_rotation, camera=jcam, shs=jg.shs,
            bg=jnp.asarray(BG), means2d_offset=m2o, valid=jg.valid,
            settings=XLA._replace(impl="pallas_packed", pallas_interpret=True,
                                  outputs="color"))
        return jnp.mean(jnp.abs(out["color"] - target))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jg.xyz, jnp.zeros((n, 2)))
    xyz = tg.xyz.clone().requires_grad_(True)
    m2o = torch.zeros((n, 2), requires_grad=True)
    out = rasterize(
        means3d=xyz, opacity=tg.get_opacity, scaling=tg.get_scaling,
        rotation=tg.get_rotation, camera=tcam, shs=tg.shs,
        bg=torch.from_numpy(BG), means2d_offset=m2o, valid=tg.valid,
        settings=RasterSettings(image_height=32, image_width=32,
                                max_pairs=1 << 12, outputs="color"))
    loss = (out["color"] - torch.from_numpy(target)).abs().mean()
    got = torch.autograd.grad(loss, (xyz, m2o))
    _check_grads(got, want, ("xyz", "means2d_offset"))
    assert float(got[1].abs().sum()) > 0
    assert not got[1][~tg.valid].any()  # dead rows take no gradient
