"""The flow render (``models/renderer.render_flow``) and AGM-Net's
``render_flow`` outputs against the JAX package's, each package on its
own route (the packed one and the windowed one; the JAX kernels in
interpret mode), on the same Gaussians, residuals and weights.

Tolerances, relative to the largest |flow| of the JAX render: 1e-5 for
``render_flow`` on the same residuals (the camera-frame product and the
blend reassociate; measured ≤ 7.7e-6), and 1e-4 through AGM-Net, whose
residuals come out of the two networks apart in their last bits
(measured ≤ 4.1e-6). The mask (an alpha in [0, 1]) to 1e-5 absolute in
both (measured ≤ 2.1e-6).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.core.camera import Camera as JCamera
from igs_tpu.models.agm import AGMNet as JAGMNet
from igs_tpu.models.renderer import render_flow as jax_render_flow
from igs_tpu.ops.anchors import select_anchors as jax_select_anchors
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu_torch.builders import build_model
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.models.convert import load_flax_params
from igs_tpu_torch.models.renderer import render_flow
from igs_tpu_torch.ops.anchors import AnchorState
from igs_tpu_torch.ops.rasterize import RasterSettings
from tests.conftest import random_gaussians
from tests.torch_port_common import (
    TINY, flax_params, numpy_batch, to_torch_gaussians)

torch.set_num_threads(2)

ROUTES = ("pallas_packed", "pallas")


def _settings(impl, h, w, max_pairs=1 << 14):
    js = JSettings(image_height=h, image_width=w, impl=impl,
                   pallas_interpret=True, max_pairs=max_pairs,
                   max_per_tile=256, chunk=64, outputs="color",
                   clamp_grads=True)
    ts = RasterSettings(image_height=h, image_width=w, impl=impl,
                        max_pairs=max_pairs, max_per_tile=256, chunk=64,
                        outputs="color", clamp_grads=True)
    return js, ts


def _w2c(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    w2c[2, 3] = 4.0
    return w2c


def _compare(got, want, tol):
    wf = np.asarray(want["flow_pred"])
    scale = float(np.abs(wf).max())
    assert scale > 0
    gf = got["flow_pred"].detach().numpy()
    assert gf.shape == wf.shape
    np.testing.assert_allclose(gf, wf, rtol=0, atol=tol * scale)
    wm = np.asarray(want["flow_mask"])
    gm = got["flow_mask"].detach().numpy()
    assert gm.shape == wm.shape
    np.testing.assert_allclose(gm, wm, rtol=0, atol=1e-5)
    return scale


@pytest.mark.parametrize("impl", ROUTES)
def test_single_gaussian_flow(impl):
    """tests/test_models.py's case: one Gaussian at world z = 2 seen from
    view z = 4; the flow at its centre is (fx·dx, fy·dy) / z_world."""
    g = random_gaussians(n=1, seed=0)
    g = g.replace(xyz=jnp.array([[0.0, 0.0, 2.0]]),
                  opacity=jnp.full((1, 1), 12.0),
                  scaling=jnp.full((1, 3), -1.0),
                  rotation=jnp.array([[1.0, 0, 0, 0]]))
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.0
    jcam = JCamera.from_w2c(w2c, 0.8, 0.8, height=32, width=32)
    tcam = Camera.from_w2c(w2c, 0.8, 0.8, height=32, width=32, device="cpu")
    dxyz = np.float32([[0.05, -0.02, 0.0]])
    js, ts = _settings(impl, 32, 32)
    want = jax_render_flow(g, g.deform(res_xyz=jnp.asarray(dxyz),
                                       mask=jnp.ones(1, bool)),
                           jcam, jnp.zeros(3), js)
    tg = to_torch_gaussians(g)
    got = render_flow(tg, tg.deform(res_xyz=torch.tensor(dxyz),
                                    mask=torch.ones(1, dtype=torch.bool)),
                      tcam, torch.zeros(3), ts)
    _compare(got, want, 1e-5)
    fx = float(tcam.focal_x)
    np.testing.assert_allclose(got["flow_pred"][:, 16, 16].numpy(),
                               [fx * 0.05 / 2.0, fx * -0.02 / 2.0], rtol=0.05)


@pytest.mark.parametrize("impl", ROUTES)
@pytest.mark.parametrize("yaw", [0.0, 0.4])
def test_render_flow_matches_jax(impl, yaw):
    """Random Gaussians with random residuals, half of them masked out of
    the dynamic region (a masked Gaussian is not rendered)."""
    rng = np.random.RandomState(7)
    n = 300
    jg = random_gaussians(n=n, seed=3)
    valid = np.ones(n, bool)
    valid[::13] = False
    jg = jg.replace(valid=jnp.asarray(valid))
    res = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.5
    h, w = 40, 56
    jcam = JCamera.from_w2c(_w2c(yaw), 0.8, 0.7, height=h, width=w)
    tcam = Camera.from_w2c(_w2c(yaw), 0.8, 0.7, height=h, width=w,
                           device="cpu")
    js, ts = _settings(impl, h, w)
    want = jax_render_flow(
        jg, jg.deform(res_xyz=jnp.asarray(res), mask=jnp.asarray(mask)),
        jcam, jnp.zeros(3), js)
    tg = to_torch_gaussians(jg)
    got = render_flow(tg, tg.deform(res_xyz=torch.tensor(res),
                                    mask=torch.tensor(mask)),
                      tcam, torch.zeros(3), ts)
    _compare(got, want, 1e-5)
    # the third color channel is zero, so the flow has two; and the mask
    # is the alpha of the masked Gaussians alone
    assert got["flow_pred"].shape == (2, h, w)
    none = render_flow(tg, tg.deform(res_xyz=torch.tensor(res),
                                     mask=torch.zeros(n, dtype=torch.bool)),
                       tcam, torch.zeros(3), ts)
    assert float(none["flow_mask"].abs().max()) == 0.0


@pytest.fixture(scope="module")
def agm_inputs():
    jmodel, params, g = flax_params()
    return params, g


@pytest.mark.parametrize("impl", ROUTES)
def test_agm_render_flow_matches_jax(agm_inputs, impl):
    """tests/test_agm.py's case: ``AGMNet(render_flow=True)`` at a flow
    size other than the views' (16×48 against 32²): flow_pred (B, V, 2,
    fh, fw) and flow_mask (B, V, fh, fw) against JAX's, the views' images
    unchanged by the flow render."""
    params, g = agm_inputs
    batch = numpy_batch(b=2, v=2, hw=32, out_hw=(32, 32), seed=1)
    state = jax_select_anchors(
        g.xyz, jnp.asarray(batch["bounding_box"][0]), valid=g.valid,
        anchor_size=32, k=4, exact_knn=True)
    js, ts = _settings(impl, 32, 32, max_pairs=1 << 13)
    rep = lambda x: None if x is None else jnp.stack([x] * 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JAGMNet(render_flow=True, flow_height=16, flow_width=48, **TINY)
    want = jax.jit(lambda p: jmodel.apply(
        p, jb, jax.tree.map(rep, state), jax.tree.map(rep, g), js))(params)

    model = AGMNet(render_flow=True, flow_height=16, flow_width=48, **TINY)
    load_flax_params(model, jax.tree.map(np.asarray, params))
    model.eval()
    tstate = AnchorState(*(torch.tensor(np.asarray(x)).expand(
        (2,) + x.shape) for x in state))
    tgs = to_torch_gaussians(g).map(lambda x: x.expand((2,) + x.shape))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = model(tb, tstate, tgs, ts)
        plain = AGMNet(**TINY)
        load_flax_params(plain, jax.tree.map(np.asarray, params))
        ref = plain.eval()(tb, tstate, tgs, ts)
    assert got["flow_pred"].shape == (2, 3, 2, 16, 48)
    assert got["flow_mask"].shape == (2, 3, 16, 48)
    _compare(got, want, 1e-4)
    assert torch.equal(got["images_pred"], ref["images_pred"])
    assert "flow_pred" not in ref


def test_builder_reads_the_flow_keys():
    system = {"up_sample": True,
              "backbone": {"feature_channels": 32,
                           "transformer": {"num_layers": 1}},
              "triplane_encoder": {"unet": {"num_attention_heads": 2,
                                            "attention_head_dim": 16,
                                            "num_layers": 1}},
              "renderer": {"render_flow": True, "flow_height": 24,
                           "flow_width": 40}}
    model = build_model(system, device="cpu")
    assert (model.render_flow, model.flow_height, model.flow_width) == (
        True, 24, 40)
    model = build_model(dict(system, renderer={}), device="cpu")
    assert (model.render_flow, model.flow_height, model.flow_width) == (
        False, 1024, 1352)
