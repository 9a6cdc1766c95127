"""Whole AGM-Net forward, anchors and the weight bridge: port vs JAX.

The JAX side renders with ``impl="pallas_packed"`` in interpret mode.
Network tolerances are float32 reassociation (~1e-4 on features); images
are held at 1e-3 absolute, since deformed means differ by ~1e-6 and a
pixel on a termination threshold may flip.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.models.torch_convert import (
    convert_gmflow_checkpoint, convert_igs_checkpoint, fix_mlp_output_layer)
from igs_tpu.ops import anchors as jax_anchors
from igs_tpu.ops.anchors import select_anchors as jax_select_anchors
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu_torch.models.convert import state_dict_from_flax
from igs_tpu_torch.ops import anchors as port_anchors
from igs_tpu_torch.ops.anchors import AnchorState, select_anchors
from igs_tpu_torch.ops.rasterize import RasterSettings
from tests.torch_port_common import (
    flax_params, numpy_batch, port_model, to_torch_gaussians)

torch.set_num_threads(2)

OUT_HW = (40, 48)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.mark.parametrize("local_ray", [True, False])
def test_state_dict_round_trips_through_torch_convert(local_ray):
    """port state_dict → igs_tpu.models.torch_convert → the flax tree."""
    _, params, _ = flax_params(local_ray=local_ray)
    sd = {k: v.numpy() for k, v in state_dict_from_flax(params).items()}
    gm = convert_gmflow_checkpoint(
        {k[len("backbone."):]: v for k, v in sd.items()
         if k.startswith("backbone.")})
    igs = convert_igs_checkpoint(
        {k: v for k, v in sd.items() if not k.startswith("backbone.")})
    assert gm["unmapped"] == [] and igs["unmapped"] == []
    back = fix_mlp_output_layer(igs["params"])
    back["backbone"] = gm["params"]
    want, got = _flat(params["params"]), _flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("exact_knn,buckets", [
    pytest.param(True, 1, id="1"), pytest.param(True, 64, id="64"),
    pytest.param(False, 1, id="approx-1"),
    pytest.param(False, 64, id="approx-64")])
def test_select_anchors_matches(exact_knn, buckets):
    """Indices equal; weights within 1e-5, except where a point is its own
    anchor: there |q|²−2q·p+|p|² cancels to ~1e-7 and the square root
    turns each side's rounding into ~1e-4 of distance.

    The port always takes the exact top-k. The JAX default,
    ``exact_knn=False``, runs ``jax.lax.approx_max_k``, which on the CPU
    (the backend the port is held against) returns the exact top-k: the
    port reproduces both settings there (ROADMAP C1)."""
    rng = np.random.RandomState(buckets)
    xyz = rng.uniform(-1.5, 1.5, (512, 3)).astype(np.float32)
    valid = np.arange(512) < 400
    bbox = np.float32([[-1, -1, -1], [1, 1, 1]])
    want = jax_select_anchors(jnp.asarray(xyz), jnp.asarray(bbox),
                              valid=jnp.asarray(valid), anchor_size=64, k=4,
                              exact_knn=exact_knn, fps_buckets=buckets)
    got = select_anchors(torch.from_numpy(xyz), torch.from_numpy(bbox),
                         valid=torch.from_numpy(valid), anchor_size=64, k=4,
                         fps_buckets=buckets)
    for name in ("anchor_idx", "neighbor_idx", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    anchors = xyz[np.asarray(want.anchor_idx)]
    d = np.linalg.norm(xyz[:, None] - anchors[np.asarray(want.neighbor_idx)],
                       axis=-1)
    self_match = (d < 1e-6).any(-1, keepdims=True)
    tol = np.where(self_match, 5e-4, 1e-5)
    assert (np.abs(got.weights.numpy() - np.asarray(want.weights)) <= tol).all()


@pytest.mark.parametrize("name,dim", [("interpolate_anchor_features", 8),
                                      ("interpolate_anchor_rotations", 4)])
def test_anchor_interpolation_matches(name, dim):
    """K-anchor blends of features and of per-anchor normalized quats,
    float32 sums in another order: 1e-6."""
    rng = np.random.RandomState(dim)
    feats = rng.normal(size=(16, dim)).astype(np.float32)
    w = rng.uniform(0, 1, (40, 4)).astype(np.float32)
    idx = rng.randint(0, 16, (40, 4)).astype(np.int32)
    want = getattr(jax_anchors, name)(jnp.asarray(feats), jnp.asarray(w),
                                      jnp.asarray(idx))
    got = getattr(port_anchors, name)(torch.from_numpy(feats),
                                      torch.from_numpy(w),
                                      torch.from_numpy(idx).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("local_ray", [True, False])
def test_agm_forward_matches(local_ray):
    b = 2
    jmodel, params, g = flax_params(local_ray=local_ray)
    batch = numpy_batch(b=b, out_hw=OUT_HW)
    js = JSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                   impl="pallas_packed", pallas_interpret=True,
                   outputs="color", max_pairs=1 << 14, clamp_grads=True)
    jds = js._replace(image_height=16, image_width=16, outputs="color_depth",
                      max_pairs=1 << 14)
    jstate = jax_select_anchors(g.xyz, jnp.asarray(batch["bounding_box"][0]),
                                valid=g.valid, anchor_size=32, k=4,
                                exact_knn=True)
    rep = lambda x: None if x is None else jnp.stack([x] * b)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, jb_, st, gs: jmodel.apply(
        p, jb_, st, gs, js, depth_settings=jds, shared_cur=True,
        shared_window_pairs=True))(params, jb, jax.tree.map(rep, jstate),
                                   jax.tree.map(rep, g))

    model = port_model(params, local_ray=local_ray)
    tg = to_torch_gaussians(g)
    state = AnchorState(*(torch.tensor(np.asarray(x)) for x in jstate))
    ts = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                        outputs="color", max_pairs=1 << 14)
    tds = ts._replace(image_height=16, image_width=16, outputs="color_depth")
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()},
                    AnchorState(*(x.expand((b,) + x.shape) for x in state)),
                    tg.map(lambda x: x.expand((b,) + x.shape)), ts,
                    depth_settings=tds, shared_cur=True,
                    shared_window_pairs=True)

    np.testing.assert_allclose(got["motion_feature"].numpy(),
                               np.asarray(want["motion_feature"]), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(got["3dgs"].xyz.numpy(),
                               np.asarray(want["3dgs"].xyz), atol=1e-5)
    np.testing.assert_allclose(got["3dgs"].rotation.numpy(),
                               np.asarray(want["3dgs"].rotation), atol=1e-5)
    assert np.abs(np.asarray(want["3dgs"].xyz) - np.asarray(g.xyz)).max() > 1e-3
    for k in ("images_pred", "depth_pred"):
        w_, g_ = np.asarray(want[k]), got[k].numpy()
        assert g_.shape == w_.shape, k
        np.testing.assert_allclose(g_, w_, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["pair_drift_frac"].numpy(),
                               np.asarray(want["pair_drift_frac"]))


def test_agm_forward_on_the_windowed_route_matches():
    """``shared_window_pairs`` with ``impl="pallas"``: the JAX AGM-Net
    shares candidate 0's pair list on the packed route only, so here each
    candidate renders through its own binning and no drift signal is
    reported; the port must do the same (it used to pass the shared list
    to the windowed route, which refuses it)."""
    b = 2
    jmodel, params, g = flax_params()
    batch = numpy_batch(b=b, out_hw=OUT_HW)
    js = JSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                   impl="pallas", pallas_interpret=True, outputs="color",
                   max_pairs=1 << 14, max_per_tile=256, chunk=64,
                   clamp_grads=True)
    jds = js._replace(image_height=16, image_width=16, outputs="color_depth")
    jstate = jax_select_anchors(g.xyz, jnp.asarray(batch["bounding_box"][0]),
                                valid=g.valid, anchor_size=32, k=4,
                                exact_knn=True)
    rep = lambda x: None if x is None else jnp.stack([x] * b)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, jb_, st, gs: jmodel.apply(
        p, jb_, st, gs, js, depth_settings=jds, shared_cur=True,
        shared_window_pairs=True))(params, jb, jax.tree.map(rep, jstate),
                                   jax.tree.map(rep, g))

    model = port_model(params)
    tg = to_torch_gaussians(g)
    state = AnchorState(*(torch.tensor(np.asarray(x)) for x in jstate))
    ts = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                        impl="pallas", outputs="color", max_pairs=1 << 14,
                        max_per_tile=256, chunk=64, clamp_grads=True)
    tds = ts._replace(image_height=16, image_width=16, outputs="color_depth")
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()},
                    AnchorState(*(x.expand((b,) + x.shape) for x in state)),
                    tg.map(lambda x: x.expand((b,) + x.shape)), ts,
                    depth_settings=tds, shared_cur=True,
                    shared_window_pairs=True)

    assert "pair_drift_frac" not in want and "pair_drift_frac" not in got
    np.testing.assert_allclose(got["3dgs"].xyz.numpy(),
                               np.asarray(want["3dgs"].xyz), atol=1e-5)
    for k in ("images_pred", "depth_pred", "overflow_tiles"):
        w_, g_ = np.asarray(want[k]), got[k].numpy()
        assert g_.shape == w_.shape, k
        np.testing.assert_allclose(g_, w_, atol=1e-3, err_msg=k)
