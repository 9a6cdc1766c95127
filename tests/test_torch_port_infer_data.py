"""The port's streaming dataset (``data/infer_data.py``) against the JAX
package's, on one small scene written by the JAX synthetic writer.

Both read the same files: images and depths must be equal (the same PNG
bytes decoded by two codecs), rays within 1e-6, cameras and the other
arrays equal, the refine data and the collated Gaussians equal, the path
table equal for every scene type, and ``spiral_path`` within 1e-6.
``scene_type: enerf`` reads JPEGs (``images_2``, ``images_512``): on an
ENeRF-layout copy of the scene written by PIL, the items and the refine
data must be bit-equal to JAX's (the port's decoder gives PIL's pixels).
"""

import numpy as np
import pytest

from igs_tpu.data.infer_data import N3dInferDataset as JDataset
from igs_tpu.data.infer_data import spiral_path as jax_spiral_path
from igs_tpu.data.synthetic import build_synthetic_scene
from igs_tpu_torch.builders import build_dataset
from igs_tpu_torch.data.infer_data import N3dInferDataset, spiral_path
from tests.torch_port_common import enerf_copy


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("infer_scene"))
    return build_synthetic_scene(root, n_frames=4, n_cams=14, n_gaussians=96,
                                 height=32, width=32, interval=2,
                                 out_height=24, out_width=40)


def _cfg(scene, **kw):
    cfg = {"data_path": scene["pairs"], "root_dir": scene["root"],
           "gs_mode": "3dgs_rade", "iter": "6000_compress",
           "input_height": 32, "input_width": 32, "output_height": 24,
           "output_width": 40, "scene_type": "n3d", "depth_id_offset": 0,
           "up_sample": True, "background_color": [0.0, 0.0, 0.0],
           "start_gs_path": scene["start_gs_path"]}
    cfg.update(kw)
    return cfg


def _same_item(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape and g.dtype == w.dtype, k
            if k in ("rays", "local_rays"):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert type(g) is type(w) and g == w, k


@pytest.mark.parametrize("mode", ["stream", "training", "gs_per_item"])
def test_items_match_jax(scene, mode):
    kw = {"load_gs_per_item": True} if mode == "gs_per_item" else {}
    training = mode == "training"
    want = JDataset(_cfg(scene, **kw), training=training)
    got = N3dInferDataset(_cfg(scene, **kw), training=training)
    assert len(got) == len(want) == 3
    for i in range(len(want)):
        w, g = want[i], got[i]
        _same_item(g, w)
        # depth at frame 0 only when streaming
        assert ("depth" in g) == (mode != "stream" or
                                  want.items[i]["cur_frame"] == "colmap_0")
    assert got[0]["images_output"].shape == (5, 3, 24, 40)
    assert got[0]["cur_images_input"].shape == (4, 3, 32, 32)
    assert got[0]["local_rays"].shape == (8, 8, 3)


def test_collate_and_refine_data_match_jax(scene):
    want = JDataset(_cfg(scene))
    got = build_dataset({"data_cls": "igs.data.infer_data.N3dDataset",
                         "data": _cfg(scene)}, training=False)
    assert isinstance(got, N3dInferDataset)
    wb = want.collate([want[0], want[1]])
    gb = got.collate([got[0], got[1]])
    assert set(gb) == set(wb)
    for k, w in wb.items():
        if k == "gs":
            assert len(gb[k]) == len(w) == 1
            for name in ("xyz", "opacity", "rotation", "scaling", "shs",
                         "valid"):
                np.testing.assert_array_equal(
                    getattr(gb[k][0], name).numpy(),
                    np.asarray(getattr(w[0], name)), err_msg=name)
        elif isinstance(w, np.ndarray):
            np.testing.assert_allclose(gb[k], w, rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            assert gb[k] == w, k
    # the second window: no Gaussians, no depth
    wb2, gb2 = want.collate([want[2]]), got.collate([got[2]])
    assert "gs" not in wb2 and "gs" not in gb2
    assert "depth" not in wb2 and "depth" not in gb2

    want.build_refine_dataset(2)
    got.build_refine_dataset(2)
    assert got.refine_items == want.refine_items == [2]
    assert got.refine_dataset == want.refine_dataset
    w, g = want.get_refine_data(2), got.get_refine_data(2)
    assert len(g["images"]) == len(w["images"]) == 13
    for a, b in zip(g["images"], w["images"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(g["c2ws"]), np.stack(w["c2ws"]))
    np.testing.assert_array_equal(g["FOV"], w["FOV"])
    np.testing.assert_array_equal(g["bg"], w["bg"])


@pytest.mark.parametrize("scene_type", ["n3d", "meet", "sports", "enerf"])
@pytest.mark.parametrize("offset", [None, 0, 2])
def test_paths_match_jax(scene, scene_type, offset):
    cfg = _cfg(scene, scene_type=scene_type, depth_id_offset=offset)
    want, got = JDataset(cfg), N3dInferDataset(cfg)
    cams = want.cameras_data
    for vid in (0, 1, 13):
        assert got._paths_for("a/cur", "a/next", vid, cams) == \
            want._paths_for("a/cur", "a/next", vid, cams)


def test_enerf_raises(scene, tmp_path):
    """``scene_type: enerf`` used to raise (no JPEG decoder); now its items
    and refine data are JAX's, bit for bit, on JPEGs PIL wrote (view table
    [0] / [9, 2, 3, 1], depth offset -1)."""
    root = enerf_copy(scene["root"], str(tmp_path / "enerf"))
    cfg = _cfg(scene, root_dir=root, scene_type="enerf",
               depth_id_offset=None)
    want, got = JDataset(cfg), N3dInferDataset(cfg)
    paths = got._paths_for("c", "n", 0, got.cameras_data)
    assert paths == want._paths_for("c", "n", 0, want.cameras_data)
    assert paths["cur"].endswith(".jpg") and "images_2" in paths["cur"]
    assert paths["depth"].endswith(".png")
    for i in range(len(want)):
        _same_item(got[i], want[i])
    assert got[0]["images_output"].shape == (5, 3, 24, 40)
    want.build_refine_dataset(2)
    got.build_refine_dataset(2)
    w, g = want.get_refine_data(2), got.get_refine_data(2)
    assert len(g["images"]) == len(w["images"]) == 13
    for a, b in zip(g["images"], w["images"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(g["c2ws"]), np.stack(w["c2ws"]))


@pytest.mark.parametrize("n_views,scale", [(7, 1.0), (30, 0.5)])
def test_spiral_path_matches_jax(scene, n_views, scale):
    c2ws = N3dInferDataset(_cfg(scene))[0]["c2w_output"]
    np.testing.assert_allclose(spiral_path(c2ws, n_views, scale),
                               jax_spiral_path(c2ws, n_views, scale),
                               rtol=0, atol=1e-6)
