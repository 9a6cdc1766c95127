"""Port training data and config against the JAX package's: the
N3dDataset items and ``collate`` on a scene written by the JAX
``build_synthetic_scene`` (arrays equal: the same PNG and PLY bytes go
through two decoders), the port's writer read back by the JAX dataset,
the config loader on the repo's training recipe, and the builders'
dataset routes and refusals.

The two writers render differently (the JAX one through its XLA oracle
with a 512-pair window, the port through its packed rasterizer), so the
port-written scene is held to the JAX-written one within the 8-bit
quantisation: each pixel within 1/255 except where the float32 render
sits on a quantisation step (≤ 2 % of the values), depth within 1 mm
except the same; cameras, pair lists and PLYs are equal.
"""

import json
import os

import numpy as np
import pytest

from igs_tpu.config import load_config as jax_load_config
from igs_tpu.data.dataset import N3dDataset as JDataset
from igs_tpu.data.synthetic import build_synthetic_scene as jax_build_scene
from igs_tpu_torch.builders import build_dataset, build_opt_config
from igs_tpu_torch.config import config_from_dict, load_config
from igs_tpu_torch.data.dataset import N3dDataset
from igs_tpu_torch.data.infer_data import N3dInferDataset
from igs_tpu_torch.data.synthetic import build_synthetic_scene

SCENE = dict(n_frames=3, n_cams=10, n_gaussians=64, height=32, width=32,
             interval=2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data_cfg(root, **extra):
    return {"data_path": "toy_scene_pairs.json", "root_dir": str(root),
            "gs_mode": "3dgs_rade", "iter": "6000_compress",
            "input_height": 32, "input_width": 32, "output_height": 32,
            "output_width": 32, "num_input_views": 2, "num_output_views": 3,
            "up_sample": True, "background_color": [0.0, 0.0, 0.0], **extra}


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_scene")
    jax_build_scene(str(root), **SCENE)
    return root


@pytest.fixture(scope="module")
def port_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_scene")
    build_synthetic_scene(str(root), device="cpu", **SCENE)
    return root


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k == "gs_path":
            assert got[k] == w
            continue
        g = got[k]
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=k)


@pytest.mark.parametrize("training", [True, False])
def test_items_and_collate_match_jax(jax_scene, training):
    cfg = _data_cfg(jax_scene)
    want_ds, got_ds = JDataset(cfg, training), N3dDataset(cfg, training)
    assert len(got_ds) == len(want_ds) == SCENE["n_frames"] - 1
    for i in range(len(want_ds)):
        _assert_items_equal(got_ds[i], want_ds[i])
    want = want_ds.collate([want_ds[0], want_ds[1]])
    got = got_ds.collate([got_ds[0], got_ds[1]])
    _assert_items_equal({k: v for k, v in got.items() if k != "gs"},
                        {k: v for k, v in want.items() if k != "gs"})
    for gg, wg in zip(got["gs"], want["gs"]):
        for name in ("xyz", "opacity", "rotation", "scaling", "shs", "valid"):
            np.testing.assert_array_equal(getattr(gg, name).numpy(),
                                          np.asarray(getattr(wg, name)),
                                          err_msg=name)


def test_group_views_pick_one_per_group(jax_scene, tmp_path):
    """``use_group``: one random view of each group plus random others,
    drawn from the dataset's own ``random.Random``."""
    with open(os.path.join(jax_scene, "toy_scene", "group.json"), "w") as f:
        json.dump([[0, 1, 2], [3, 4], [5, 6, 7]], f)
    try:
        ds = N3dDataset(_data_cfg(jax_scene, use_group=True,
                                  num_output_views=5))
        picks = [ds.view_ids("toy_scene") for _ in range(20)]
    finally:
        os.remove(os.path.join(jax_scene, "toy_scene", "group.json"))
    for vids in picks:
        assert len(vids) == len(set(vids)) == 5
        assert vids[0] in (0, 1, 2) and vids[1] in (3, 4)
        assert vids[2] in (5, 6, 7)
    assert len({tuple(v) for v in picks}) > 1
    again = N3dDataset(_data_cfg(jax_scene, use_group=True))
    assert again.rng.random() == N3dDataset(_data_cfg(jax_scene)).rng.random()


def test_port_writer_reads_back_through_the_jax_dataset(jax_scene,
                                                       port_scene):
    for name in ("bbox.json", "toy_scene_pairs.json"):
        with open(os.path.join(port_scene, name)) as a, \
                open(os.path.join(jax_scene, name)) as b:
            assert json.load(a) == json.load(b), name
    for f in range(SCENE["n_frames"]):
        mode = os.path.join("toy_scene", f"colmap_{f}", "3dgs_rade")
        with open(os.path.join(port_scene, mode, "cameras.json")) as a, \
                open(os.path.join(jax_scene, mode, "cameras.json")) as b:
            assert json.load(a) == json.load(b)
        ply = os.path.join(mode, "point_cloud", "iteration_6000_compress",
                           "point_cloud.ply")
        with open(os.path.join(port_scene, ply), "rb") as a, \
                open(os.path.join(jax_scene, ply), "rb") as b:
            assert a.read() == b.read()
    for training in (True, False):
        got_ds = JDataset(_data_cfg(port_scene), training)
        want_ds = JDataset(_data_cfg(jax_scene), training)
        for i in range(len(want_ds)):
            got, want = got_ds[i], want_ds[i]
            for k in ("cur_images_input", "next_images_input",
                      "images_output"):
                d = np.abs(got[k] - want[k])
                assert d.max() <= 1.0 / 255 + 1e-7, k
                assert (d > 0).mean() <= 0.02, k
            d = np.abs(got["depth"] - want["depth"])
            assert d.max() <= 1e-3 + 1e-6 and (d > 0).mean() <= 0.02
            for k in ("c2w_output", "c2w_input", "FOV", "rays",
                      "local_rays", "bounding_box", "radius"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_config_loader_matches_jax(tmp_path):
    path = os.path.join(ROOT, "configs", "synthetic_train_256.yaml")
    dots = ["opt.batch_size=3", "opt.lr=5e-4", "system.local_ray=True",
            "data.data.root_dir=/elsewhere"]
    want = jax_load_config(path, cli_args=dots)
    got = load_config(path, cli_args=dots)
    for sec in ("n_gpus", "opt", "data", "system"):
        assert getattr(got, sec) == getattr(want, sec), sec
    assert got.opt["lr"] == 5e-4 and got.opt["batch_size"] == 3
    # interpolation and resolvers, from a string and from dict sections
    text = ("opt:\n  a: 2\n  b: ${mul:${opt.a},3}\n  c: ${gt0:${opt.a}}\n"
            "system:\n  d: ${shsdim:3}\n  e: pre_${opt.a}\n")
    want = jax_load_config(text, from_string=True)
    got = load_config(text, from_string=True)
    assert (got.opt, got.system) == (want.opt, want.system)
    assert got.opt == {"a": 2, "b": 6, "c": True}
    assert config_from_dict({"opt": {"a": 2, "b": "${opt.a}"}}).opt["b"] == 2


def test_builders_refuse_what_is_not_ported(jax_scene):
    # the streaming dataset by either class path
    for cls in ("igs.data.infer_data.N3dDataset",
                "igs_tpu.data.infer_data.N3dInferDataset"):
        ds = build_dataset({"data_cls": cls, "data": _data_cfg(jax_scene)},
                           training=True)
        assert isinstance(ds, N3dInferDataset) and ds.training
    ds = build_dataset({"data_cls": "igs.data.data.N3dDataset",
                        "data": _data_cfg(jax_scene)}, training=False)
    assert isinstance(ds, N3dDataset) and not ds.training
    # half precision: fp16 runs as bf16, as in JAX
    for mp in ("fp16", "bf16", "no"):
        assert build_opt_config({"mixed_precision": mp}).mixed_precision == mp
    # the LPIPS term is ported (A3): it builds
    assert build_opt_config({"lambda_lpips": 0.5}).lambda_lpips == 0.5
    cfg = build_opt_config({"lr": "4e-4", "warmup_steps": 200})
    assert cfg.lr == 4e-4 and cfg.warmup_steps == 200
    assert cfg.weight_decay == 0.05 and cfg.beta2 == 0.95
