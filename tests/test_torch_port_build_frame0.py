"""The port's frame-0 build (``python -m igs_tpu_torch.build_frame0``)
against the JAX package's ``build_frame0.py`` on one tiny frame: the same
PLY rows, and the exported renders' PSNR against the same ground truth
within 0.05 dB."""

import builtins
import importlib
import json
import os

import numpy as np
import pytest
import torch

import build_frame0 as jax_build
from igs_tpu_torch import build_frame0 as port_build
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.data.dataset import fov2focal
from igs_tpu_torch.data.images import load_images_nchw
from igs_tpu_torch.data.ply import load_gaussian_ply
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.train import frame0 as tf0
from igs_tpu_torch.utils.saving import save_image

torch.set_num_threads(2)

HW = 32
TS = RasterSettings(image_height=HW, image_width=HW, max_pairs=1 << 14,
                    outputs="color")

FINETUNE = 200


def _write_frame(frame_dir, n=48, views=2, seed=0):
    """cameras.json, images_512/*.png rendered by the port from seeded
    Gaussians at z ≈ 6 (above the z-cull plane), and a noisy points3D.npz."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    xyz[:, 2] += 6.0
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1, 1.5, (n, 3))
    g = Gaussians.create(xyz, rng.uniform(0, 2, (n, 1)), rot,
                         rng.uniform(-3.0, -2.0, (n, 3)), shs, device="cpu")
    os.makedirs(os.path.join(frame_dir, "images_512"))
    cams = []
    for i in range(views):
        th = (i / views - 0.5) * 0.6
        pos = np.float32([4 * np.sin(th), 0.0, 6.0 - 4 * np.cos(th)])
        z = np.float32([0, 0, 6]) - pos
        z /= np.linalg.norm(z)
        x = np.cross([0.0, -1.0, 0.0], z)
        x /= np.linalg.norm(x)
        rmat = np.stack([x, np.cross(z, x), z], 1)
        focal = float(fov2focal(0.8, HW))
        cams.append({"id": i, "img_name": f"{i:05d}", "width": HW,
                     "height": HW, "position": pos.tolist(),
                     "rotation": rmat.tolist(), "fx": focal, "fy": focal})
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3], c2w[:3, 3] = rmat, pos
        cam = Camera.from_c2w(c2w, (0.8, 0.8), (HW, HW), device="cpu")
        img = rasterize(g.get_xyz, g.get_opacity, g.get_scaling,
                        g.get_rotation, cam, shs=g.shs, valid=g.valid,
                        settings=TS)["color"]
        save_image(os.path.join(frame_dir, "images_512", f"{i:05d}.png"),
                   img.numpy())
    with open(os.path.join(frame_dir, "cameras.json"), "w") as f:
        json.dump(cams, f)
    np.savez(os.path.join(frame_dir, "points3D.npz"),
             xyz=xyz + 0.05 * rng.normal(size=xyz.shape).astype(np.float32),
             rgb=rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32))


def _psnrs(frame_dir, mode, iters):
    gt = load_images_nchw([os.path.join(frame_dir, "images_512",
                                        f"{i:05d}.png") for i in range(2)],
                          HW, HW)
    out = load_images_nchw([os.path.join(
        frame_dir, mode, "train", f"ours_{iters}_compress", "gt",
        f"{i:05d}.png") for i in range(2)], HW, HW)
    return [float(-10 * np.log10(np.mean((out[i] - gt[i]) ** 2)))
            for i in range(2)]


def test_train_one_frame_matches_jax(tmp_path, monkeypatch):
    """Both builds on one 32×32 two-view frame, 10 training steps (no
    densify before step 500), the 45 % importance prune, and a fine-tune.
    Two test-side caps keep this small: the JAX driver's 2^21 pair budget
    becomes 2^12 (both sides), and its hard-coded 1000 fine-tune steps
    become 200 (ROADMAP C) by shadowing ``range`` in its module; the port
    takes ``finetune_iters`` 200."""
    frame = str(tmp_path / "colmap_0")
    _write_frame(frame)
    jax_raster = importlib.import_module("igs_tpu.ops.rasterize")
    settings_cls = jax_raster.RasterSettings
    monkeypatch.setattr(jax_raster, "RasterSettings", lambda **kw: settings_cls(
        **{**kw, "max_pairs": 1 << 12, "max_per_tile": 256}))

    def capped_range(*args):
        return builtins.range(1, FINETUNE + 1) if args == (1, 1001) \
            else builtins.range(*args)

    monkeypatch.setattr(jax_build, "range", capped_range, raising=False)
    jax_build.train_one_frame(frame, "images_512", "jax", 10, 0.45, 64)
    rec = port_build.train_one_frame(
        frame, "images_512", "port", 10, 0.45, 64, finetune_iters=FINETUNE,
        device="cpu", max_pairs=1 << 12)

    ply = os.path.join("point_cloud", "iteration_10_compress",
                       "point_cloud.ply")
    jrows = load_gaussian_ply(os.path.join(frame, "jax", ply))
    trows = load_gaussian_ply(os.path.join(frame, "port", ply))
    assert trows.num_capacity == jrows.num_capacity == rec["n_final"]
    assert rec["n_after_prune"] == 48 - tf0.pruned_count(48, 0.45)
    for sub in ("gt", "depth_expected_mm"):
        assert sorted(os.listdir(os.path.join(
            frame, "port", "train", "ours_10_compress", sub))) == [
                "00000.png", "00001.png"]
    want, got = _psnrs(frame, "jax", 10), _psnrs(frame, "port", 10)
    assert np.all(np.abs(np.subtract(got, want)) < 0.05), (got, want)
    assert rec["finetune_losses"][-1] < rec["losses"][0]


def test_build_frame0_cli(tmp_path, capsys, monkeypatch):
    """``python -m igs_tpu_torch.build_frame0 --device cpu`` on a toy
    scene, then on two frames with ``--spmd`` (two gloo ranks, a frame
    each) and with the ``--workers 2`` job pool: every frame exported."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the pool's subprocesses
    scene = tmp_path / "scene"
    _write_frame(str(scene / "colmap_0"))
    base = ["--scene", str(scene), "--iterations", "2", "--finetune-iters",
            "2", "--capacity", "64", "--device", "cpu"]
    port_build.main(base)
    assert "frame done" in capsys.readouterr().out
    assert os.path.exists(scene / "colmap_0" / "3dgs_rade" / "cameras.json")
    _write_frame(str(scene / "colmap_1"), seed=1)
    ply = os.path.join("point_cloud", "iteration_2_compress",
                       "point_cloud.ply")
    for mode, flags in (("spmd", ["--spmd", "--workers", "2", "--backend",
                                  "gloo"]),
                        ("pool", ["--workers", "2", "--devices", "0,0"])):
        port_build.main(base + ["--gs-mode", mode] + flags)
        for f in (0, 1):
            assert os.path.exists(scene / f"colmap_{f}" / mode / ply), (
                mode, f)


def test_worker_pool_fails_loudly(tmp_path, monkeypatch):
    """ROADMAP C31: a frame whose job fails makes the pool exit non-zero,
    naming it (the JAX pool drops it and exits 0)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    scene = tmp_path / "scene"
    _write_frame(str(scene / "colmap_0"))
    os.makedirs(scene / "colmap_1")  # no cameras.json: its job fails
    with pytest.raises(SystemExit, match="1 of 2 frame jobs failed"
                       ".*colmap|frame 1"):
        port_build.main(["--scene", str(scene), "--iterations", "2",
                         "--finetune-iters", "2", "--capacity", "64",
                         "--device", "cpu", "--workers", "2"])
    assert os.path.exists(scene / "colmap_0" / "3dgs_rade" / "cameras.json")


@pytest.mark.parametrize("frames,wanted,ranks", [
    (4, 2, 2), (3, 2, 1), (6, 4, 3), (2, 8, 2)])
def test_sweep_takes_ranks_that_divide_the_frames(frames, wanted, ranks):
    """``--spmd`` takes the most ranks, at most those asked for and the
    frame count, that divide the frames (the JAX sweep's device count,
    ``build_frame0.py``'s ``while f_count % nsh``)."""
    assert port_build._ranks_for(frames, wanted) == ranks
