"""Synthetic scene builder: writes an on-disk N3DV-layout dataset.

Counterpart of ``igs_tpu/data/synthetic.py``: per frame the
``images_r2``/``images_512`` renders, ``<gs_mode>/cameras.json``, the
frame's ``point_cloud.ply`` and ``train/ours_<iter>/{gt,
depth_expected_mm}`` renders, then ``bbox.json`` and a key/candidate
pair json. The same numpy recipe and seeds give the same Gaussians, PLYs
and cameras as the JAX writer.

The renders go through the port's rasterizer (the packed route), which
walks every pair of a tile. The JAX writer renders with its XLA oracle
(``impl="tiles"``) and a 512-pair window per tile, so it silently drops
the pairs of tiles denser than 512 (ROADMAP C16); where no tile passes
512 pairs the two writers' images agree up to the blend's rounding. A
view whose pairs overflow the pair budget raises here: pass ``settings``
with a larger ``max_pairs``. PNGs are written with the port's codec, on
a pool of threads while the next view renders (zlib and numpy release
the GIL; the encodes take most of a large scene's time).
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.data.images import encode_png, write_png
from igs_tpu_torch.data.ply import save_gaussian_ply
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.utils.device import resolve_device


def make_cameras(n_cams: int, radius: float = 4.0, fov: float = 0.8,
                 height: int = 64, width: int = 64):
    """Ring of inward-looking cameras in the z<0 half space (3DGS frame),
    as ``cameras.json`` records."""
    cams = []
    for i in range(n_cams):
        theta = (i / n_cams - 0.5) * 1.6  # partial arc like N3DV rigs
        pos = np.array(
            [radius * np.sin(theta), 0.15 * np.sin(3 * theta),
             -radius * np.cos(theta)], np.float32)
        z = -pos / np.linalg.norm(pos)  # look at the origin (+z forward)
        up = np.array([0.0, -1.0, 0.0], np.float32)  # 3DGS y-down
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.stack([x, y, z], 1)
        c2w[:3, 3] = pos
        fx = width / (2 * np.tan(fov / 2))
        fy = height / (2 * np.tan(fov / 2))
        cams.append({
            "id": i, "img_name": f"cam{i:02d}", "width": width,
            "height": height, "position": pos.tolist(),
            "rotation": c2w[:3, :3].tolist(), "fx": float(fx), "fy": float(fy),
        })
    return cams


def scene_gaussians(n: int, seed: int, t: float, motion_scale: float = 1.0,
                    static_frac: float = 0.5, opacity_range=(1.0, 4.0),
                    scale_range=(-2.8, -1.8)):
    """A moving blob: a static shell and a dynamic core drifting with
    ``t``; numpy (xyz, opacity, rotation, scaling, shs)."""
    rng = np.random.RandomState(seed)
    n_static = int(n * static_frac)
    static = rng.uniform(-1.5, 1.5, (n_static, 3)).astype(np.float32)
    core = rng.uniform(-0.5, 0.5, (n - n_static, 3)).astype(np.float32)
    core = core + motion_scale * np.array(
        [0.6 * np.sin(t), 0.3 * np.cos(t), 0.0], np.float32)
    xyz = np.concatenate([static, core])
    opacity = rng.uniform(*opacity_range, (n, 1)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    scaling = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1.0, 2.0, (n, 3))
    return xyz, opacity, rot, scaling, shs


def _default_settings(h: int, w: int) -> RasterSettings:
    return RasterSettings(
        image_height=h, image_width=w,
        max_pairs=1 << min(21, max(15, math.ceil(math.log2(h * w * 2)))))


def _write_copies(paths, img: np.ndarray) -> None:
    """One PNG of ``img`` written to every path of ``paths``."""
    png = encode_png(img)
    for path in paths:
        with open(path, "wb") as fp:
            fp.write(png)


def build_synthetic_scene(
    root: str,
    scene_name: str = "toy_scene",
    n_frames: int = 11,
    n_cams: int = 14,
    n_gaussians: int = 512,
    height: int = 64,
    width: int = 64,
    interval: int = 5,
    gs_mode: str = "3dgs_rade",
    iteration: str = "6000_compress",
    settings: Optional[RasterSettings] = None,
    motion_scale: float = 1.0,
    static_frac: float = 0.5,
    opacity_range=(1.0, 4.0),
    scale_range=(-2.8, -1.8),
    out_height: Optional[int] = None,
    out_width: Optional[int] = None,
    device=None,
) -> dict:
    """Write the scene tree under ``root``; returns its paths and sizes.

    ``motion_scale`` scales the dynamic core's drift (1.0 ≈ 18 px/frame
    at 256²; ~0.3 gives an N3DV-like few px/frame). ``out_height`` /
    ``out_width``: the resolution of the eval and training renders
    (``images_r2``, ``gt``, depth) when it differs from the input
    (``images_512``) resolution. Renders run on ``device`` (``cuda``
    unless told)."""
    dev = resolve_device(device)
    out_h = out_height or height
    out_w = out_width or width
    if settings is None:
        settings = _default_settings(height, width)
    settings = settings._replace(image_height=height, image_width=width)
    two_res = (out_h, out_w) != (height, width)
    out_settings = (settings._replace(image_height=out_h, image_width=out_w)
                    if two_res else settings)
    cams = make_cameras(n_cams, height=height, width=width)
    fov = 2 * np.arctan(width / (2 * cams[0]["fx"]))

    def render(g, cam_json, s):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.array(cam_json["rotation"])
        c2w[:3, 3] = np.array(cam_json["position"])
        cam = Camera.from_c2w(c2w, (fov, fov), (s.image_height, s.image_width),
                              device=dev)
        with torch.no_grad():
            out = rasterize(g.get_xyz, g.get_opacity, g.get_scaling,
                            g.get_rotation, cam, shs=g.shs, valid=g.valid,
                            settings=s)
        if int(out["overflow_tiles"]):
            raise RuntimeError(
                f"a render of the synthetic scene overflowed its pair budget "
                f"({s.max_pairs}); pass settings with a larger max_pairs")
        img = torch.clamp(out["color"], 0, 1).cpu().numpy()
        u8 = (img.transpose(1, 2, 0) * 255).astype(np.uint8)
        return u8, out["depth"].cpu().numpy()

    scene_dir = os.path.join(root, scene_name)
    workers = min(8, os.cpu_count() or 1)
    pool = ThreadPoolExecutor(max_workers=workers)
    pending = []

    def write(fn, *args):
        if len(pending) >= 4 * workers:  # bound the images held in memory
            pending.pop(0).result()
        pending.append(pool.submit(fn, *args))

    for f in range(n_frames):
        g = Gaussians.create(*scene_gaussians(
            n_gaussians, seed=0, t=0.4 * f, motion_scale=motion_scale,
            static_frac=static_frac, opacity_range=opacity_range,
            scale_range=scale_range), device=dev)
        frame_dir = os.path.join(scene_dir, f"colmap_{f}")
        for sub in ("images_r2", "images_512"):
            os.makedirs(os.path.join(frame_dir, sub), exist_ok=True)
        mode_dir = os.path.join(frame_dir, gs_mode)
        train_dir = os.path.join(mode_dir, "train", f"ours_{iteration}")
        for sub in ("gt", "depth_expected_mm"):
            os.makedirs(os.path.join(train_dir, sub), exist_ok=True)
        with open(os.path.join(mode_dir, "cameras.json"), "w") as fj:
            json.dump(cams, fj)
        # every frame carries its PLY, as the reference's training set does
        ply_dir = os.path.join(mode_dir, "point_cloud",
                               f"iteration_{iteration}")
        os.makedirs(ply_dir, exist_ok=True)
        save_gaussian_ply(os.path.join(ply_dir, "point_cloud.ply"), g)
        for i, cam in enumerate(cams):
            u8, depth = render(g, cam, settings)
            write(write_png, os.path.join(frame_dir, "images_512",
                                          cam["img_name"] + ".png"), u8)
            if two_res:
                u8, depth = render(g, cam, out_settings)
            # the eval view and the training GT
            write(_write_copies, (os.path.join(frame_dir, "images_r2",
                                               cam["img_name"] + ".png"),
                                  os.path.join(train_dir, "gt",
                                               f"{i:05d}.png")), u8)
            # depth file i belongs to camera i
            write(write_png, os.path.join(train_dir, "depth_expected_mm",
                                          f"{i:05d}.png"),
                  np.clip(depth * 1000.0, 0, 65535).astype(np.uint16))
    for fut in pending:
        fut.result()
    pool.shutdown()

    # bbox over the dynamic region (generous)
    with open(os.path.join(root, "bbox.json"), "w") as fj:
        json.dump({scene_name: [[-1.4, -1.0, -0.6], [1.4, 1.0, 0.6]]}, fj)

    # key/candidate pairs: every interval-th frame is a key frame, each item
    # pairs the key frame with the next candidate
    items = []
    for f in range(n_frames - 1):
        key = (f // interval) * interval
        items.append({
            "scene_name": scene_name,
            "cur_frame": f"colmap_{key}",
            "next_frame": f"colmap_{f + 1}",
            "keyframe": 1 if f % interval == 0 else 0,
        })
    pair_path = os.path.join(root, f"{scene_name}_pairs.json")
    with open(pair_path, "w") as fj:
        json.dump({"train": items, "val": items}, fj)

    start_gs = os.path.join(scene_dir, "colmap_0", gs_mode, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
    return {
        "root": root,
        "scene_name": scene_name,
        "pairs": os.path.basename(pair_path),
        "start_gs_path": start_gs,
        "fov": float(fov),
        "height": height,
        "width": width,
    }
