"""Training dataset for AGM-Net (N3DV pair data built by RaDe-GS), and
the camera records of the datasets.

Counterpart of ``igs_tpu/data/dataset.py``, the reference's N3dDataset
(igs/data/data.py:26-268). Per item (scene, cur_frame, next_frame) it
reads the GT renders and expected-depth PNGs (uint16 mm / 1000) from
``<frame>/<gs_mode>/train/ours_<iter>/{gt,depth_expected_mm}``, the
camera poses from ``cameras.json``, ``bbox.json``, the optional
``group.json`` view picking, local and world rays at input_res/8 (×2 with
``up_sample``), and the cur frame's Gaussians PLY at collate time.

Numpy throughout: items and batches are dicts of numpy arrays (and the
Gaussians), decoded with the port's own PNG and JPEG codecs and PLY
reader, so the card's machine needs no PIL. Images stay in [0, 1] as the reference keeps
them. ``group.json`` picks views with an explicit ``random.Random``.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from igs_tpu_torch.core.camera import focal2fov
from igs_tpu_torch.data.images import read_image, read_png
from igs_tpu_torch.data.ply import load_gaussian_ply


def fov2focal(fov, pixels):
    return pixels / (2 * np.tan(fov / 2))


def camera_from_json(cam: Dict) -> Tuple[np.ndarray, float, float]:
    """One ``cameras.json`` entry (rotation, position, fx, fy, width,
    height) → (4×4 float32 c2w, fovx, fovy)."""
    c2w = np.zeros((4, 4), np.float32)
    c2w[:3, :3] = np.array(cam["rotation"])
    c2w[:3, 3] = np.array(cam["position"])
    c2w[3, 3] = 1
    fovx = focal2fov(cam["fx"], cam["width"])
    fovy = focal2fov(cam["fy"], cam["height"])
    return c2w, float(fovx), float(fovy)


def get_nerfpp_norm(cam_centers: np.ndarray) -> Dict[str, Any]:
    """Scene radius and translate from the camera centres."""
    center = cam_centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(cam_centers - center, axis=1)
    return {"translate": -center[0], "radius": float(dist.max() * 1.1)}


def load_image(path: str) -> np.ndarray:
    """RGB float32 in [0, 1], (3, H, W), of a PNG or a JPEG
    (``read_image``); grey repeats into each channel."""
    img = read_image(path)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return (img[..., :3] / 255.0).astype(np.float32).transpose(2, 0, 1)


def load_depth_mm(path: str) -> np.ndarray:
    """uint16 millimetre PNG → float32 metres."""
    return (read_png(path) / 1000.0).astype(np.float32)


def local_ray_directions(h: int, w: int, fovx: float, fovy: float
                         ) -> np.ndarray:
    """(H, W, 3) normalized +z-forward camera-local rays through the pixel
    centres."""
    fx, fy = fov2focal(fovx, w), fov2focal(fovy, h)
    i, j = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                       np.arange(h, dtype=np.float32) + 0.5, indexing="xy")
    d = np.stack([(i - w / 2) / fx, (j - h / 2) / fy, np.ones_like(i)], -1)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def world_rays(directions: np.ndarray, c2ws: np.ndarray) -> np.ndarray:
    """(V, H, W, 6) [origin | direction] world rays."""
    dirs = np.einsum("vij,hwj->vhwi", c2ws[:, :3, :3], directions)
    ori = np.broadcast_to(c2ws[:, None, None, :3, 3], dirs.shape)
    return np.concatenate([ori, dirs], axis=-1).astype(np.float32)


@dataclass
class N3dDatasetConfig:
    """The reference's N3dDatasetConfig (data.py:26-56)."""

    background_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    data_path: str = ""
    bbox_path: str = "bbox.json"
    root_dir: str = ""
    num_input_views: int = 4
    num_output_views: int = 8
    output_height: int = 1014
    output_width: int = 1352
    input_height: int = 512
    input_width: int = 512
    gs_mode: str = "3dgs_rade"
    iter: str = "10000_compress"
    need_rays: bool = True
    need_flow: bool = True
    up_sample: bool = False
    use_group: bool = False
    use_gstream: bool = False
    max_sh_degree: int = 3
    # accepted for reference-config compatibility
    scene_type: Optional[str] = None
    start_gs_path: Optional[str] = None
    start_frame: int = 0


class N3dDataset:
    """Items of key-frame → candidate pairs; ``rng`` draws the
    ``group.json`` view picks (a seeded ``random.Random`` by default)."""

    def __init__(self, cfg: Dict[str, Any], training: bool = True,
                 rng: Optional[random.Random] = None):
        known = {k: v for k, v in cfg.items()
                 if k in N3dDatasetConfig.__dataclass_fields__}
        self.cfg = N3dDatasetConfig(**known)
        self.training = training
        self.rng = rng or random.Random(0)
        with open(os.path.join(self.cfg.root_dir, self.cfg.data_path)) as f:
            paths = json.load(f)
        self.items = paths["train" if training else "val"]
        with open(os.path.join(self.cfg.root_dir, self.cfg.bbox_path)) as f:
            self.bboxs = json.load(f)
        self.background_color = np.asarray(self.cfg.background_color,
                                           np.float32)

    def __len__(self):
        return len(self.items)

    def _frame_dir(self, scene, frame):
        return os.path.join(self.cfg.root_dir, scene, frame)

    def view_ids(self, scene: str) -> List[int]:
        """The output views of an item: a random pick per ``group.json``
        group plus random others (training with ``use_group``), the first
        ``num_output_views`` (training), or the reference's eval views."""
        if self.training and self.cfg.use_group:
            with open(os.path.join(self.cfg.root_dir, scene,
                                   "group.json")) as f:
                groups = json.load(f)
            selected = [self.rng.choice(g) for g in groups]
            rest = [v for g in groups for v in g if v not in selected]
            return selected + self.rng.sample(
                rest, self.cfg.num_output_views - len(selected))
        if self.training:
            return list(range(self.cfg.num_output_views))
        return [3, 7, 1, 4, 8, 0]

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = self.items[idx]
        scene, cur, nxt = (item["scene_name"], item["cur_frame"],
                           item["next_frame"])
        cur_dir, next_dir = (self._frame_dir(scene, cur),
                             self._frame_dir(scene, nxt))
        with open(os.path.join(cur_dir, self.cfg.gs_mode,
                               "cameras.json")) as f:
            cameras = json.load(f)
        centers = np.array([c["position"] for c in cameras])
        scene_info = get_nerfpp_norm(centers)
        bbox = np.asarray(self.bboxs[scene], np.float32)

        base = os.path.join(self.cfg.gs_mode, "train", f"ours_{self.cfg.iter}")
        cur_images, next_images, depths, c2ws = [], [], [], []
        fovx = fovy = None
        for vid in self.view_ids(scene):
            name = str(vid).zfill(5) + ".png"
            cur_images.append(load_image(os.path.join(cur_dir, base, "gt",
                                                      name)))
            next_images.append(load_image(os.path.join(next_dir, base, "gt",
                                                       name)))
            depths.append(load_depth_mm(os.path.join(
                cur_dir, base, "depth_expected_mm", name)))
            c2w, fovx, fovy = camera_from_json(cameras[vid])
            c2ws.append(c2w)
        cur_images = np.stack(cur_images)
        next_images = np.stack(next_images)
        depths = np.stack(depths)
        c2ws = np.stack(c2ws)
        vin = self.cfg.num_input_views

        res: Dict[str, Any] = {
            "gs_path": os.path.join(
                cur_dir, self.cfg.gs_mode, "point_cloud",
                f"iteration_{self.cfg.iter}", "point_cloud.ply"),
            "cur_images_input": cur_images[:vin],
            "next_images_input": next_images[:vin],
            "images_output": next_images,
            "depth": depths[:vin],
            "c2w_output": c2ws,
            "c2w_input": c2ws[:vin],
            "FOV": np.asarray([fovx, fovy], np.float32),
            "background_color": self.background_color,
            "resolution": np.asarray(next_images.shape[-2:], np.int32),
            "idx": idx,
            "radius": np.float32(scene_info["radius"]),
            "translate": scene_info["translate"].astype(np.float32),
            "bounding_box": bbox,
        }
        if self.cfg.need_rays:
            h = self.cfg.input_height // 8
            w = self.cfg.input_width // 8
            if self.cfg.up_sample:
                h, w = 2 * h, 2 * w
            dirs = local_ray_directions(h, w, fovx, fovy)
            res["local_rays"] = dirs
            res["rays"] = world_rays(dirs, c2ws[:vin])
        return res

    def collate(self, items: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Stack the items' arrays and load each item's Gaussians (CPU)."""
        batch: Dict[str, Any] = {}
        for k in items[0]:
            if k == "gs_path":
                batch[k] = [it[k] for it in items]
            else:
                batch[k] = np.stack([np.asarray(it[k]) for it in items])
        batch["gs"] = [load_gaussian_ply(p, max_sh_degree=self.cfg.max_sh_degree)
                       for p in batch["gs_path"]]
        return batch
