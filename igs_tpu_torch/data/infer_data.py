"""Streaming-evaluation dataset (N3DV / MeetRoom / ENeRF / Sports) and
the spiral free-view path.

Counterpart of ``igs_tpu/data/infer_data.py`` (the reference's
igs/data/infer_data.py): the scene types' view tables, Gaussians and depth
at frame 0 only (the stream carries them after), 512² inputs beside the
full-resolution eval outputs, the key frames' refine data (every training
view of the key frame) and ``spiral_path``.

Numpy throughout, like ``data/dataset.py``: images decode with the port's
PNG and JPEG codecs (``data/images.py``, by suffix), whose headers give
their sizes, so the card's machine needs no PIL. ``scene_type: enerf``
reads ``images_2/*.jpg`` and ``images_512/*.jpg`` (its depths stay PNG).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from igs_tpu_torch.data.dataset import (
    camera_from_json, get_nerfpp_norm, load_image, local_ray_directions,
    world_rays)
from igs_tpu_torch.data.images import image_size, load_images_nchw
from igs_tpu_torch.data.ply import load_gaussian_ply

# the scene types' eval and input views (the reference's
# infer_data.py:194-210)
VIEW_TABLES = {
    "n3d": {"eval": [0], "input": [13, 1, 8, 4]},
    "meet": {"eval": [0], "input": [3, 10, 1, 4]},
    "enerf": {"eval": [0], "input": [9, 2, 3, 1]},
    "sports": {"eval": [1], "input": [11, 14, 17, 20]},
}


@dataclass
class InferDatasetConfig:
    background_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    data_path: str = ""
    root_dir: str = ""
    num_input_views: int = 4
    num_output_views: int = 20
    output_height: int = 1014
    output_width: int = 1352
    input_height: int = 512
    input_width: int = 512
    gs_mode: str = "3dgs_rade"
    iter: str = "10000_compress"
    start_frame: int = 0
    scene_type: Optional[str] = None
    need_rays: bool = True
    bbox_path: str = "bbox.json"
    start_gs_path: Optional[str] = None
    max_sh_degree: int = 3
    up_sample: bool = True
    # load each item's cur-frame PLY and depth, as the training dataset
    # does, in the val split too: the training driver's eval needs
    # per-item Gaussians; streaming loads them at frame 0 only
    load_gs_per_item: bool = False
    # depth file id = view id + offset. None: the reference's per-scene-type
    # offsets (+1 for n3d and meet, -1 for enerf, 0 for sports), a property of how those
    # datasets' depth renders were numbered. Scenes written by the port or
    # the JAX package (build_frame0, data/synthetic) number depth file i
    # for camera i and set 0.
    depth_id_offset: Optional[int] = None


class N3dInferDataset:
    """Key → candidate items of a stream; only frame 0 loads Gaussians and
    depth, unless ``training`` or ``load_gs_per_item``."""

    def __init__(self, cfg: Dict[str, Any], training: bool = False):
        known = {k: v for k, v in cfg.items()
                 if k in InferDatasetConfig.__dataclass_fields__}
        self.cfg = InferDatasetConfig(**known)
        self.training = training
        with open(os.path.join(self.cfg.root_dir, self.cfg.data_path)) as f:
            paths = json.load(f)
        self.items = paths["train" if training else "val"]
        with open(os.path.join(self.cfg.root_dir, self.cfg.bbox_path)) as f:
            self.bboxs = json.load(f)
        first_dir = os.path.join(
            self.cfg.root_dir, self.items[0]["scene_name"],
            self.items[0]["cur_frame"], self.cfg.gs_mode)
        with open(os.path.join(first_dir, "cameras.json")) as f:
            self.cameras_data = json.load(f)
        self.background_color = np.asarray(self.cfg.background_color,
                                           np.float32)
        self.refine_items: List[int] = []

    def __len__(self):
        return len(self.items)

    def build_refine_dataset(self, eval_batch_size: int):
        """Key frames: every ``eval_batch_size``-th item (1-based)."""
        self.refine_items = list(
            range(eval_batch_size, len(self.items) + 1, eval_batch_size))
        self.refine_dataset = set(self.refine_items)

    def _paths_for(self, frame_dir, next_dir, vid, cameras):
        st = self.cfg.scene_type
        image_name = cameras[vid]["img_name"]
        off = self.cfg.depth_id_offset
        if st in ("n3d", "sports"):
            if off is None:
                off = 1 if st == "n3d" else 0
            img_dir = "images_r2"
            ext = ".png"
        elif st == "meet":
            if off is None:
                off = 1
            img_dir = "images"
            ext = ".png"
        elif st == "enerf":
            if off is None:
                off = -1
            img_dir = "images_2"
            ext = ".jpg"
        else:
            raise ValueError(f"unknown scene_type {st}")
        vid_id = str(max(vid + off, 0)).zfill(5)
        base = os.path.join(self.cfg.gs_mode, "train", f"ours_{self.cfg.iter}")
        name = image_name + ext
        return {
            "cur": os.path.join(frame_dir, img_dir, name),
            "next": os.path.join(next_dir, img_dir, name),
            "cur_512": os.path.join(frame_dir, "images_512", name),
            "next_512": os.path.join(next_dir, "images_512", name),
            "depth": os.path.join(
                frame_dir, base, "depth_expected_mm", vid_id + ".png"),
        }

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = self.items[idx]
        scene = item["scene_name"]
        cur_dir = os.path.join(self.cfg.root_dir, scene, item["cur_frame"])
        next_dir = os.path.join(self.cfg.root_dir, scene, item["next_frame"])
        # the stream needs depth at frame 0 only (it carries the predicted
        # depth after); training reads it per item
        need_depth = (item["cur_frame"] == "colmap_0" or self.training
                      or self.cfg.load_gs_per_item)

        cameras = self.cameras_data
        centers = np.array([c["position"] for c in cameras])
        scene_info = get_nerfpp_norm(centers)
        bbox = np.asarray(self.bboxs[scene], np.float32)

        table = VIEW_TABLES[self.cfg.scene_type]
        vids = table["eval"] + table["input"]
        paths = [self._paths_for(cur_dir, next_dir, vid, cameras)
                 for vid in vids]
        c2ws = []
        for vid in vids:
            c2w, fovx, fovy = camera_from_json(cameras[vid])
            c2ws.append(c2w)
        c2ws = np.stack(c2ws)

        wf, hf = image_size(paths[0]["next"])
        wr, hr = image_size(paths[0]["cur_512"])
        next_full = load_images_nchw([p["next"] for p in paths], hf, wf)
        cur_r = load_images_nchw([p["cur_512"] for p in paths], hr, wr)
        next_r = load_images_nchw([p["next_512"] for p in paths], hr, wr)
        res: Dict[str, Any] = {
            "cur_images_input": cur_r[1:],
            "next_images_input": next_r[1:],
            "images_output": next_full,
            "c2w_output": c2ws,
            "c2w_input": c2ws[1:],
            "FOV": np.asarray([fovx, fovy], np.float32),
            "background_color": self.background_color,
            "resolution": np.asarray(next_full[0].shape[-2:], np.int32),
            "idx": idx,
            "eval_vids": table["eval"],
            "radius": np.float32(scene_info["radius"]),
            "bounding_box": bbox,
            # streaming: Gaussians at item 0 only (carried after);
            # training: every item's cur-frame PLY
            "gs_path": (
                os.path.join(cur_dir, self.cfg.gs_mode, "point_cloud",
                             f"iteration_{self.cfg.iter}", "point_cloud.ply")
                if self.training or self.cfg.load_gs_per_item
                else (self.cfg.start_gs_path if idx == 0 else "")),
        }
        if need_depth:
            wd, hd = image_size(paths[0]["depth"])
            res["depth"] = load_images_nchw(
                [p["depth"] for p in paths], hd, wd, channels=1,
                scale=1.0 / 1000.0)[1:, 0]
        if "keyframe" in item:
            res["keyframe"] = item["keyframe"]
        if self.cfg.need_rays:
            h = self.cfg.input_height // 8
            w = self.cfg.input_width // 8
            if self.cfg.up_sample:
                h, w = 2 * h, 2 * w
            dirs = local_ray_directions(h, w, fovx, fovy)
            res["local_rays"] = dirs
            res["rays"] = world_rays(dirs, c2ws[1:])
        return res

    def get_refine_data(self, key_idx: int) -> Dict[str, Any]:
        """Every training view of a key frame: ``key_idx`` is 1-based, the
        frame refined is ``items[key_idx - 1]``'s next frame."""
        item = self.items[key_idx - 1]
        frame_dir = os.path.join(self.cfg.root_dir, item["scene_name"],
                                 item["next_frame"])
        cameras = self.cameras_data
        eval_vids = set(VIEW_TABLES[self.cfg.scene_type]["eval"])
        images, c2ws = [], []
        fovx = fovy = None
        for vid in range(len(cameras)):
            if vid in eval_vids:
                continue
            path = self._paths_for(frame_dir, frame_dir, vid, cameras)["cur"]
            if not os.path.exists(path):
                continue
            images.append(load_image(path))
            c2w, fovx, fovy = camera_from_json(cameras[vid])
            c2ws.append(c2w)
        return {"images": images, "c2ws": c2ws,
                "FOV": np.asarray([fovx, fovy], np.float32),
                "bg": self.background_color}

    def collate(self, items: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Stack the items' arrays; load the Gaussians of the items that
        name a PLY."""
        batch: Dict[str, Any] = {}
        for k in items[0]:
            if k in ("gs_path", "eval_vids", "keyframe"):
                batch[k] = [it.get(k) for it in items]
            elif all(k in it for it in items):
                batch[k] = np.stack([np.asarray(it[k]) for it in items])
        gs_list = [load_gaussian_ply(p, max_sh_degree=self.cfg.max_sh_degree)
                   for p in batch["gs_path"] if p]
        if gs_list:
            batch["gs"] = gs_list
        return batch


def spiral_path(c2ws: np.ndarray, n_views: int = 299,
                rads_scale: float = 1.0) -> np.ndarray:
    """(n_views, 4, 4) free-view poses on a NeRF-style spiral around the
    rig (the reference's infer_data.py:97-134)."""
    centers = c2ws[:, :3, 3]
    center = centers.mean(0)
    up = -c2ws[:, :3, 1].mean(0)
    up = up / np.linalg.norm(up)
    rads = np.percentile(np.abs(centers - center), 90, axis=0) * rads_scale
    focus = center + np.array([0, 0, 1.0])
    poses = []
    for theta in np.linspace(0, 2 * np.pi, n_views):
        c = center + rads * np.array([np.cos(theta), -np.sin(theta), 0.0])
        z = focus - c
        z = z / np.linalg.norm(z)
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.stack([x, y, z], 1)
        pose[:3, 3] = c
        poses.append(pose)
    return np.stack(poses)
