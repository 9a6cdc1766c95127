"""The traffic generator of the streaming cells: a moving synthetic scene,
its camera rig, and the in-memory dataset that ``StreamingPipeline``
streams (the ``N3dInferDataset`` interface, as on disk: uint8 images,
depth in whole millimetres at frame 0 only).

Everything is made from the seed and the cell's traffic file. The scene is
the recipe of the port's ``data/synthetic.scene_gaussians`` (a frozen copy:
a uniform cube of Gaussians whose core drifts on a circle with ``t``); its
ground-truth images come from the benchmark's own plain rasterizer
(``reference/ops/rasterize.py``), not from the program's.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from igs_bench.reference.core.camera import Camera
from igs_bench.reference.core.gaussians import Gaussians
from igs_bench.reference.ops.rasterize import RasterSettings, rasterize


def scene_gaussians(n: int, seed: int, t: float, motion_scale: float,
                    static_frac: float, opacity_range, scale_range):
    """A moving blob: a static shell and a dynamic core drifting with
    ``t``; numpy (xyz, opacity, rotation, scaling, shs). The draws depend
    on ``seed`` only, so every frame holds the same Gaussians, moved."""
    rng = np.random.RandomState(seed % (1 << 32))
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


def make_cameras(n_cams: int, radius: float) -> np.ndarray:
    """(n_cams, 4, 4) c2ws of an arc of inward-looking cameras in the z<0
    half space (3DGS frame, y down), as N3DV rigs stand."""
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    for i in range(n_cams):
        theta = (i / n_cams - 0.5) * 1.6
        pos = np.array([radius * np.sin(theta), 0.15 * np.sin(3 * theta),
                        -radius * np.cos(theta)], np.float32)
        z = -pos / np.linalg.norm(pos)
        x = np.cross(np.array([0.0, -1.0, 0.0], np.float32), z)
        x /= np.linalg.norm(x)
        c2ws[i, :3, :3] = np.stack([x, np.cross(z, x), z], 1)
        c2ws[i, :3, 3] = pos
    return c2ws


def local_ray_directions(h: int, w: int, fovx: float, fovy: float
                         ) -> np.ndarray:
    """(h, w, 3) unit camera-frame ray directions at pixel centres."""
    fx = w / (2 * math.tan(fovx / 2))
    fy = h / (2 * math.tan(fovy / 2))
    i, j = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                       np.arange(h, dtype=np.float32) + 0.5, indexing="xy")
    d = np.stack([(i - w / 2) / fx, (j - h / 2) / fy, np.ones_like(i)], -1)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def world_rays(directions: np.ndarray, c2ws: np.ndarray) -> np.ndarray:
    """(V, h, w, 6) world-frame (origin, direction) rays of each c2w."""
    d = np.einsum("hwc,vrc->vhwr", directions, c2ws[:, :3, :3])
    o = np.broadcast_to(c2ws[:, None, None, :3, 3], d.shape)
    return np.concatenate([o, d], -1).astype(np.float32)


class Stream:
    """collate()-layout items of a key→candidate stream, in memory, with
    the key frames' refine data (``N3dInferDataset``'s interface)."""

    def __init__(self, items: List[Dict], start_gs, refine: Dict):
        self.items = items
        self.start_gs = start_gs
        self.refine = refine

    def build_refine_dataset(self, eval_batch_size: int):
        self.refine_dataset = set(
            range(eval_batch_size, len(self.items) + 1, eval_batch_size))

    def get_refine_data(self, key: int):
        return self.refine[key]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def collate(self, items):
        batch = {k: np.stack([it[k] for it in items])
                 for k in items[0] if k not in ("keyframe", "idx")}
        batch["keyframe"] = [it["keyframe"] for it in items]
        if items[0]["idx"] == 0:
            batch["gs"] = [self.start_gs]
        return batch


def frame_gaussians(cfg: Dict, traffic: Dict, seed: int, frame: int,
                    device) -> Gaussians:
    """The scene at ``frame`` (its motion has period ``traffic["period"]``)."""
    s = cfg["scene"]
    t = 2 * math.pi * (frame % traffic["period"]) / traffic["period"]
    return Gaussians.create(*scene_gaussians(
        s["n_gaussians"], seed, t, traffic["motion_scale"], s["static_frac"],
        s["opacity_range"], s["scale_range"]), device=device)


@torch.no_grad()
def build_stream(cfg: Dict, traffic: Dict, seed: int, device) -> Stream:
    """The clip of ``traffic["clip_frames"]`` items over a period of
    ``traffic["period"]`` distinct frames, rendered by the reference."""
    s, v = cfg["scene"], cfg["views"]
    fov = float(v["fov"])
    out_hw = tuple(v["output_hw"])
    in_res = int(v["input_res"])
    c2ws = make_cameras(int(v["n_cams"]), float(v["rig_radius"]))
    eval_view, input_views = int(v["eval_view"]), list(v["input_views"])
    vids = [eval_view] + input_views
    period, interval = int(traffic["period"]), int(cfg["stream"]["eval_batch_size"])
    n_items = int(traffic["clip_frames"])
    frames = [frame_gaussians(cfg, traffic, seed, f, device)
              for f in range(period)]

    def render(g, c2w_list, hw, outputs="color"):
        """(V, 3, H, W) uint8-quantised images (the dataset reads PNGs)
        and (V, H, W) depth of the views, in one call."""
        st = RasterSettings(image_height=hw[0], image_width=hw[1],
                            outputs=outputs)
        cams = Camera.stack([Camera.from_c2w(c, (fov, fov), hw,
                                             device=device)
                             for c in c2w_list])
        out = rasterize(g.get_xyz, g.get_opacity, g.get_scaling,
                        g.get_rotation, cams, shs=g.shs, valid=g.valid,
                        settings=st)
        img = torch.clamp(out["color"], 0, 1)
        img = (img * 255).to(torch.uint8).float() / 255.0
        return img.cpu().numpy(), out["depth"].cpu().numpy()

    inputs = {f: render(frames[f], c2ws[input_views], (in_res, in_res))[0]
              for f in range(period)}
    outputs = {f: render(frames[f], c2ws[vids], out_hw)[0]
               for f in range(period)}
    depth0 = render(frames[0], c2ws[input_views], out_hw, "color_depth")[1]
    depth0 = (np.clip(depth0 * 1000.0, 0, 65535).astype(np.uint16)
              / 1000.0).astype(np.float32)
    h8 = in_res // 8 * 2
    dirs = local_ray_directions(h8, h8, fov, fov)
    centers = c2ws[:, :3, 3]
    radius = np.float32(
        1.1 * np.linalg.norm(centers - centers.mean(0), axis=1).max())
    shared = {
        "c2w_output": c2ws[vids], "c2w_input": c2ws[input_views],
        "FOV": np.float32([fov, fov]),
        "background_color": np.zeros(3, np.float32),
        "resolution": np.int32(out_hw), "radius": radius,
        "bounding_box": np.float32(s["bbox"]), "depth": depth0,
        "local_rays": dirs, "rays": world_rays(dirs, c2ws[input_views]),
    }
    items = []
    for f in range(n_items):
        key = (f // interval) * interval
        items.append(dict(
            shared, cur_images_input=inputs[key % period],
            next_images_input=inputs[(f + 1) % period],
            images_output=outputs[(f + 1) % period],
            keyframe=1 if f % interval == 0 else 0, idx=f,
            frame=np.int64(f)))
    # each key frame refines on every camera but the eval one
    train_vids = [i for i in range(len(c2ws)) if i != eval_view]
    refine_frames = {k % period for k in range(interval, n_items + 1,
                                               interval)}
    views = {f: {"images": list(render(frames[f], c2ws[train_vids],
                                       out_hw)[0]),
                 "c2ws": list(c2ws[train_vids]),
                 "FOV": np.float32([fov, fov]),
                 "bg": np.zeros(3, np.float32)} for f in refine_frames}
    refine = {k: views[k % period]
              for k in range(interval, n_items + 1, interval)}
    start = frames[0]
    return Stream(items, {k: getattr(start, k) for k in
                          ("xyz", "opacity", "rotation", "scaling", "shs",
                           "valid")}, refine)


class Pairs:
    """Training items in memory, each a (key frame, next frame) pair, with
    the ``N3dDataset`` collate() layout: ``gs`` a list of each item's
    frame-0 Gaussians (as the items' PLYs load)."""

    def __init__(self, items: List[Dict], gaussians: List):
        self.items = items
        self.gaussians = gaussians

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def collate(self, items):
        batch = {k: np.stack([np.asarray(it[k]) for it in items])
                 for k in items[0] if k != "idx"}
        batch["idx"] = np.asarray([it["idx"] for it in items])
        batch["gs"] = [self.gaussians[it["idx"]] for it in items]
        return batch


@torch.no_grad()
def build_pairs(cfg: Dict, traffic: Dict, seed: int, device) -> Pairs:
    """``traffic["pairs"]`` training pairs (frame f → f + 1) of the moving
    scene, each with its key frame's Gaussians, images of every output
    view at both frames (the first ``input_views`` are the inputs) and
    depth of the input views at the key frame, rendered by the
    reference."""
    v = cfg["views"]
    fov = float(v["fov"])
    res = int(v["res"])
    hw = (res, res)
    c2ws = make_cameras(int(v["n_cams"]), float(v["rig_radius"]))
    views = list(v["output_views"])
    nin = int(v["num_input_views"])
    n_pairs = int(traffic["pairs"])
    frames = [frame_gaussians(cfg, traffic, seed, f, device)
              for f in range(n_pairs + 1)]

    def render(g, outputs="color"):
        st = RasterSettings(image_height=res, image_width=res,
                            outputs=outputs)
        cams = Camera.stack([Camera.from_c2w(c, (fov, fov), hw,
                                             device=device)
                             for c in c2ws[views]])
        out = rasterize(g.get_xyz, g.get_opacity, g.get_scaling,
                        g.get_rotation, cams, shs=g.shs, valid=g.valid,
                        settings=st)
        img = torch.clamp(out["color"], 0, 1)
        img = (img * 255).to(torch.uint8).float() / 255.0
        depth = np.clip(out["depth"][:nin].cpu().numpy() * 1000.0, 0, 65535)
        return img.cpu().numpy(), (depth.astype(np.uint16) / 1000.0
                                   ).astype(np.float32)

    rendered = [render(g, "color_depth") for g in frames]
    h8 = res // 8 * 2
    dirs = local_ray_directions(h8, h8, fov, fov)
    centers = c2ws[views][:, :3, 3]
    radius = np.float32(
        1.1 * np.linalg.norm(centers - centers.mean(0), axis=1).max())
    items = []
    for f in range(n_pairs):
        cur, nxt = rendered[f][0], rendered[f + 1][0]
        items.append({
            "cur_images_input": cur[:nin], "next_images_input": nxt[:nin],
            "images_output": nxt, "depth": rendered[f][1],
            "c2w_output": c2ws[views], "c2w_input": c2ws[views[:nin]],
            "FOV": np.float32([fov, fov]),
            "background_color": np.zeros(3, np.float32),
            "resolution": np.int32(hw), "radius": radius,
            "bounding_box": np.float32(cfg["scene"]["bbox"]),
            "local_rays": dirs, "rays": world_rays(dirs, c2ws[views[:nin]]),
            "idx": f})
    gaussians = [{k: getattr(g, k) for k in ("xyz", "opacity", "rotation",
                                             "scaling", "shs", "valid")}
                 for g in frames[:n_pairs]]
    return Pairs(items, gaussians)
