"""Frame-0 build: 3DGS training → LightGaussian compression → export.

Counterpart of the sequential path of ``build_frame0.py`` (the reference's
RaDe-GS ``train.sh``: train.py → compress.py → render.py, SURVEY.md §3.5).
For each frame it writes what the AGM datasets read:
  <frame>/<gs_mode>/point_cloud/iteration_<it>_compress/point_cloud.ply
  <frame>/<gs_mode>/train/ours_<it>_compress/{gt,depth_expected_mm}/*.png
  <frame>/<gs_mode>/cameras.json

Usage:
    python -m igs_tpu_torch.build_frame0 --scene <dir> [--images images_512]
        [--iterations 6000] [--prune-percent 0.45] [--finetune-iters 1000]
        [--capacity 200000] [--frames 0 1 ...] [--manifest scenes.json]
        [--device cuda|cpu]

A frame directory holds ``cameras.json``, ``<images>/<img_name>.png`` and
optionally ``points3D.npz`` (``xyz``, ``rgb``); without it the init is
20 000 random points in the cameras' bounding box. Runs on the card unless
``--device cpu``. The lockstep sweep (``--spmd``) and the worker pool
(``--workers > 1``) are not ported (ROADMAP A5).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.data.dataset import camera_from_json
from igs_tpu_torch.data.images import load_images_nchw
from igs_tpu_torch.data.ply import save_gaussian_ply
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.stream.refine import init_refine_state
from igs_tpu_torch.train.frame0 import (
    Frame0Config, compute_3d_filter, create_from_points,
    frame0_densify_and_prune, frame0_step, fused_render_args,
    lightgaussian_importance, position_lr, prune_by_importance,
    reset_opacity, views)
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.saving import save_depth_mm, save_image


def _load_frame(frame_dir: str, images_dir: str, seed: int = 0, device=None):
    """(cameras_json, stacked cameras, images (V, 3, H, W), init points,
    init colours)."""
    dev = resolve_device(device)
    cam_path = os.path.join(frame_dir, "cameras.json")
    if not os.path.exists(cam_path):
        # colmap-converted scenes keep cameras.json at the frame root; a
        # re-build over an existing gs_mode export finds it one level down
        hits = sorted(glob.glob(os.path.join(frame_dir, "*", "cameras.json")))
        if not hits:
            raise FileNotFoundError(
                f"no cameras.json under {frame_dir} (or its gs_mode dirs)")
        cam_path = hits[0]
    with open(cam_path) as f:
        cameras_json = json.load(f)
    h, w = cameras_json[0]["height"], cameras_json[0]["width"]
    images = load_images_nchw(
        [os.path.join(frame_dir, images_dir, c["img_name"] + ".png")
         for c in cameras_json], h, w)
    cams = []
    for c in cameras_json:
        c2w, fovx, fovy = camera_from_json(c)
        cams.append(Camera.from_c2w(c2w, (fovx, fovy), (h, w), device=dev))

    pts_path = os.path.join(frame_dir, "points3D.npz")
    rng = np.random.RandomState(seed)
    if os.path.exists(pts_path):
        blob = np.load(pts_path)
        pts, cols = blob["xyz"], blob.get("rgb", None)
        if cols is None:
            cols = rng.uniform(0, 1, (len(pts), 3))
        elif cols.max() > 1.5:
            cols = cols / 255.0
    else:
        centers = np.array([c["position"] for c in cameras_json])
        lo, hi = centers.min(0) - 1, centers.max(0) + 1
        pts = rng.uniform(lo, hi, (20000, 3)).astype(np.float32)
        cols = rng.uniform(0, 1, (20000, 3)).astype(np.float32)
    return (cameras_json, Camera.stack(cams), torch.from_numpy(images).to(dev),
            pts, cols)


def export_frame_artifacts(frame_dir, out_mode, iterations, g, filt, cams,
                           cameras_json, settings) -> dict:
    """Write the RaDe-GS artifact layout the AGM datasets read
    (train.sh / compress.py:34-64): the PLY of the live rows, cameras.json,
    and per view the full render's color and depth (uint16 mm). Returns
    the paths and the largest overflow code of the renders."""
    it_name = f"{iterations}_compress"
    mode_dir = os.path.join(frame_dir, out_mode)
    ply_dir = os.path.join(mode_dir, "point_cloud", f"iteration_{it_name}")
    os.makedirs(ply_dir, exist_ok=True)
    ply = os.path.join(ply_dir, "point_cloud.ply")
    save_gaussian_ply(ply, g)
    with open(os.path.join(mode_dir, "cameras.json"), "w") as f:
        json.dump(cameras_json, f)
    train_dir = os.path.join(mode_dir, "train", f"ours_{it_name}")
    scales, opacity = fused_render_args(g, filt)
    bg = torch.zeros(3, device=g.xyz.device)
    overflow = 0
    with torch.no_grad():
        for i, cam in enumerate(views(cams)):
            out = rasterize(
                means3d=g.xyz, opacity=opacity, scaling=scales,
                rotation=g.get_rotation, camera=cam, shs=g.shs, bg=bg,
                valid=g.valid, settings=settings)
            overflow = max(overflow, int(out["overflow_tiles"]))
            save_image(os.path.join(train_dir, "gt", f"{i:05d}.png"),
                       out["color"].cpu().numpy())
            # depth file i = camera i
            save_depth_mm(
                os.path.join(train_dir, "depth_expected_mm", f"{i:05d}.png"),
                out["depth"].cpu().numpy())
    print(f"frame done: {int(g.num_valid)} gaussians → {mode_dir}")
    return {"dir": mode_dir, "ply": ply, "train_dir": train_dir,
            "overflow": overflow}


class _StageClock:
    """Host seconds per stage (synchronised with the card), and device ms
    of the training loops from CUDA events."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.seconds = {}
        self.ms = {}

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        self._sync()
        self.t0 = time.perf_counter()
        if self.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()

    def stop(self, name: str, steps: int = 0):
        if self.cuda and steps:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            ev1.synchronize()
            self.ms[name] = self.ev0.elapsed_time(ev1) / steps
        self._sync()
        self.seconds[name] = time.perf_counter() - self.t0


def train_one_frame(frame_dir: str, images_dir: str, out_mode: str,
                    iterations: int, prune_percent: float, capacity: int,
                    seed: int = 0, finetune_iters: int = 1000,
                    device=None, max_pairs: int = 1 << 21) -> dict:
    """Train, compress, fine-tune and export one frame.

    The JAX package's sequential path runs 1000 fine-tune steps whatever
    ``--finetune-iters`` says; here the flag is passed through, and its
    default gives the JAX result. ``max_pairs`` is the per-view pair
    budget of every render (the JAX package's 2^21). Returns a record of
    the run: losses, densify events, live Gaussians after each stage,
    seconds per stage, device ms per step (on the card), the final state
    and filter.
    """
    dev = resolve_device(device)
    clock = _StageClock(dev)
    clock.start()
    cameras_json, cams, images, pts, cols = _load_frame(
        frame_dir, images_dir, seed, dev)
    h, w = images.shape[-2:]
    n_views = len(cameras_json)
    rng = np.random.RandomState(seed)
    g = create_from_points(pts, cols, capacity, device=dev)
    state = init_refine_state(g, capacity)
    cfg = Frame0Config(iterations=iterations)
    settings = RasterSettings(image_height=h, image_width=w,
                              max_pairs=max_pairs)
    bg = torch.zeros(3, device=dev)
    spatial = float(np.linalg.norm(
        np.array([c["position"] for c in cameras_json]).std(0)) + 1.0)
    filt = compute_3d_filter(state.gaussians.xyz, state.gaussians.valid, cams)
    record = {"n_init": int(state.gaussians.num_valid), "densify": []}
    clock.stop("init")

    order = []

    def next_view():
        if not order:
            order.extend(rng.permutation(n_views))
        return int(order.pop())

    losses = []
    clock.start()
    t0 = time.time()
    for it in range(1, iterations + 1):
        vi = next_view()
        state, loss = frame0_step(state, cams.view(vi), images[vi], bg, filt,
                                  cfg, settings, position_lr(it, cfg, spatial),
                                  reg_on=False)
        losses.append(loss)
        if (cfg.densify_from_iter < it < cfg.densify_until_iter
                and it % cfg.densification_interval == 0):
            size_thr = 20.0 if it > cfg.opacity_reset_interval else None
            before = int(state.gaussians.num_valid)
            state = frame0_densify_and_prune(state, cfg, spatial, size_thr)
            filt = compute_3d_filter(state.gaussians.xyz,
                                     state.gaussians.valid, cams)
            record["densify"].append({
                "step": it, "live_before": before,
                "live_after": int(state.gaussians.num_valid)})
        if it % cfg.opacity_reset_interval == 0:
            state = reset_opacity(state)
        if it % 500 == 0:
            print(f"  iter {it}: loss {float(loss):.4f} "
                  f"n {int(state.gaussians.num_valid)} "
                  f"({time.time() - t0:.0f}s)")
    clock.stop("train", iterations)
    overflow = int(state.overflow)
    record["n_after_train"] = int(state.gaussians.num_valid)

    # LightGaussian prune + short fine-tune (compress.py:66-100); the
    # fine-tune keeps the last filter, as the JAX package does
    clock.start()
    g = state.gaussians
    scores = lightgaussian_importance(g, filt, cams, settings)
    g = prune_by_importance(g, scores, prune_percent)
    record["n_after_prune"] = int(g.num_valid)
    clock.stop("importance")
    clock.start()
    state = init_refine_state(g, capacity)
    ft_losses = []
    for it in range(1, finetune_iters + 1):
        vi = next_view()
        state, loss = frame0_step(
            state, cams.view(vi), images[vi], bg, filt, cfg, settings,
            position_lr(iterations + it, cfg, spatial), reg_on=False)
        ft_losses.append(loss)
    clock.stop("finetune", finetune_iters)
    overflow = max(overflow, int(state.overflow))

    clock.start()
    exported = export_frame_artifacts(
        frame_dir, out_mode, iterations, state.gaussians, filt, cams,
        cameras_json, settings)
    clock.stop("export")
    record.update(
        losses=[float(x) for x in losses],
        finetune_losses=[float(x) for x in ft_losses],
        n_final=int(state.gaussians.num_valid),
        overflow=max(overflow, exported["overflow"]),
        seconds=clock.seconds, ms_per_step=clock.ms, export=exported,
        state=state, filter=filt, cameras=cams, images=images,
        settings=settings, cfg=cfg, spatial=spatial)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", required=True, help="scene dir with colmap_<f>")
    ap.add_argument("--images", default="images_512")
    ap.add_argument("--gs-mode", default="3dgs_rade")
    ap.add_argument("--iterations", type=int, default=6000)
    ap.add_argument("--prune-percent", type=float, default=0.45)
    ap.add_argument("--finetune-iters", type=int, default=1000,
                    help="post-prune finetune iterations "
                         "(compress.py:66-100 runs 1000-5000)")
    ap.add_argument("--capacity", type=int, default=200_000)
    ap.add_argument("--frames", type=int, nargs="*", default=None)
    ap.add_argument("--workers", type=int, default=1,
                    help="parallel frame jobs, one per card (not ported)")
    ap.add_argument("--devices", default=None,
                    help="card ids of the worker pool (not ported)")
    ap.add_argument("--spmd", action="store_true",
                    help="train all frames in lockstep (not ported)")
    ap.add_argument("--manifest", default=None,
                    help="json list of scene dirs (multi-scene sweep); "
                         "overrides --scene. Each entry is swept over its "
                         "colmap_<f> frames (or --frames)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.spmd or args.workers > 1:
        raise NotImplementedError(
            "--spmd and --workers > 1 are not ported yet (ROADMAP A5)")

    scenes = [args.scene]
    if args.manifest:
        with open(args.manifest) as f:
            scenes = json.load(f)
        if not isinstance(scenes, list) or not scenes:
            raise ValueError("manifest: a non-empty json list of scene dirs")

    def frames_of(scene):
        if args.frames is not None:
            return args.frames
        return sorted(int(d.split("_")[1]) for d in os.listdir(scene)
                      if d.startswith("colmap_"))

    for scene in scenes:
        for f in frames_of(scene):
            print(f"=== {scene} frame {f} ===")
            train_one_frame(
                os.path.join(scene, f"colmap_{f}"), args.images, args.gs_mode,
                args.iterations, args.prune_percent, args.capacity,
                finetune_iters=args.finetune_iters, device=args.device)


if __name__ == "__main__":
    main()
