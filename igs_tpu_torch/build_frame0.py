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
        [--device cuda|cpu] [--spmd [--backend nccl|gloo] [--share-card]]
        [--workers N [--devices 0,1,...]]

A frame directory holds ``cameras.json``, ``<images>/<img_name>.png`` and
optionally ``points3D.npz`` (``xyz``, ``rgb``); without it the init is
20 000 random points in the cameras' bounding box. Runs on the card unless
``--device cpu``.

``--spmd`` trains every frame on one schedule with the frames split over
ranks (``train_frames_spmd``, ``train_one_frame`` on each of a rank's
frames under the JAX sweep's view orders): torchrun's
group, or else ranks it spawns, one per card (``--workers`` of them when
above 1; ``--backend gloo --share-card`` puts them on one card). The
frame count must divide by the ranks, or fewer ranks are taken, as in
the JAX sweep. ``--workers N`` without ``--spmd`` is the reference's job
pool: one subprocess a frame, N at a time, each on the card of
``--devices`` it takes (``CUDA_VISIBLE_DEVICES``); it exits non-zero
naming the frames whose job failed (ROADMAP C31).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from multiprocessing.pool import ThreadPool
from queue import Queue
from typing import List, Optional, Sequence

import numpy as np
import torch

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.data.dataset import camera_from_json
from igs_tpu_torch.data.images import load_images_nchw
from igs_tpu_torch.data.ply import save_gaussian_ply
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.parallel import distributed as D
from igs_tpu_torch.parallel.launch import run_ranked
from igs_tpu_torch.stream.refine import init_refine_state
from igs_tpu_torch.train.frame0 import (
    Frame0Config, compute_3d_filter, create_from_points,
    frame0_densify_and_prune, frame0_step, fused_render_args,
    lightgaussian_importance, position_lr, prune_by_importance,
    reset_opacity, views)
from igs_tpu_torch.utils.cache import enable_persistent_cache
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.profiling import kernel_launches
from igs_tpu_torch.utils.saving import save_depth_mm, save_image


def _cameras_json(frame_dir: str) -> list:
    """The frame's cameras.json: colmap-converted scenes keep it at the
    frame root; a re-build over an existing gs_mode export finds it one
    level down."""
    path = os.path.join(frame_dir, "cameras.json")
    if not os.path.exists(path):
        hits = sorted(glob.glob(os.path.join(frame_dir, "*", "cameras.json")))
        if not hits:
            raise FileNotFoundError(
                f"no cameras.json under {frame_dir} (or its gs_mode dirs)")
        path = hits[0]
    with open(path) as f:
        return json.load(f)


def _load_frame(frame_dir: str, images_dir: str, seed: int = 0, device=None):
    """(cameras_json, stacked cameras, images (V, 3, H, W), init points,
    init colours)."""
    dev = resolve_device(device)
    cameras_json = _cameras_json(frame_dir)
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
                    device=None, max_pairs: int = 1 << 21,
                    view_order: Optional[Sequence[int]] = None,
                    cfg: Optional[Frame0Config] = None) -> dict:
    """Train, compress, fine-tune and export one frame.

    The JAX package's sequential path runs 1000 fine-tune steps whatever
    ``--finetune-iters`` says; here the flag is passed through, and its
    default gives the JAX result. ``max_pairs`` is the per-view pair
    budget of every render (the JAX package's 2^21). ``view_order``: the
    view of each training step then of each fine-tune step (default: the
    sequential build's permutations, popped from their ends). ``cfg``:
    the schedule (default: ``Frame0Config(iterations=iterations)``). Returns a
    record of the run: losses, densify events, live Gaussians after each
    stage, seconds per stage, device ms per step (on the card), the final
    state and filter.
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
    cfg = cfg or Frame0Config(iterations=iterations)
    settings = RasterSettings(image_height=h, image_width=w,
                              max_pairs=max_pairs)
    bg = torch.zeros(3, device=dev)
    spatial = float(np.linalg.norm(
        np.array([c["position"] for c in cameras_json]).std(0)) + 1.0)
    filt = compute_3d_filter(state.gaussians.xyz, state.gaussians.valid, cams)
    record = {"n_init": int(state.gaussians.num_valid), "densify": []}
    clock.stop("init")

    order = []
    given = iter(view_order) if view_order is not None else None

    def next_view():
        if given is not None:
            return int(next(given))
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


def sweep_view_orders(rng: np.random.RandomState, frames: int, views: int,
                      iters: int) -> List[List[int]]:
    """Each frame's view per step: permutations of the views from ``rng``,
    one after another, frame after frame (the JAX sweep's ``orders``)."""
    out = []
    for _ in range(frames):
        order: List[int] = []
        while len(order) < iters:
            order.extend(rng.permutation(views).tolist())
        out.append(order[:iters])
    return out


def _ranks_for(frames: int, wanted: int) -> int:
    """The most ranks, at most ``wanted`` and ``frames``, that divide the
    frames (the JAX sweep's device count)."""
    n = max(1, min(wanted, frames))
    while frames % n:
        n -= 1
    return n


def train_frames_spmd(frame_dirs: Sequence[str], images_dir: str,
                      out_mode: str, iterations: int, prune_percent: float,
                      capacity: int, n_devices: int = 0, seed: int = 0,
                      finetune_iters: int = 1000, device=None,
                      max_pairs: int = 1 << 21, backend: Optional[str] = None,
                      share_card: bool = False,
                      cfg: Optional[Frame0Config] = None) -> List[dict]:
    """Train, compress, fine-tune and export F frames on one schedule, the
    frames split over ranks: ``n_devices`` of them
    (default: one per card present, one on the CPU), fewer when they do
    not divide F (the JAX sweep's rule). Every frame's view orders come
    from one ``RandomState(seed)``, training then fine-tune, frame after
    frame, as in the JAX sweep, whatever the rank count; ``cfg`` is the
    schedule, as ``train_one_frame``'s. Returns every frame's record, in
    frame order (on every rank)."""
    if not n_devices:
        dev = torch.device(device or "cuda")
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    ranks = _ranks_for(len(frame_dirs), n_devices)
    return run_ranked(
        _sweep_rank, ranks,
        (list(frame_dirs), images_dir, out_mode, iterations, prune_percent,
         capacity, seed, finetune_iters, max_pairs, cfg),
        device=None if device is None else str(device), backend=backend,
        share_card=share_card)


def _sweep_rank(rank: int, device, frame_dirs: List[str], images_dir: str,
                out_mode: str, iterations: int, prune_percent: float,
                capacity: int, seed: int, finetune_iters: int,
                max_pairs: int, cfg: Optional[Frame0Config]) -> List[dict]:
    """``train_frames_spmd`` on this rank (or alone): ``train_one_frame``
    on each of the rank's frames under the frame's sweep view order. The
    records leave out the frames' tensors."""
    f_count = len(frame_dirs)
    nsh = _ranks_for(f_count, D.process_count())
    per, me = f_count // nsh, D.process_index()
    mine = range(me * per, (me + 1) * per) if me < nsh else range(0)
    n_views = len(_cameras_json(frame_dirs[0]))
    rng = np.random.RandomState(seed)
    orders = sweep_view_orders(rng, f_count, n_views, iterations)
    ft_orders = sweep_view_orders(rng, f_count, n_views, finetune_iters)
    t0 = time.perf_counter()
    records = []
    for f in mine:
        rec = train_one_frame(
            frame_dirs[f], images_dir, out_mode, iterations, prune_percent,
            capacity, seed=seed, finetune_iters=finetune_iters,
            device=device, max_pairs=max_pairs,
            view_order=orders[f] + ft_orders[f], cfg=cfg)
        records.append({k: v for k, v in rec.items() if k not in (
            "state", "filter", "cameras", "images")})
        records[-1].update(frame_dir=frame_dirs[f], rank=me,
                           view_order=orders[f] + ft_orders[f],
                           # this rank's launches so far, all its frames'
                           rank_launches=kernel_launches())
    print(f"sweep: {f_count} frames × {iterations} iters on {nsh} rank(s), "
          f"this rank's {len(mine)} in {time.perf_counter() - t0:.0f}s")
    if D.process_count() > 1:
        every = [None] * D.process_count()
        torch.distributed.all_gather_object(every, records)
        records = [r for part in every for r in part]
    return sorted(records, key=lambda r: frame_dirs.index(r["frame_dir"]))


def run_worker_pool(frames, args) -> None:
    """The reference's job pool (build_3dgs_dataset.py:43-56): one
    subprocess a frame, as many at a time as ``args.devices`` lists cards
    (default 0 … workers−1), each with ``CUDA_VISIBLE_DEVICES`` set to the
    card it takes. Every flag of the sequential build is passed on,
    ``--finetune-iters`` too. Exits non-zero naming the frames whose job
    failed (the JAX pool ignores them, ROADMAP C31)."""
    devices = (args.devices.split(",") if args.devices
               else [str(i) for i in range(args.workers)])
    free: Queue = Queue()
    for d in devices:
        free.put(d)

    def run_frame(job):
        scene, f = job
        dev = free.get()
        try:
            cmd = [sys.executable, "-m", "igs_tpu_torch.build_frame0",
                   "--scene", scene, "--images", args.images,
                   "--gs-mode", args.gs_mode,
                   "--iterations", str(args.iterations),
                   "--prune-percent", str(args.prune_percent),
                   "--finetune-iters", str(args.finetune_iters),
                   "--capacity", str(args.capacity), "--frames", str(f)]
            if args.device:
                cmd += ["--device", args.device]
            print(f"[card {dev}] {scene} frame {f}", flush=True)
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=dev)
            return subprocess.run(cmd, env=env).returncode
        finally:
            free.put(dev)

    with ThreadPool(len(devices)) as pool:
        codes = pool.map(run_frame, frames)
    failed = [f"{scene} frame {f} (exit {c})"
              for (scene, f), c in zip(frames, codes) if c]
    if failed:
        raise SystemExit(f"build_frame0: {len(failed)} of {len(frames)} "
                         f"frame jobs failed: {'; '.join(failed)}")


def main(argv=None):
    enable_persistent_cache()
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
                    help="parallel frame jobs, one per card; with --spmd "
                         "the ranks of the sweep")
    ap.add_argument("--devices", default=None,
                    help="comma-separated card ids of the worker pool "
                         "(default 0..workers-1; a card may repeat), set "
                         "per job through CUDA_VISIBLE_DEVICES")
    ap.add_argument("--spmd", action="store_true",
                    help="train every frame on one schedule, the frames "
                         "split over ranks (train_frames_spmd)")
    ap.add_argument("--backend", default=None, choices=D.BACKENDS,
                    help="process-group backend of --spmd (default: nccl)")
    ap.add_argument("--share-card", action="store_true",
                    help="--spmd: every rank on the one card --device "
                         "names (needs --backend gloo)")
    ap.add_argument("--manifest", default=None,
                    help="json list of scene dirs (multi-scene sweep); "
                         "overrides --scene. Each entry is swept over its "
                         "colmap_<f> frames (or --frames)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

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

    frames = [(scene, f) for scene in scenes for f in frames_of(scene)]
    if args.spmd:
        train_frames_spmd(
            [os.path.join(scene, f"colmap_{f}") for scene, f in frames],
            args.images, args.gs_mode, args.iterations, args.prune_percent,
            args.capacity, n_devices=args.workers if args.workers > 1 else 0,
            finetune_iters=args.finetune_iters, device=args.device,
            backend=args.backend, share_card=args.share_card)
        return
    if args.workers > 1:
        run_worker_pool(frames, args)
        return
    for scene, f in frames:
        print(f"=== {scene} frame {f} ===")
        train_one_frame(
            os.path.join(scene, f"colmap_{f}"), args.images, args.gs_mode,
            args.iterations, args.prune_percent, args.capacity,
            finetune_iters=args.finetune_iters, device=args.device)


if __name__ == "__main__":
    main()
