"""Streaming reconstruction driver (serving half) — the port's main path.

Counterpart of ``igs_tpu/stream/pipeline.py``: per window of B candidate
frames, select anchors, run the AGM-Net forward (eval render + depth-carry
renders), carry the deformed Gaussians and predicted depth, and keep the
PSNR bookkeeping and the results.json schema {psnr:{frame}, avg,
total_time, sec/frame, mask_num, points_num, fps, per_frame_times,
AGM_times, overflow_events}.

The key-frame refine (training inside the stream) waits for its backward
kernels: ``refine_gs=True`` raises NotImplementedError.

The dataset is any object with ``len``, item access and ``collate(items)``
returning the numpy batch layout of ``igs_tpu/data/infer_data.py``
(``collate``) with ``gs``: a list holding the start ``Gaussians``.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.ops.anchors import select_anchors
from igs_tpu_torch.ops.rasterize import (
    RasterSettings, build_pairs_packed, rasterize)
from igs_tpu_torch.utils.device import resolve_device


@dataclass
class StreamConfig:
    eval_batch_size: int = 5
    refine_gs: bool = True
    # depth-carry views render at this resolution; they only feed the
    # ModLN conditioning, which lives at input_res/8*2 = 128 for 512²
    # inputs
    depth_view_res: int = 128
    max_num: int = 150_000
    anchor_size: int = 8192
    neighbor_k: int = 8
    workspace: str = "logs/igs_tpu_torch/stream"
    save_images: bool = True
    # compute the key frame's CNN features once per window (every item of
    # a window shares cur_frame); verified on the first batch
    shared_cur_cnn: bool = True
    # Morton-bucket count of the FPS anchor stage (1 = exact greedy FPS)
    fps_buckets: int = 64
    # share candidate 0's eval-render pair list across the window; if more
    # than shared_pairs_drift_frac of the Gaussians drift over
    # shared_pairs_drift_px from candidate 0's binning, the window is
    # re-rendered with exact per-candidate pairs and the event is logged
    shared_window_pairs: bool = True
    shared_pairs_drift_px: float = 8.0
    shared_pairs_drift_frac: float = 0.01


class StreamingPipeline:
    def __init__(self, model: AGMNet, dataset, cfg: StreamConfig,
                 out_settings: RasterSettings, device=None):
        if cfg.refine_gs:
            raise NotImplementedError(
                "the key-frame refine is not ported yet; set refine_gs=False")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dataset = dataset
        self.cfg = cfg
        self.out_settings = out_settings
        # the eval render feeds only PSNR (color); the render-speed probe
        # renders color too
        self.agm_settings = out_settings._replace(outputs="color")
        self.refine_settings = out_settings._replace(outputs="color")
        self.depth_settings = None
        if cfg.depth_view_res:
            r = min(cfg.depth_view_res, out_settings.image_height,
                    out_settings.image_width)
            # ~4 contributions/pixel for the small depth-carry views
            dp = 1 << min(18, max(14, math.ceil(math.log2(r * r * 4))))
            self.depth_settings = self.agm_settings._replace(
                image_height=r, image_width=r, max_pairs=dp,
                outputs="color_depth")

    # ------------------------------------------------------------------
    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _camera(self, c2w, fov, height, width) -> Camera:
        return Camera.from_c2w(np.asarray(c2w, np.float32),
                               (float(fov[0]), float(fov[1])),
                               (height, width), device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _render_one(self, gaussians: Gaussians, camera: Camera, bg):
        out = rasterize(
            means3d=gaussians.get_xyz, opacity=gaussians.get_opacity,
            scaling=gaussians.get_scaling, rotation=gaussians.get_rotation,
            camera=camera, shs=gaussians.shs, bg=bg, valid=gaussians.valid,
            settings=self.refine_settings)
        return out["color"], out["depth"]

    def test_rendering_speed(self, gaussians: Gaussians, batch) -> float:
        """Render-only FPS over the output views."""
        s = self.out_settings
        fov = batch["FOV"][0]
        cams = [self._camera(batch["c2w_output"][0, i], fov, s.image_height,
                             s.image_width)
                for i in range(batch["c2w_output"].shape[1])]
        bg = self._tensor(batch["background_color"][0])
        self._render_one(gaussians, cams[0], bg)  # warmup
        self._sync()
        durations = []
        for _ in range(3):
            for cam in cams:
                t0 = time.time()
                self._render_one(gaussians, cam, bg)
                self._sync()
                durations.append(time.time() - t0)
        return 1.0 / float(np.mean(durations))

    @staticmethod
    def _frame0_budget(start_gs: Gaussians, settings: RasterSettings,
                       cam: Camera) -> tuple[int, int]:
        """(pairs, budget) of frame 0 under ``cam``'s views: the budget is
        the densest view's pairs ×1.5 headroom, next power of two, capped
        2^21; it is searched upwards in ×2 steps while a view overflows."""
        cap = 1 << 21
        s = settings

        def measure(setts):
            p = build_pairs_packed(
                start_gs.get_xyz, start_gs.get_opacity, start_gs.get_scaling,
                start_gs.get_rotation, cam, valid=start_gs.valid,
                settings=setts)
            return int(p.num_pairs.max()), bool(p.overflowed.any())

        n, over = measure(s)
        while over and s.max_pairs < cap:
            s = s._replace(max_pairs=min(cap, s.max_pairs * 2))
            n, over = measure(s)
        return n, 1 << min(21, max(1, math.ceil(math.log2(max(int(n * 1.5),
                                                              1)))))

    def _maybe_calibrate_budget(self, start_gs: Gaussians, batch) -> None:
        """Grow the eval and depth-carry pair budgets if frame 0 is denser
        than them; grow-only.

        The reference calibrates the eval budget only. Its depth-carry
        budget (~4 pairs per pixel, 2^16 per 128² view) is smaller than the
        visible Gaussian count of an N3DV-sized model (each Gaussian covers
        at least one tile), so the port calibrates it the same way.
        """
        fov = batch["FOV"][0]
        s = self.agm_settings
        cam = self._camera(batch["c2w_output"][0, 0], fov, s.image_height,
                           s.image_width)
        n, want = self._frame0_budget(start_gs, s, cam)
        if want > s.max_pairs:
            print(f"NOTE: pair budget calibrated {s.max_pairs} -> {want} "
                  f"(frame-0 measured {n} pairs)")
            self.agm_settings = s._replace(max_pairs=want)
            self.refine_settings = self.refine_settings._replace(
                max_pairs=want)
        d = self.depth_settings
        if d is None:
            return
        cams = Camera.stack([
            self._camera(c2w, fov, d.image_height, d.image_width)
            for c2w in batch["c2w_output"][0, 1:]])
        n, want = self._frame0_budget(start_gs, d, cams)
        if want > d.max_pairs:
            print(f"NOTE: depth-carry pair budget calibrated {d.max_pairs} "
                  f"-> {want} (frame-0 measured {n} pairs in the densest "
                  f"view)")
            self.depth_settings = d._replace(max_pairs=want)

    def _agm(self, jbatch, state, gaussians, shared_window_pairs: bool):
        return self.model(
            jbatch, state, gaussians, self.agm_settings,
            depth_settings=self.depth_settings,
            shared_cur=self.cfg.shared_cur_cnn,
            shared_window_pairs=shared_window_pairs,
            shared_pairs_drift_px=self.cfg.shared_pairs_drift_px)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def run(self, max_batches: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.cfg
        ds = self.dataset
        b = cfg.eval_batch_size
        os.makedirs(cfg.workspace, exist_ok=True)

        psnrs: List[float] = []
        mask_num: List[int] = []
        points_num: List[int] = []
        per_frame_times: List[float] = []
        agm_times: List[float] = []
        out_images: List[np.ndarray] = []
        overflow_events: List[Dict[str, Any]] = []
        fps = 0.0
        stream_gs = depth_pred = start_gs = depth = None

        total_start = time.time()
        n_batches = (len(ds) + b - 1) // b
        if max_batches is not None:
            n_batches = min(n_batches, max_batches)

        for idx in range(n_batches):
            items = [ds[i] for i in range(idx * b, min((idx + 1) * b, len(ds)))]
            batch = ds.collate(items)
            bsz = batch["cur_images_input"].shape[0]

            if idx == 0:
                start_gs = batch["gs"][0].to(self.device).pad_to(cfg.max_num)
                depth = self._tensor(batch["depth"])  # (B, V, H, W)
                self._maybe_calibrate_budget(start_gs, batch)
                fps = self.test_rendering_speed(start_gs, batch)
                if cfg.shared_cur_cnn and bsz > 1:
                    cur = np.asarray(batch["cur_images_input"])
                    if not all(np.array_equal(cur[0], cur[i])
                               for i in range(1, bsz)):
                        raise ValueError(
                            "shared_cur_cnn=True but cur_images_input "
                            "differs within the batch — set "
                            "stream.shared_cur_cnn=false for this pairing")
                if cfg.shared_window_pairs and bsz > 1:
                    c2w0 = np.asarray(batch["c2w_output"][:, 0])
                    fovs = np.asarray(batch["FOV"])
                    if not (np.allclose(c2w0, c2w0[0:1])
                            and np.allclose(fovs, fovs[0:1])):
                        raise ValueError(
                            "shared_window_pairs=True but the window's "
                            "candidates have different eval cameras "
                            "(c2w_output[:,0]/FOV) — set "
                            "stream.shared_window_pairs=false for this "
                            "dataset")
            else:
                depth = depth_pred.expand((bsz,) + depth_pred.shape[1:])
                if batch.get("keyframe") and batch["keyframe"][0] == 1:
                    start_gs = stream_gs

            t0 = time.time()
            state1 = select_anchors(
                start_gs.xyz, self._tensor(batch["bounding_box"][0]),
                valid=start_gs.valid, anchor_size=cfg.anchor_size,
                k=cfg.neighbor_k, fps_buckets=cfg.fps_buckets)
            # replicate anchors + Gaussians across the candidate batch
            state = type(state1)(*(x.expand((bsz,) + x.shape) for x in state1))
            gaussians = start_gs.map(lambda x: x.expand((bsz,) + x.shape))
            jbatch = {k: self._tensor(v) for k, v in batch.items()
                      if isinstance(v, np.ndarray)}
            jbatch["depth"] = depth
            out = self._agm(jbatch, state, gaussians, cfg.shared_window_pairs)
            drift = out.get("pair_drift_frac")
            if drift is not None:
                dmax = float(drift.max())
                if dmax > cfg.shared_pairs_drift_frac:
                    # the shared pair list went stale under fast motion:
                    # re-render with exact per-candidate binning
                    overflow_events.append({
                        "batch": idx, "where": "shared_pairs_stale",
                        "drift_frac": dmax})
                    print(f"WARNING: shared window pairs stale in batch "
                          f"{idx} (drift_frac {dmax:.4f} > "
                          f"{cfg.shared_pairs_drift_frac}) — re-rendering "
                          f"with exact per-candidate binning")
                    out = self._agm(jbatch, state, gaussians, False)
            self._sync()
            duration = time.time() - t0
            agm_times.append(duration)
            per_frame_times += [duration / bsz] * bsz

            ovf = int(out["overflow_tiles"].max())
            if ovf > 0:
                overflow_events.append({"batch": idx, "where": "agm",
                                        "count": ovf})
                print(f"WARNING: pair budget overflow in AGM renders "
                      f"(batch {idx}, code {ovf}) — raise max_pairs in "
                      f"RasterSettings")

            pred = np.clip(out["images_pred"][:, 0].cpu().numpy(), 0, 1)
            gt = np.asarray(batch["images_output"][:, 0])
            mse = ((pred - gt) ** 2).mean(axis=(1, 2, 3))
            psnrs += (-10 * np.log10(mse)).tolist()
            out_images.extend(list(pred))

            # carry: depth at the input views of the LAST candidate
            if self.depth_settings is not None:
                depth_pred = out["depth_pred"][-1:]
            else:
                depth_pred = out["depth_pred"][-1:, 1:]
            stream_gs = out["3dgs"].map(lambda x: x[-1])
            mask_num.append(int(stream_gs.mask.sum()))
            points_num.append(int(stream_gs.num_valid))

        total_time = time.time() - total_start
        results = {
            "psnr": {f"frame_{i}": p for i, p in enumerate(psnrs)},
            "avg": float(np.mean(psnrs)) if psnrs else 0.0,
            "total_time": total_time,
            "sec/frame": total_time / max(len(psnrs), 1),
            "mask_num": mask_num,
            "points_num": points_num,
            "fps": fps,
            "per_frame_times": per_frame_times,
            "AGM_times": agm_times,
            "overflow_events": overflow_events,
        }
        with open(os.path.join(cfg.workspace, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        if cfg.save_images:
            from PIL import Image

            img_dir = os.path.join(cfg.workspace, "eval_pred")
            os.makedirs(img_dir, exist_ok=True)
            for i, img in enumerate(out_images):
                arr = (img.transpose(1, 2, 0) * 255).astype(np.uint8)
                Image.fromarray(arr).save(os.path.join(img_dir, f"{i:05d}.png"))
        return results
