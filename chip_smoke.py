"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. card and settings: name and power limit, TF32 off for matmuls and
     cuDNN convolutions (the float32 paths stay float32; the bf16 flags
     and mixed precision compute in bf16 where they say);
  2. build every kernel of the main paths from ``igs_tpu_torch/csrc``
     (blend_fwd.cu, blend_bwd.cu, segscan.cu, segscan_fold.cu: one nvcc
     per source, started together; blend_fwd.cu holds the packed and the
     windowed forward and the contribution count, blend_bwd.cu the packed
     and the windowed backward), with ptxas registers and spills per
     source;
  3. a synthetic N3DV-shaped stream made in memory from a seed: the scene
     recipe of ``igs_tpu/data/synthetic.py`` with the sparse ranges of
     ``configs/synthetic_fullshape.yaml`` (512² inputs, 1014×1352 outputs,
     120 000 Gaussians padded to 150 000); ground truth and frame-0 depth
     come from the port's own rasterizer. The config's log-scale range
     (-4.6, -3.4) was sized for 50 000 Gaussians: at 120 000 the eval view
     needs 2.18M tile pairs, past the pipeline's 2^21 cap, so the range
     shifts to (-5.0, -3.8), which keeps the eval view at ~1.2M pairs.
     The scene has no static shell (``static_frac`` 0): with the recipe's
     shell of 30 %, the refine's densify picks the shell's Gaussians in
     front of the moving core (98 % of its selection) and splits them, and
     the loss rises ~8x in the JAX package as in the port (PERF.md,
     Findings, PR 2), so the refine could not be judged there;
     The key frames 5 and 10 carry refine data: their 13 non-eval views
     (the n3d view table) at 1014×1352. A frame-0 directory is written as
     ``build_frame0`` reads it: ``cameras.json`` of 20 views at 512² (an
     N3DV rig of 21 cameras, one held out), their images rendered by the
     port from the same recipe moved to z ≈ 6 (the N3D z-cull drops
     Gaussians below z = 4.5), and ``points3D.npz``, 40 000 noisy means
     with their colours standing in for the sparse cloud;
  4. kernel vs plain, forward: the packed blend kernel against its plain
     PyTorch version, color / color_depth / full, at the eval shape (64×85
     tiles) and the 128² depth-carry shape (four views in one launch), and
     color / full on one 512² view of the frame-0 scene (the shape of
     frame 0's steps and regulariser); each timed eagerly on one warm
     input (``cuda_ms``) and on a rotation of copies cold in L2, eager and
     replayed from a CUDA graph (``devtime.rotation_ms``);
  5. kernel vs plain, backward: the blend backward kernel against its
     plain version on the same forward and a seeded cotangent, at the same
     shapes and modes, timed the same ways; the segmented scan against
     its plain version on the eval view's expansion ids, on 2^21
     seeded rows of synthetic runs and on the five edge cases of
     ``data/scan_ids.scan_edge_ids`` (a run over many tiles, runs ending
     on tile edges, singletons, a ragged row count, a leading pad run),
     16 and 32 lanes, with ``index_add_`` as the library yardstick; both
     kernels launched twice for bit equality; the bounds count the
     pixel-pairs the forward accepted. The contribution-count kernel
     against its plain version at the eval shape (partial tiles) and on
     one 512² frame-0 view: bit-repeatable, its total equal to the
     forward kernel's accepted pixel-pairs inside the image, and the
     per-Gaussian counts equal to the plain version's up to threshold
     flips on at most 1e-4 of the pixels. The windowed forward and
     backward kernels (both reading the pair features in place) against
     their plain versions in all three modes on a 512² view of the
     stream's scene, at a window of 1024 rows (tiles truncate) and of
     8192 (none does), each launched twice for bit equality and timed
     alone and as the autograd forward or backward, and the windowed
     forward's raw (bit-equal in every lane both write) and backward's
     grads against the packed ones where nothing truncates. The segscan
     layout probes (B6: folded, padded, staged reshape) on the (2^19, 16)
     float32 input of
     ``tools/tools_bench_segscan_fold.py``, each bit-equal to its plain
     version and to ``torch.mul(x, 2.0)``, timed beside both and the
     bytes bound: 200 eager launches on that input, then on a rotation of
     four seeded inputs cold in L2, in seven interleaved rounds, eager and
     replayed from a CUDA graph (the kernels line carries the replayed
     medians); it fails if any reading passes 1.05 of the bound;
  6. the main path: ``build_model`` on the ``system`` section and
     ``build_stream_configs`` on the ``opt`` section of
     ``configs/synthetic_fullshape.yaml`` (random weights from a seeded
     generator), and two streaming windows of B=5 through the port's
     ``StreamingPipeline`` with the key-frame refine (50 Adam steps at
     1014×1352 per key frame, densify every 20), launch counters reset
     just before; each refine must lower the loss (the mean of its last
     five steps under that of its first five) and must not lower the
     re-rendered eval PSNR;
  7. the first window again with the blend routed to the plain version,
     images compared with the kernel run;
  8. five steps of the first key frame's refine with the kernels and
     again with all three plain versions, losses and the eval render
     compared;
  9. the frame-0 build through ``build_frame0.train_one_frame`` at the
     CLI's width (512², capacity 200 000, Frame0Config defaults, prune
     45 %) with 700 training steps (densify at 600 and 700) and a 100-step
     fine-tune, launch counters reset just before: it must lower the loss
     (last 50 steps under the first 50), raise the views' PSNR of the
     exported renders over the initial Gaussians', prune to the count
     ``prune_by_importance`` implies, launch the count kernel once per
     view and the blend and scan on every step, never overflow, export 20
     color and depth PNGs, cameras.json and a PLY that reads back bit for
     bit;
 10. five steps with the depth-normal regulariser (full renders, the
     backward's full mode) from the fine-tuned state, with the kernels and
     with all plain versions, losses compared;
 11. training through ``train_agm.run`` (the CLI's function) on the
     ``system`` and ``opt`` sections of ``configs/synthetic_train_256.yaml``
     (128 channels, Plücker conditioning, the backbone trained, batch 2,
     4 input and 6 output views, λ_ssim 0.2) at N3DV widths: a 512² scene
     of 11 frames written by the port's ``build_synthetic_scene`` from the
     stream's 120 000-Gaussian recipe, 8192 anchors. The windowed route
     takes the smallest power-of-two window (at least 512) that holds the
     densest tile of the key frames' output views. 30 steps with the
     kernels (counters reset just before), per step the metrics, ms by
     stage (CUDA events) and the launches; it fails unless both windowed
     kernels launched in full mode, every loss is finite, no tile
     truncated and no window was gathered on the card (the step's window
     gathers are logged); the last step also runs under
     ``torch.profiler``. Then the
     first 3 steps from the same seeded state through the packed route
     and through the windowed plain versions: the first step's loss must
     agree to 1e-5 relative across the three routes. Between the two, the
     first 3 steps from the same seeded state with ``opt.mixed_precision:
     bf16`` (the windowed kernels; counted to the training path): every
     loss finite, the first within 1e-2 relative of the float32 one, ms by
     stage and the peak memory logged beside the float32 steps'. The
     trained model and optimizer are then written in the JAX package's
     layout (``params.msgpack`` and its ``.opt``, through
     ``utils/flax_msgpack.dumps``) and as the port's ``.pth``: the flax
     files must read back bit for bit, and one step resumed from each
     through ``train_agm.run`` must give the same loss. Last, AGM-Net with
     ``renderer.render_flow`` (the flow at 1024×1352) on a training batch
     of two items and six output views, the residual heads drawn small:
     one forward through the windowed route (its flow renders on the
     windowed forward kernel, color mode) and one through the packed route
     (on the packed forward kernel), counters reset just before each and
     read just after (the "flow" path); each forward timed with and
     without the flow render and rerun with the route's plain version:
     one flow launch per view, and flow_mask within 2e-4 and flow_pred
     within 2e-4·(1 + |flow|) (the flow is in pixels) on all but at most
     1e-4 of the pixels. Between the flax files and the reruns,
     LPIPS_STEPS steps with the LPIPS term (``opt.lambda_lpips`` 0.2,
     ``opt.lpips_weights`` a seeded LPIPS ``state_dict`` the port wrote
     under lpipsPyTorch's names) at the phase's width (512², batch 2, six
     output views: twelve LPIPS images at 256²) on the windowed kernels,
     counters reset just before and read just after (the "lpips" path):
     the run must print ``loaded 18 LPIPS tensors``, every ``loss_lpips``
     must be finite and > 0, the LPIPS forward and backward ms inside the
     step and the peak memory are logged beside the steps without it;
     then the LPIPS on the card against the port's CPU LPIPS on the same
     256² batch and weights, to 1e-4 relative;
 12. one AGM-Net forward timed by top-level module and one under
     ``torch.profiler``; one refine step timed by stage (CUDA events) and
     one under ``torch.profiler``; the blend kernels' share of that step
     logged beside frame 0's ms a step and the AGM forward's ms;
 13. the measurement path: ``python -m igs_tpu_torch.tools.
     bench_segscan_fold``, ``…tools.bench_segscan_kernel``, ``…bench``,
     ``…roofline`` (its default: the bf16 flags on) and ``…roofline
     --f32``, ``…profile_stages`` and ``…profile_stages --cnn-bf16``, each
     a subprocess at the JAX programs' sizes whose output is logged here
     (and roofline's ``agm_forward_s`` and ``stream_fps`` bf16 beside
     float32); each must exit 0 and print its results (finite, the
     expected keys), and the repo-root ``roofline.json`` (the TPU's
     numbers) must be unchanged. Each program starts with its counters at
     0 and prints its kernels' launches; they are this path's launches;
 14. the streaming CLI at full width: the port's ``build_synthetic_scene``
     writes an on-disk N3DV-layout scene from the stream's recipe (120 000
     Gaussians padded to 150 000, 512² inputs, 1014×1352 outputs, the n3d
     view table, 11 frames: two windows of B=5, key frames 5 and 10 with
     13 refine views each), a seeded port model is written as a reference
     IGS ``.pth`` (``opt.resume``) and a GMFlow ``.pth``, and
     ``infer_stream.run`` streams two windows on the ``system`` and
     ``opt`` sections above as dicts, with ``save_images`` on: once at the
     card's default (the three bf16 flags on) and once with them off,
     counters reset just before each run and read just after. Each run
     must write a ``results.json`` with the JAX keys and ``eval_pred/*.png``
     through the port's codec, overflow nothing, load every tensor of both
     files, lower each refine's loss and launch the stream's kernels; the
     per-frame PSNR of the two runs must agree within 0.5 dB. A third run
     at the card's default resumes from the bf16 run's weights written as
     the JAX package's ``params.msgpack`` (``flax_from_state_dict`` and
     ``flax_msgpack.dumps``) with ``opt.free_view``: every tensor must
     load, the per-frame PSNR must equal the bf16 run's bit for bit, and
     it must write one PLY (the window's valid rows) and one 1014×1352
     spiral PNG a frame and ``free_view.avi`` with one whole JPEG (SOF0
     1352×1014) a frame, launching the packed forward once a frame more
     than the bf16 run; the spiral view that sees the most is held against
     the plain blend at phase 4's tolerance, and the JPEG, PLY, PNG and
     render ms a frame are logged. Then ``python -m igs_tpu_torch.
     metrics`` as a subprocess on the bf16 run's ``eval_pred/*.png``
     against the scene's eval-view images under the same names, with a
     seeded LPIPS weights file: on the PNGs, and on JPEG copies of both
     written by the port's encoder; each must exit 0 with finite PSNR,
     SSIM and LPIPS for every frame, the JPEG run's PSNR and SSIM within
     1 dB and 0.05 of the PNG run's; the ms per image (decode, LPIPS at
     1014×1352) are logged. Last, a fourth CLI run at the card's default
     on an ENeRF-layout copy of the scene (``scene_type: enerf``: every
     image of one window and its key-frame refine as a JPEG from the
     port's encoder, ``images_2`` at 1014×1352 and ``images_512``; frame
     1's decoded against their PNGs first, PSNR > 30 dB), counters reset
     just before and read just after (the "enerf" path): every JPEG must
     go through the decoder and no other image but the depths, and the run
     must write ``results.json``, overflow nothing, lower the refine's
     loss and launch B1, B2 and B3; decode ms per image and ``sec/frame``
     are logged. One AGM forward of each of the first two runs is then
     timed by module and profiled.
Kernel launches are counted per path (stream, frame 0, regulariser,
training, lpips, flow, measurement, CLI, enerf); the kernels line carries
their sums.
The line before the card line is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

TOL_ABS = 2e-4  # kernel vs plain, per raw lane, off threshold-flip pixels
TOL_FLIP_FRAC = 1e-4  # pixels whose n_contrib / median slot may flip
TOL_IMAGE = 1e-3  # first window, kernel vs plain blend, images_pred
# backward kernel vs plain, per output lane group, relative to the group's
# largest |grad|: the kernel sums fp32 (compensated T and suffix sums,
# warp-tree pixel sums), the plain version recovers T in float64
TOL_BWD_REL = 1e-4
# segmented scan kernel vs plain (float64), relative to the running sum of
# |x| within each segment
TOL_SCAN_REL = 1e-5
# refine, kernels vs plain versions over 5 steps: per-step loss (relative)
# and the mean |difference| of the eval render afterwards. Adam's first
# steps are lr·sign(g), so a grad at its rounding floor may move a
# parameter a full lr either way; the image is held on its mean
TOL_REFINE_LOSS = 1e-3
TOL_REFINE_IMAGE = 1e-3
# flops per pixel-pair, counted from the kernel sources. A pixel tests
# every pair up to its last contributor (the candidate test: power and
# alpha, blend_fwd.cu:105-115); only the pairs it accepts take the rest.
# The accepted counts include the test.
FLOPS_FWD_CANDIDATE = 16
FLOPS_FWD_ACCEPTED = {"color": 29, "color_depth": 61, "full": 68}
# backward: the test adds the j < n_contrib check; an accepted pair adds
# the chain of csrc/blend_bwd.cu and one add per grad lane for the sum
# over the tile's pixels
FLOPS_BWD_CANDIDATE = 18
FLOPS_BWD_ACCEPTED = {"color": 75, "color_depth": 137, "full": 150}
LANES_READ = {"color": 9, "color_depth": 21, "full": 24}
# B1/B2 are also timed on a rotation of copies of their features whose live
# lanes pass twice the card's 50 MB L2 together: each call finds its input
# cold, as a render does after the gather (devtime.rotation_ms; rounds of
# eager and CUDA-graph-replayed calls in turns)
COLD_BYTES = 100e6
COLD_ROUNDS = 3
COLD_CALLS = 32
# count kernel: a walked pixel-pair costs the candidate test (16 flops, as
# the forward); an accepted one adds log1p, the logT sum and its test
# (csrc/blend_fwd.cu, count entry). Bytes: per walked pair its id and 6
# floats read; per tile its start and count read; per row its count
# written.
FLOPS_COUNT_ACCEPTED = 20
COUNT_BYTES_PER_PAIR = 4 * 7
COUNT_BYTES_PER_TILE = 4 * 2

# configs/synthetic_fullshape.yaml, section ``system`` (= AGMNet defaults)
SYSTEM = {
    "up_sample": True, "local_ray": True, "fine_tune_backbone": True,
    "backbone": {"feature_channels": 128, "transformer": {"num_layers": 6}},
    "transformer": {"num_layers": 1},
    "triplane_encoder": {"unet": {"num_attention_heads": 8,
                                  "attention_head_dim": 64,
                                  "num_layers": 4}},
}
# configs/synthetic_fullshape.yaml, section ``opt``; max_num and
# anchor_size at the N3DV model's widths (150 000, 8192) instead of the
# config's cut (65 536, 4096)
OPT = {
    "eval_batch_size": 5, "refine_gs": True, "refine_iterations": 50,
    "use_densify": True, "densify_grad_threshold": 0.0002,
    "max_num": 150_000,
    "training_lr": {"position_lr_init": 0.0016, "feature_lr": 0.0025,
                    "opacity_lr": 0.05, "scaling_lr": 0.005,
                    "rotation_lr": 0.01},
    "refine_item": {"no_shs": False, "no_opacity": False,
                    "no_scaling": False, "use_mask": False},
}
IN_RES = 512
OUT_HW = (1014, 1352)
N_GAUSSIANS = 120_000
MAX_NUM = 150_000
N_CAMS = 14
EVAL_VIEW, INPUT_VIEWS = 0, (13, 1, 8, 4)  # the n3d view table
INTERVAL = 5
STATIC_FRAC = 0.0  # no static shell: see phase 3 above
B = 5
ANCHORS = 8192
FOV = 0.8
DEVICE = "cuda"  # the card; a rehearsal on the CPU overrides it
BBOX = np.float32([[-1.4, -1.0, -0.6], [1.4, 1.0, 0.6]])

# frame-0 build through igs_tpu_torch.build_frame0 at the CLI's width:
# 512², capacity 200 000, Frame0Config defaults (densify from 500 every
# 100, prune 45 %). Cut: 6000 → 700 training steps (densify at 600 and
# 700) and 1000 → 100 fine-tune steps
F0_VIEWS = 20  # an N3DV rig: 21 cameras, one held out
F0_RES = 512
F0_ITERS = 700
F0_FINETUNE = 100
F0_CAPACITY = 200_000
F0_PRUNE = 0.45
F0_POINTS = 40_000  # the sparse cloud, a noisy subset of the scene
F0_CENTER = np.float32([0.0, 0.0, 6.0])  # above the z-cull plane (4.5)
F0_MAX_PAIRS = 1 << 21  # the JAX driver's budget
F0_REG_STEPS = 5
JAX_MAX_PER_TILE = 2048  # build_frame0.py's window: tiles past it truncate
F0_CASE = "frame-0 512x512"  # one view of the frame-0 scene

# training through igs_tpu_torch.train_agm.run on the repo's recipe,
# configs/synthetic_train_256.yaml, sections system and opt as dicts. Cut
# to N3DV widths instead of the config's: 512² data (256²), 8192 anchors
# (512), the stream's 120 000-Gaussian recipe without a static shell
# (4096), capacity 122 880; depth: 30 steps of 240 epochs
TRAIN_SYSTEM = {
    "up_sample": True, "local_ray": False, "fine_tune_backbone": True,
    "train_backbone": True,
    "backbone": {"feature_channels": 128, "pretrained_model_name_or_path": "",
                 "transformer": {"num_layers": 6}},
    "transformer": {"num_layers": 1},
    "triplane_encoder": {"unet": {"num_attention_heads": 8,
                                  "attention_head_dim": 64,
                                  "num_layers": 4}},
}
TRAIN_OPT = {
    "batch_size": 2, "lr": 4e-4, "num_epochs": 240, "warmup_steps": 200,
    "gradient_clip": 1.0, "lambda_rgb": 1.0, "lambda_ssim": 0.2,
    "lambda_lpips": 0, "anchor_size": ANCHORS, "neighbor_k": 8,
    "crash_snapshot_every": 200, "save_every": 40, "eval_every": 8,
}
TRAIN_RES = 512
TRAIN_FRAMES = 11  # 10 items: 5 steps an epoch at batch 2
TRAIN_STEPS = 30
TRAIN_RERUN = 3  # steps rerun through the packed route and the plain versions
TRAIN_PROFILED = TRAIN_STEPS  # the step run under torch.profiler
TOL_TRAIN_LOSS = 1e-5  # step-1 loss, relative, across the three routes
# step-1 loss, relative, mixed_precision bf16 against float32: the CNN in
# bf16 and every weight rounded to bf16 (the tiny CPU step: 2.6e-4)
TOL_MIXED_LOSS = 1e-2
# the LPIPS term's steps (opt.lambda_lpips, opt.lpips_weights): 512²,
# batch 2, 6 output views, so 12 LPIPS images at 256², windowed kernels
LPIPS_LAMBDA = 0.2
LPIPS_STEPS = 4
LPIPS_SEED = 7  # the seeded VGG written as the weights file
TOL_LPIPS_REL = 1e-4  # card against CPU, the same 256² batch and weights
WIN_BUDGETS = (1024, 8192)  # window rows at 512²: truncating / not
# AGM-Net's flow render (renderer.render_flow): the JAX package's default
# flow size, on a training batch, through both routes
FLOW_HW = (1024, 1352)
FLOW_REPS = 3  # forwards timed with and without the flow render


def log(*a):
    print(*a, flush=True)


@functools.cache
def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# the synthetic stream: the recipe of the port's data/synthetic.py
# ---------------------------------------------------------------------------


def make_cameras(n_cams=N_CAMS, radius=4.0):
    """(n_cams, 4, 4) c2ws of the synthetic rig."""
    from igs_tpu_torch.data.synthetic import make_cameras as records

    c2ws = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    for c2w, rec in zip(c2ws, records(n_cams, radius=radius)):
        c2w[:3, :3] = rec["rotation"]
        c2w[:3, 3] = rec["position"]
    return c2ws


def scene_gaussians(t, n, seed=0, motion_scale=0.15,
                    static_frac=0.3, opacity_range=(-0.5, 2.0),
                    scale_range=(-5.0, -3.8)):
    from igs_tpu_torch.data import synthetic

    return synthetic.scene_gaussians(
        n, seed, t, motion_scale=motion_scale, static_frac=static_frac,
        opacity_range=opacity_range, scale_range=scale_range)


class Stream:
    """collate()-layout items of a key→candidate stream, in memory, with
    the key frames' refine data (``N3dInferDataset``'s interface)."""

    def __init__(self, items, start_gs, refine):
        self.items = items
        self.start_gs = start_gs
        self.refine = refine

    def build_refine_dataset(self, eval_batch_size):
        self.refine_dataset = set(
            range(eval_batch_size, len(self.items) + 1, eval_batch_size))

    def get_refine_data(self, key):
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


def build_stream(dev, n_items):
    import torch

    from igs_tpu_torch.builders import build_raster_settings
    from igs_tpu_torch.core.camera import Camera
    from igs_tpu_torch.core.gaussians import Gaussians
    from igs_tpu_torch.data.dataset import local_ray_directions, world_rays
    from igs_tpu_torch.ops.rasterize import rasterize

    c2ws = make_cameras()
    vids = (EVAL_VIEW,) + INPUT_VIEWS
    n_frames = n_items + 1
    frames = [Gaussians.create(*scene_gaussians(0.4 * f, N_GAUSSIANS,
                                                static_frac=STATIC_FRAC),
                               device=dev)
              for f in range(n_frames)]

    def render(g, c2w, hw, outputs="color"):
        # set-up renders take a roomy budget; the pipeline keeps its own
        s = build_raster_settings(*hw, max_pairs=1 << 23)._replace(
            outputs=outputs)
        cam = Camera.from_c2w(c2w, (FOV, FOV), hw, device=dev)
        out = rasterize(g.get_xyz, g.get_opacity, g.get_scaling,
                        g.get_rotation, cam, shs=g.shs, valid=g.valid,
                        settings=s)
        if int(out["overflow_tiles"]):
            raise RuntimeError("scene render overflowed its pair budget")
        img = torch.clamp(out["color"], 0, 1)
        # the dataset reads uint8 PNGs
        img = (img * 255).to(torch.uint8).float() / 255.0
        return img.cpu().numpy(), out["depth"]

    inputs = {f: np.stack([render(frames[f], c2ws[v], (IN_RES, IN_RES))[0]
                           for v in INPUT_VIEWS]) for f in range(n_frames)}
    depth0 = np.stack([
        render(frames[0], c2ws[v], OUT_HW, "color_depth")[1].cpu().numpy()
        for v in INPUT_VIEWS])
    depth0 = np.clip(depth0 * 1000.0, 0, 65535).astype(np.uint16) / 1000.0
    h8 = IN_RES // 8 * 2
    dirs = local_ray_directions(h8, h8, FOV, FOV)
    centers = c2ws[:, :3, 3]
    radius = 1.1 * np.linalg.norm(centers - centers.mean(0), axis=1).max()
    items = []
    for f in range(n_items):
        key = (f // INTERVAL) * INTERVAL
        out_imgs = np.stack([render(frames[f + 1], c2ws[v], OUT_HW)[0]
                             for v in vids])
        it = {
            "cur_images_input": inputs[key],
            "next_images_input": inputs[f + 1],
            "images_output": out_imgs,
            "c2w_output": c2ws[list(vids)],
            "c2w_input": c2ws[list(INPUT_VIEWS)],
            "FOV": np.float32([FOV, FOV]),
            "background_color": np.zeros(3, np.float32),
            "resolution": np.int32(OUT_HW),
            "radius": np.float32(radius),
            "bounding_box": BBOX,
            "depth": depth0.astype(np.float32),
            "local_rays": dirs,
            "rays": world_rays(dirs, c2ws[list(INPUT_VIEWS)]),
            "keyframe": 1 if f % INTERVAL == 0 else 0,
            "idx": f,
        }
        items.append(it)
    # refine data of each key frame (1-based key = the frame refined):
    # every camera but the eval one (infer_data.get_refine_data)
    train_vids = [v for v in range(N_CAMS) if v != EVAL_VIEW]
    refine = {key: {"images": [render(frames[key], c2ws[v], OUT_HW)[0]
                               for v in train_vids],
                    "c2ws": list(c2ws[train_vids]),
                    "FOV": np.float32([FOV, FOV]),
                    "bg": np.zeros(3, np.float32)}
              for key in range(INTERVAL, n_items + 1, INTERVAL)}
    return Stream(items, frames[0].to("cpu"), refine), frames[0], c2ws


def write_frame0(dev, root):
    """A frame directory as ``build_frame0`` reads it: ``cameras.json`` of
    F0_VIEWS cameras on an arc at F0_RES², ``images_512/*.png`` rendered by
    the port from the stream's scene recipe (120 000 Gaussians, moved to
    F0_CENTER), and ``points3D.npz``, a seeded noisy subset of the means
    with their DC colours standing in for the sparse cloud. Returns the
    directory, the scene's Gaussians and the c2ws."""
    import os

    from igs_tpu_torch.builders import build_raster_settings
    from igs_tpu_torch.core.camera import Camera
    from igs_tpu_torch.core.gaussians import Gaussians
    from igs_tpu_torch.core.sh import SH_C0
    from igs_tpu_torch.data.dataset import fov2focal
    from igs_tpu_torch.ops.rasterize import rasterize
    from igs_tpu_torch.utils.saving import save_image

    xyz, opacity, rot, scaling, shs = scene_gaussians(
        0.0, N_GAUSSIANS, seed=1, static_frac=STATIC_FRAC)
    xyz = xyz + F0_CENTER
    g = Gaussians.create(xyz, opacity, rot, scaling, shs, device=dev)
    c2ws = make_cameras(F0_VIEWS)
    c2ws[:, :3, 3] += F0_CENTER
    frame_dir = os.path.join(root, "colmap_0")
    os.makedirs(os.path.join(frame_dir, "images_512"))
    settings = build_raster_settings(F0_RES, F0_RES, max_pairs=1 << 23
                                     )._replace(outputs="color")
    focal = float(fov2focal(FOV, F0_RES))
    cams_json = []
    for i, c2w in enumerate(c2ws):
        cam = Camera.from_c2w(c2w, (FOV, FOV), (F0_RES, F0_RES), device=dev)
        out = rasterize(g.get_xyz, g.get_opacity, g.get_scaling,
                        g.get_rotation, cam, shs=g.shs, valid=g.valid,
                        settings=settings)
        if int(out["overflow_tiles"]):
            raise RuntimeError("frame-0 scene render overflowed its budget")
        save_image(os.path.join(frame_dir, "images_512", f"{i:05d}.png"),
                   out["color"].cpu().numpy())
        cams_json.append({
            "id": i, "img_name": f"{i:05d}", "width": F0_RES,
            "height": F0_RES, "position": c2w[:3, 3].tolist(),
            "rotation": c2w[:3, :3].tolist(), "fx": focal, "fy": focal})
    with open(os.path.join(frame_dir, "cameras.json"), "w") as f:
        json.dump(cams_json, f)
    rng = np.random.RandomState(2)
    sel = rng.choice(N_GAUSSIANS, F0_POINTS, replace=False)
    np.savez(os.path.join(frame_dir, "points3D.npz"),
             xyz=(xyz[sel] + rng.normal(0, 0.01, (F0_POINTS, 3))).astype(
                 np.float32),
             rgb=np.clip(0.5 + SH_C0 * shs[sel, 0], 0, 1).astype(np.float32))
    return frame_dir, g, c2ws


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------


def packed_inputs(g, cam, hw, mode, max_pairs):
    from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
    from igs_tpu_torch.ops.blend import pack_features
    from igs_tpu_torch.ops.projection import project

    proj = project(g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                   cam, shs=g.shs, valid=g.valid, geometry=mode != "color")
    gx, gy = image_tile_grid(*hw)
    pairs = build_tile_pairs(proj, gx, gy, max_pairs)
    if bool(pairs.overflowed.any()):
        raise RuntimeError("kernel-check inputs overflowed their pair budget")
    feats = pack_features(proj)
    if mode == "color":
        feats = feats[..., :16]
    rows = feats.reshape(-1, feats.shape[-1]).t().contiguous()
    feats_t = rows.index_select(1, pairs.gauss_id.clamp_min(0).long())
    return feats_t, pairs.tile_start, pairs.tile_count, gx, gy


def cold_ms(fn, x, live_bytes):
    """Per-call ms of ``fn(x')`` over a rotation of copies x' of ``x``
    whose ``live_bytes`` each pass COLD_BYTES together: the medians of
    ``devtime.rotation_ms``'s eager and graph-replayed readings."""
    from igs_tpu_torch.utils.devtime import rotation_ms

    copies = max(2, math.ceil(COLD_BYTES / max(live_bytes, 1)))
    inputs = [x] + [x.clone() for _ in range(copies - 1)]
    r = rotation_ms({"kernel": fn}, inputs, rounds=COLD_ROUNDS,
                    n=COLD_CALLS)["kernel"]
    return {"graph_l2_cold_ms": float(np.median(r["graph"])),
            "eager_l2_cold_ms": float(np.median(r["eager"])),
            "cold_copies": copies}


def cuda_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


LANE_GROUPS = {
    "color": {"C": (0, 3), "W": (3, 4), "logT": (4, 5), "n_contrib": (5, 6)},
    "other": {"C": (0, 3), "W": (3, 4), "coord": (4, 7), "depth": (7, 8),
              "normal": (8, 11), "mcoord": (11, 14), "mdepth": (14, 15),
              "logT": (15, 16), "n_contrib": (16, 17), "med_pos": (17, 18)},
}


def compare_kernel(name, feats_t, start, count, gx, gy, mode):
    import torch

    from igs_tpu_torch.ops.blend import (
        blend_raw_packed_cuda, blend_raw_packed_plain)
    from igs_tpu_torch.utils import h100

    args = (feats_t, start, count, gx, gy, mode)
    kern = blend_raw_packed_cuda(*args)
    torch.cuda.synchronize()
    plain = blend_raw_packed_plain(*args)
    nc = 5 if mode == "color" else 16
    flip = kern[..., nc] != plain[..., nc]
    if mode != "color":
        flip |= kern[..., 17] != plain[..., 17]
    ok = ~flip
    groups = LANE_GROUPS["color" if mode == "color" else "other"]
    diff = (kern - plain).abs()
    errs = {g: float(diff[..., a:b][ok].max()) for g, (a, b) in groups.items()}
    over = int((diff.amax(dim=-1)[ok] > TOL_ABS).sum())
    pixels = flip.numel()
    ms = cuda_ms(lambda: blend_raw_packed_cuda(*args), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: blend_raw_packed_plain(*args), reps=2)
    live = int(count.sum())
    cold = cold_ms(lambda x: blend_raw_packed_cuda(x, *args[1:]), feats_t,
                   4 * live * LANES_READ[mode])
    walked = float(kern[..., nc].sum())  # pairs up to each last contributor
    accepted = accepted_pixel_pairs(feats_t, start, count, gx, gy,
                                    kern[..., nc])
    nbytes = 4 * (live * LANES_READ[mode] + kern.numel())
    ops = (FLOPS_FWD_CANDIDATE * (walked - accepted)
           + FLOPS_FWD_ACCEPTED[mode] * accepted)
    bound_ms, bound_by = h100.bound(nbytes, ops)
    res = {
        "case": name, "mode": mode, "tiles": int(count.numel()),
        "pairs": live, "walked_pixel_pairs": walked,
        "accepted_pixel_pairs": accepted, "flips": int(flip.sum()),
        "pixels": pixels,
        "pixels_over_tol": over,
        "max_abs_err": max(errs.values()), "err_by_lane": errs,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, **cold,
        "bytes": nbytes, "flops": ops,
    }
    log(f"kernel-vs-plain {json.dumps(res)}")
    res["ok"] = (res["flips"] <= TOL_FLIP_FRAC * pixels
                 and res["max_abs_err"] <= TOL_ABS)
    return res


def accepted_pixel_pairs(feats_t, start, count, gx, gy, nc, tile_block=256,
                         chunk=128, hw=None):
    """The pixel-pairs the forward accepted, from its n_contrib lane ``nc``
    (T, 256): pair j of a tile counts for pixel p when j < n_contrib(p),
    power <= 0 and alpha >= 1/255 (the plain version's candidate test);
    with ``hw`` only the pixels inside an image of that size."""
    import torch

    from igs_tpu_torch.ops.blend import MIN_ALPHA, P, TILE_X, TILE_Y

    dev = feats_t.device
    nc = nc.long()
    pidx = torch.arange(P, device=dev)
    kk = torch.arange(chunk, device=dev)
    total = 0
    for t0 in range(0, count.shape[0], tile_block):
        tiles = torch.arange(t0, min(count.shape[0], t0 + tile_block),
                             device=dev)
        lt = tiles % (gx * gy)
        px = ((lt % gx) * TILE_X)[:, None].float() + (pidx % TILE_X).float()
        py = ((lt // gx) * TILE_Y)[:, None].float() + (pidx // TILE_X).float()
        ncb = nc[tiles]
        if hw is not None:  # outside pixels take no pair
            ncb = torch.where((px < hw[1]) & (py < hw[0]), ncb,
                              torch.zeros_like(ncb))
        first = start[tiles].long()
        for c0 in range(0, int(ncb.max()), chunk):
            slot = c0 + kk
            col = (first[:, None] + slot).clamp(max=feats_t.shape[1] - 1)
            f = feats_t[:6, col][:, :, None, :]  # (6, tiles, 1, chunk)
            dx = f[0] - px[:, :, None]
            dy = f[1] - py[:, :, None]
            power = (-0.5 * (f[2] * dx * dx + f[4] * dy * dy)
                     - f[3] * dx * dy)
            alpha = torch.clamp_max(
                f[5] * torch.exp(torch.clamp_max(power, 0.0)), 0.99)
            take = ((slot < ncb[:, :, None]) & (power <= 0.0)
                    & (alpha >= MIN_ALPHA))
            total += int(take.sum())
    return total


BWD_GROUPS = {"dxy": (0, 2), "dconic": (2, 5), "dopacity": (5, 6),
              "dcolor": (6, 9), "dvp_t": (9, 13), "dcam_plane": (13, 21),
              "dnormal": (21, 24)}


def compare_backward(name, feats_t, start, count, gx, gy, mode):
    """The backward kernel against its plain version on the forward
    kernel's raw block and a seeded cotangent."""
    import torch

    from igs_tpu_torch.ops.blend import (
        blend_raw_packed_bwd_cuda, blend_raw_packed_bwd_plain,
        blend_raw_packed_cuda)
    from igs_tpu_torch.utils import h100

    raw = blend_raw_packed_cuda(feats_t, start, count, gx, gy, mode)
    gen = torch.Generator(device=raw.device).manual_seed(7)
    cot = torch.randn(raw.shape, generator=gen, device=raw.device)
    # only the differentiable raw lanes carry a cotangent
    diff_lanes = 5 if mode == "color" else 16
    cot[..., diff_lanes:] = 0.0
    cot = 1e-3 * cot  # the order of a mean-reduced image loss
    args = (feats_t, start, count, gx, gy, mode, raw, cot)
    kern = blend_raw_packed_bwd_cuda(*args)
    again = blend_raw_packed_bwd_cuda(*args)
    torch.cuda.synchronize()
    plain = blend_raw_packed_bwd_plain(*args)
    lanes = LANES_READ[mode]
    errs, rel = {}, {}
    for g, (a, b) in BWD_GROUPS.items():
        if b > lanes:
            continue
        d = float((kern[a:b] - plain[a:b]).abs().max())
        scale = float(plain[a:b].abs().max())
        errs[g], rel[g] = d, d / max(scale, 1e-30)
    ms = cuda_ms(lambda: blend_raw_packed_bwd_cuda(*args), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: blend_raw_packed_bwd_plain(*args), reps=1)
    nc = raw[..., 5 if mode == "color" else 16]
    walked_pairs = int(torch.minimum(count.long(),
                                     nc.amax(dim=1).long()).sum())
    cold = cold_ms(lambda x: blend_raw_packed_bwd_cuda(x, *args[1:]),
                   feats_t, 4 * walked_pairs * lanes)
    walked = float(nc.sum())  # pixel-pairs up to each last contributor
    accepted = accepted_pixel_pairs(feats_t, start, count, gx, gy, nc)
    nbytes = 4 * (2 * walked_pairs * lanes + 2 * raw.numel())
    ops = (FLOPS_BWD_CANDIDATE * (walked - accepted)
           + FLOPS_BWD_ACCEPTED[mode] * accepted)
    bound_ms, bound_by = h100.bound(nbytes, ops)
    res = {
        "case": name, "mode": mode, "tiles": int(count.numel()),
        "walked_pairs": walked_pairs, "walked_pixel_pairs": walked,
        "accepted_pixel_pairs": accepted,
        "max_abs_err": max(errs.values()), "err_by_group": errs,
        "rel_err_by_group": rel, "bitwise_repeat": bool(torch.equal(
            kern, again)),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, **cold,
        "bytes": nbytes, "flops": ops,
    }
    log(f"backward-vs-plain {json.dumps(res)}")
    res["ok"] = res["bitwise_repeat"] and max(rel.values()) <= TOL_BWD_REL
    return res


def scan_check(x, ids):
    """The scan kernel against its plain version: (max abs error, largest
    error relative to the running |x| sum, bitwise repeat)."""
    import torch

    from igs_tpu_torch.ops.segred import (
        segmented_scan_cuda, segmented_scan_plain)

    kern = segmented_scan_cuda(x, ids)
    again = segmented_scan_cuda(x, ids)
    torch.cuda.synchronize()
    err = (kern - segmented_scan_plain(x, ids)).abs()
    scale = segmented_scan_plain(x.abs(), ids)
    return (float(err.max()), float((err / scale.clamp_min(1e-30)).max()),
            bool(torch.equal(kern, again)))


def compare_segscan(g, cam, lanes, budget):
    """The segmented scan on the eval view's expansion ids and on seeded
    synthetic runs, against its plain version, and the gather's VJP
    against ``index_add_``."""
    import torch

    from igs_tpu_torch.data.scan_ids import scan_edge_ids, synthetic_scan_ids
    from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
    from igs_tpu_torch.ops.projection import project
    from igs_tpu_torch.ops.segred import (
        segment_sum_sorted, segmented_scan_cuda, segmented_scan_plain)
    from igs_tpu_torch.utils import h100

    proj = project(g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                   cam, shs=g.shs, valid=g.valid, geometry=False)
    pairs = build_tile_pairs(proj, *image_tile_grid(*OUT_HW), budget,
                             segred_aux=True)
    ids = pairs.exp_gauss_id
    gen = torch.Generator(device=ids.device).manual_seed(lanes)

    def grads(ids):
        x = torch.randn((lanes, ids.shape[0]), generator=gen,
                        device=ids.device)
        return torch.where(ids[None, :] >= 0, 1e-3 * x, torch.zeros_like(x))

    x = grads(ids)
    abs_err, rel, repeat = scan_check(x, ids)
    syn_ids = torch.from_numpy(synthetic_scan_ids(lanes)).to(ids.device)
    syn_abs, syn_rel, syn_repeat = scan_check(grads(syn_ids), syn_ids)
    # the kernel's edges, with grads in every row (the pad runs too)
    edges = {}
    for case, e_ids in scan_edge_ids(lanes).items():
        e_ids = torch.from_numpy(e_ids).to(ids.device)
        e_x = 1e-3 * torch.randn((lanes, e_ids.shape[0]), generator=gen,
                                 device=ids.device)
        e_abs, e_rel, e_repeat = scan_check(e_x, e_ids)
        edges[case] = {"rows": int(e_ids.shape[0]), "max_abs_err": e_abs,
                       "max_rel_err": e_rel, "bitwise_repeat": e_repeat}
    # the whole gather VJP (scan + last-row gather) against one index_add_
    n_rows = g.num_capacity
    idx = ids.clamp_min(0).long()

    def library():
        return torch.zeros((lanes, n_rows), device=x.device).index_add_(
            1, idx, x)

    vjp_err = float((segment_sum_sorted(x, ids, pairs.gauss_last_row)
                     - library()).abs().max())
    ms = cuda_ms(lambda: segmented_scan_cuda(x, ids), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: segmented_scan_plain(x, ids), reps=2)
    library_ms = cuda_ms(library, reps=20, warmup=3)
    nbytes = 4 * (2 * x.numel() + ids.numel())
    res = {
        "lanes": lanes, "pairs": int(ids.shape[0]),
        "live_pairs": int((ids >= 0).sum()),
        "max_abs_err": max(abs_err, syn_abs), "max_rel_err": rel,
        "synthetic": {"rows": int(syn_ids.shape[0]),
                      "runs": int((syn_ids[1:] != syn_ids[:-1]).sum()) + 1,
                      "max_abs_err": syn_abs, "max_rel_err": syn_rel,
                      "bitwise_repeat": syn_repeat},
        "edges": edges,
        "vjp_vs_index_add_max_abs": vjp_err,
        "bitwise_repeat": repeat,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": h100.bound(nbytes)[0], "bound_by": "bytes",
        "bytes": nbytes,
    }
    log(f"segscan-vs-plain {json.dumps(res)}")
    res["ok"] = (repeat and syn_repeat and max(rel, syn_rel) <= TOL_SCAN_REL
                 and all(e["bitwise_repeat"]
                         and e["max_rel_err"] <= TOL_SCAN_REL
                         for e in edges.values())
                 and vjp_err <= TOL_SCAN_REL * float(x.abs().sum(1).max()))
    return res


def compare_count(name, g, cam, hw, budget):
    """The count kernel against its plain version on one view's pairs, and
    its total against the forward kernel's accepted pixel-pairs (inside
    the image) on the same pairs."""
    import torch

    from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
    from igs_tpu_torch.ops.blend import blend_raw_packed_cuda, pack_features
    from igs_tpu_torch.ops.count import (
        count_contributions_packed_cuda, count_contributions_packed_plain,
        count_rows)
    from igs_tpu_torch.ops.projection import project
    from igs_tpu_torch.utils import h100

    proj = project(g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                   cam, shs=g.shs, valid=g.valid, geometry=False)
    gx, gy = image_tile_grid(*hw)
    pairs = build_tile_pairs(proj, gx, gy, budget)
    if bool(pairs.overflowed.any()):
        raise RuntimeError("count-check inputs overflowed their pair budget")
    args = (count_rows(proj), pairs.gauss_id, pairs.tile_start,
            pairs.tile_count, gx, gy, hw[1], hw[0])
    kern = count_contributions_packed_cuda(*args)
    again = count_contributions_packed_cuda(*args)
    torch.cuda.synchronize()
    plain = count_contributions_packed_plain(*args)
    diff = (kern.long() - plain.long()).abs()
    feats = pack_features(proj)[..., :16]
    feats_t = feats.reshape(-1, 16).t().contiguous().index_select(
        1, pairs.gauss_id.clamp_min(0).long())
    start, count = pairs.tile_start, pairs.tile_count
    raw = blend_raw_packed_cuda(feats_t, start, count, gx, gy, "color")
    accepted = accepted_pixel_pairs(feats_t, start, count, gx, gy,
                                    raw[..., 5], hw=hw)
    nc = raw[..., 5]
    inside = untile_mask(count.shape[0], gx, gy, hw, nc.device)
    walked = float(torch.where(inside, nc, torch.zeros_like(nc)).sum())
    walked_pairs = int(torch.minimum(count.long(),
                                     nc.amax(dim=1).long()).sum())
    ms = cuda_ms(lambda: count_contributions_packed_cuda(*args), reps=20,
                 warmup=3)
    plain_ms = cuda_ms(lambda: count_contributions_packed_plain(*args),
                       reps=2)
    nbytes = (COUNT_BYTES_PER_PAIR * walked_pairs
              + COUNT_BYTES_PER_TILE * count.numel() + 4 * kern.numel())
    ops = (FLOPS_FWD_CANDIDATE * (walked - accepted)
           + FLOPS_COUNT_ACCEPTED * accepted)
    bound_ms, bound_by = h100.bound(nbytes, ops)
    pixels = int(inside.sum())
    res = {
        "case": name, "tiles": int(count.numel()), "pairs": int(count.sum()),
        "densest_tile": int(count.max()), "pixels": pixels,
        "total": int(kern.sum()), "accepted_pixel_pairs": accepted,
        "walked_pairs": walked_pairs, "walked_pixel_pairs": walked,
        "gaussians_differing": int((diff > 0).sum()),
        "sum_abs_diff": int(diff.sum()), "max_abs_err": float(diff.max()),
        "bitwise_repeat": bool(torch.equal(kern, again)),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bytes": nbytes, "flops": ops,
    }
    log(f"count-vs-plain {json.dumps(res)}")
    # a pixel at the T = 1e-4 threshold may end one pair apart in the two
    # versions (sequential fp32 sum vs chunked prefix sums): each such flip
    # moves one count by one; allowed on at most TOL_FLIP_FRAC of the pixels
    res["ok"] = (res["bitwise_repeat"] and res["total"] == accepted
                 and res["sum_abs_diff"] <= TOL_FLIP_FRAC * pixels)
    return res


def untile_mask(num_tiles, gx, gy, hw, dev):
    """(T, 256) bool: the tile pixel lies inside the h×w image."""
    import torch

    from igs_tpu_torch.ops.blend import P, TILE_X, TILE_Y

    t = torch.arange(num_tiles, device=dev) % (gx * gy)
    p = torch.arange(P, device=dev)
    px = ((t % gx) * TILE_X)[:, None] + p % TILE_X
    py = ((t // gx) * TILE_Y)[:, None] + p // TILE_X
    return (px < hw[1]) & (py < hw[0])


def window_inputs(g, cam, hw, budget):
    """One view's 32-lane pair features (the windowed route's pack in every
    mode), tile starts and tile pair counts."""
    from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
    from igs_tpu_torch.ops.blend import pack_features
    from igs_tpu_torch.ops.projection import project

    proj = project(g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                   cam, shs=g.shs, valid=g.valid, geometry=True)
    gx, gy = image_tile_grid(*hw)
    pairs = build_tile_pairs(proj, gx, gy, budget)
    if bool(pairs.overflowed.any()):
        raise RuntimeError("window-check inputs overflowed their pair budget")
    rows = pack_features(proj).reshape(-1, 32).t().contiguous()
    feats_t = rows.index_select(1, pairs.gauss_id.clamp_min(0).long())
    return feats_t, pairs.tile_start, pairs.tile_count, gx, gy


def compare_windowed(name, feats_t, start, tile_count, gx, gy, mode, maxpt):
    """The windowed forward and backward kernels against their plain
    versions on one view's pairs, ``min(tile_count, maxpt)`` a tile; each
    twice for bit equality. Bounds: the forward reads the live pairs'
    lanes and the tiles' starts and counts once and writes the raw block;
    the backward reads the walked pairs' lanes and the raw and cotangent
    blocks and writes the (32, pairs) grads once (``bound_ms``);
    ``window_bound_ms`` is the bound of the first backward's interface,
    which wrote the whole (T, maxpt, 32) window.
    ``whole_forward_ms`` and ``whole_backward_ms`` time ``blend_raw``'s
    autograd forward and backward (``_BlendRaw``: no window gather, no
    fold; the first port gathered the windows in the forward and again
    in the backward, and folded the per-slot grads)."""
    import torch

    from igs_tpu_torch.ops.blend_windowed import (
        blend_raw, blend_raw_bwd_cuda, blend_raw_bwd_pairs_plain,
        blend_raw_cuda, blend_raw_pairs_plain)
    from igs_tpu_torch.utils import h100

    counts = torch.clamp_max(tile_count, maxpt)
    args = (feats_t, start, counts, gx, gy, mode)
    kern = blend_raw_cuda(*args)
    again = blend_raw_cuda(*args)
    torch.cuda.synchronize()
    plain = blend_raw_pairs_plain(*args)
    flip = (kern[..., 16] != plain[..., 16]) | (kern[..., 17] != plain[..., 17])
    ok = ~flip
    diff = (kern - plain).abs()
    errs = {g: float(diff[..., a:b][ok].max())
            for g, (a, b) in LANE_GROUPS["other"].items()}
    ms = cuda_ms(lambda: blend_raw_cuda(*args), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: blend_raw_pairs_plain(*args), reps=2)
    ft = feats_t.detach().requires_grad_(True)
    whole_fwd_ms = cuda_ms(lambda: blend_raw(ft, start, counts, gx, gy, mode),
                           reps=20, warmup=3)
    live = int(counts.sum())
    nc = kern[..., 16]
    walked = float(nc.sum())
    accepted = accepted_pixel_pairs(feats_t, start, counts, gx, gy, nc)
    nbytes = 4 * (live * LANES_READ[mode] + 2 * counts.numel()
                  + kern.numel())
    ops = (FLOPS_FWD_CANDIDATE * (walked - accepted)
           + FLOPS_FWD_ACCEPTED[mode] * accepted)
    bound_ms, bound_by = h100.bound(nbytes, ops)
    fwd = {
        "case": name, "mode": mode, "max_per_tile": maxpt,
        "tiles": int(counts.numel()), "pairs": int(tile_count.sum()),
        "densest_tile": int(tile_count.max()),
        "truncated_tiles": int((tile_count > maxpt).sum()),
        "live_rows": live, "walked_pixel_pairs": walked,
        "accepted_pixel_pairs": accepted, "flips": int(flip.sum()),
        "pixels": flip.numel(), "max_abs_err": max(errs.values()),
        "err_by_lane": errs,
        "bitwise_repeat": bool(torch.equal(kern, again)),
        "ms": ms, "plain_ms": plain_ms, "whole_forward_ms": whole_fwd_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": ops,
    }
    log(f"windowed-fwd-vs-plain {json.dumps(fwd)}")
    fwd["ok"] = (fwd["bitwise_repeat"]
                 and fwd["flips"] <= TOL_FLIP_FRAC * fwd["pixels"]
                 and fwd["max_abs_err"] <= TOL_ABS)

    gen = torch.Generator(device=kern.device).manual_seed(11)
    cot = 1e-3 * torch.randn(kern.shape, generator=gen, device=kern.device)
    cot[..., 16:] = 0.0  # n_contrib, the median slot and pad carry none
    bargs = (feats_t, start, counts, gx, gy, mode, kern, cot)
    dk = blend_raw_bwd_cuda(*bargs)
    again = blend_raw_bwd_cuda(*bargs)
    torch.cuda.synchronize()
    dp = blend_raw_bwd_pairs_plain(*bargs)
    lanes = LANES_READ[mode]
    errs, rel = {}, {}
    for g, (a, b) in BWD_GROUPS.items():
        if b > lanes:
            continue
        d = float((dk[a:b] - dp[a:b]).abs().max())
        scale = float(dp[a:b].abs().max())
        errs[g], rel[g] = d, d / max(scale, 1e-30)
    unread = float(dk[lanes:].abs().max())
    b_ms = cuda_ms(lambda: blend_raw_bwd_cuda(*bargs), reps=10, warmup=2)
    b_plain_ms = cuda_ms(lambda: blend_raw_bwd_pairs_plain(*bargs), reps=1)
    out = blend_raw(ft, start, counts, gx, gy, mode)
    whole_ms = cuda_ms(lambda: torch.autograd.grad(out, ft, cot,
                                                   retain_graph=True),
                       reps=10, warmup=2)
    del ft, out
    walked_rows = int(torch.minimum(counts.long(),
                                    nc.amax(dim=1).long()).sum())
    nbytes = 4 * (walked_rows * lanes + feats_t.numel() + 2 * kern.numel())
    ops = (FLOPS_BWD_CANDIDATE * (walked - accepted)
           + FLOPS_BWD_ACCEPTED[mode] * accepted)
    bound_ms, bound_by = h100.bound(nbytes, ops)
    window_bound_ms = h100.bound(
        4 * (walked_rows * lanes + counts.numel() * maxpt * 32
             + 2 * kern.numel()), ops)[0]
    bwd = {
        "case": name, "mode": mode, "max_per_tile": maxpt,
        "walked_rows": walked_rows, "walked_pixel_pairs": walked,
        "accepted_pixel_pairs": accepted,
        "max_abs_err": max(errs.values()), "err_by_group": errs,
        "rel_err_by_group": rel, "unread_lanes_max_abs": unread,
        "bitwise_repeat": bool(torch.equal(dk, again)),
        "ms": b_ms, "plain_ms": b_plain_ms, "whole_backward_ms": whole_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "window_bound_ms": window_bound_ms,
        "bytes": nbytes, "flops": ops,
    }
    log(f"windowed-bwd-vs-plain {json.dumps(bwd)}")
    bwd["ok"] = (bwd["bitwise_repeat"] and unread == 0.0
                 and max(rel.values()) <= TOL_BWD_REL)
    return fwd, bwd, kern


def windowed_vs_packed(feats_t, start, tile_count, gx, gy, mode, raw_win):
    """B5a's raw against B1's on the same view where no tile truncates: the
    same kernel body walks the same pairs, so the raw must be bit-equal in
    every lane both write (color mode: C, W, logT and n_contrib, the packed
    8-lane layout's lanes; otherwise all 24). Then B5b's
    grads against B2's on the same pairs, from each forward's own raw
    and one seeded cotangent in each layout (color: the packed 8 lanes
    carry the windowed C, W and logT lanes; the geometry lanes zero):
    within ``TOL_BWD_REL`` of each lane group's largest grad, and bit
    equality reported."""
    import torch

    from igs_tpu_torch.ops.blend import (
        blend_raw_packed_bwd_cuda, blend_raw_packed_cuda)
    from igs_tpu_torch.ops.blend_windowed import blend_raw_bwd_cuda

    ft = feats_t[:16].contiguous() if mode == "color" else feats_t
    raw_p = blend_raw_packed_cuda(ft, start, tile_count, gx, gy, mode)
    torch.cuda.synchronize()
    if mode == "color":
        w = torch.cat([raw_win[..., 0:4], raw_win[..., 15:17]], -1)
        p = raw_p[..., 0:6]
    else:
        w, p = raw_win, raw_p
    res = {"mode": mode, "max_abs_diff": float((w - p).abs().max()),
           "bit_equal": bool(torch.equal(w, p))}

    gen = torch.Generator(device=raw_win.device).manual_seed(12)
    cot = 1e-3 * torch.randn(raw_win.shape, generator=gen,
                             device=raw_win.device)
    cot[..., 16:] = 0.0
    if mode == "color":
        cot[..., 4:15] = 0.0
        cot_p = torch.cat([cot[..., :4], cot[..., 15:16],
                           torch.zeros_like(cot[..., :3])], -1)
    else:
        cot_p = cot
    d_win = blend_raw_bwd_cuda(feats_t, start, tile_count, gx, gy, mode,
                               raw_win, cot)
    d_pk = blend_raw_packed_bwd_cuda(ft, start, tile_count, gx, gy, mode,
                                     raw_p, cot_p)
    torch.cuda.synchronize()
    lanes = LANES_READ[mode]
    rel = {}
    for g, (a, b) in BWD_GROUPS.items():
        if b <= lanes:
            rel[g] = float((d_win[a:b] - d_pk[a:b]).abs().max()) / max(
                float(d_pk[a:b].abs().max()), 1e-30)
    res["bwd_rel_err_by_group"] = rel
    res["bwd_bit_equal"] = bool(torch.equal(d_win[:lanes], d_pk[:lanes]))
    log(f"windowed-vs-packed {json.dumps(res)}")
    res["ok"] = res["bit_equal"] and max(rel.values()) <= TOL_BWD_REL
    return res


def compare_fold(dev):
    """B6's three kernels on the probe's input, (2^19, 16) float32 from
    ``RandomState(0)``: each launched twice, bit-equal to its plain
    version and to ``torch.mul(x, 2.0)`` (×2 is exact), and timed beside
    both three ways: 200 eager launches on that one input (the kernel
    table's earlier column), and ``bench_segscan_fold.cold_readings`` on
    a rotation of four seeded inputs (128 MiB, past the 50 MB L2) in seven
    interleaved rounds, eager and replayed from a CUDA graph (the graph
    median decides). Bound: the 32 MiB read once and written once; any
    reading above ``MAX_BOUND_SHARE`` of it raises. Whether the kernel
    is no slower than ``torch.mul`` (``no_slower_than_library``) is
    reported, not enforced: the margin is a few percent of one reading,
    not a correctness check."""
    import torch

    from igs_tpu_torch.tools import segscan_fold as sf
    from igs_tpu_torch.tools.bench_segscan_fold import (
        bound_ms, check_bound, cold_inputs, cold_readings, make_input)

    x = torch.from_numpy(make_input()).to(dev)
    library = sf.library_mul(x)
    bound = bound_ms(x)
    rotation = cold_inputs(dev)
    out = []
    for variant in sf.VARIANTS:
        kernel = getattr(sf, f"{variant}_cuda")
        plain = getattr(sf, f"{variant}_plain")
        kern, again = kernel(x), kernel(x)
        torch.cuda.synchronize()
        ref = plain(x)
        res = {
            "variant": variant, "shape": list(x.shape),
            "bit_equal_plain": bool(torch.equal(kern, ref)),
            "bit_equal_library": bool(torch.equal(kern, library)),
            "bitwise_repeat": bool(torch.equal(kern, again)),
            "max_abs_err": float((kern - ref).abs().max()),
            "eager_same_input_ms": cuda_ms(lambda: kernel(x), reps=200,
                                           warmup=10),
            "eager_same_input_plain_ms": cuda_ms(lambda: plain(x), reps=200,
                                                 warmup=10),
            "eager_same_input_library_ms": cuda_ms(
                lambda: sf.library_mul(x), reps=200, warmup=10),
            "bound_ms": bound, "bound_by": "bytes",
            "bytes": 2 * x.numel() * x.element_size(),
        }
        for key in ("eager_same_input_ms", "eager_same_input_plain_ms",
                    "eager_same_input_library_ms"):
            check_bound(f"{variant} {key}", res[key], bound)
        cold = cold_readings({"kernel": kernel, "torch.mul": sf.library_mul,
                              "plain": plain}, rotation)
        res["cold"] = cold
        res["ms"] = cold["kernel"]["graph"]["median"]
        res["plain_ms"] = cold["plain"]["graph"]["median"]
        res["library_ms"] = cold["torch.mul"]["graph"]["median"]
        res["eager_ms"] = cold["kernel"]["eager"]["median"]
        res["eager_library_ms"] = cold["torch.mul"]["eager"]["median"]
        res["host_ms"] = cold["kernel"]["host_ms"]
        res["bound_share"] = bound / res["ms"]
        res["library_bound_share"] = bound / res["library_ms"]
        res["no_slower_than_library"] = res["ms"] <= res["library_ms"]
        log(f"segscan_fold-vs-plain {json.dumps(res)}")
        res["ok"] = (res["bit_equal_plain"] and res["bit_equal_library"]
                     and res["bitwise_repeat"])
        out.append(res)
    log("segscan_fold graph-replayed L2-cold medians (ms): " + json.dumps({
        c["variant"]: {"kernel": c["ms"], "torch.mul": c["library_ms"],
                       "kernel/torch.mul": c["ms"] / c["library_ms"],
                       "host_ms": c["host_ms"]} for c in out}))
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from igs_tpu_torch.builders import (
            build_model, build_raster_settings, build_stream_configs)
        from igs_tpu_torch.core.camera import Camera
        from igs_tpu_torch.models import agm as agm_mod
        from igs_tpu_torch.ops import blend, cuda_build, segred
        from igs_tpu_torch.ops import blend_windowed as bw
        from igs_tpu_torch.ops import count as count_mod
        from igs_tpu_torch.stream import refine as refine_mod
        from igs_tpu_torch.stream.pipeline import StreamingPipeline
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1

    dev = torch.device(DEVICE)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: torch.backends.cuda.matmul.allow_tf32=False "
        "torch.backends.cudnn.allow_tf32=False")

    # -- build -------------------------------------------------------------
    sources = ["blend_fwd.cu", "blend_bwd.cu", "segscan.cu", "segscan_fold.cu"]
    t0 = time.perf_counter()
    cuda_build.build(sources)
    log(f"build: {time.perf_counter() - t0:.2f} s wall; per source "
        f"{json.dumps(cuda_build.BUILD_SECONDS)}")
    for src in sources:
        for line in cuda_build.BUILD_LOG.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")

    # -- scene -------------------------------------------------------------
    t0 = time.perf_counter()
    n_items = 2 * B
    stream, g0, c2ws = build_stream(dev, n_items)
    log(f"scene: {n_items} items, {N_GAUSSIANS} Gaussians, inputs "
        f"{IN_RES}², outputs {OUT_HW[0]}x{OUT_HW[1]}, refine data for key "
        f"frames {sorted(stream.refine)} ({N_CAMS - 1} views each), built "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    workspace = tempfile.mkdtemp(prefix="chip_smoke_")
    frame_dir, g_f0, c2ws_f0 = write_frame0(dev, workspace)
    log(f"frame-0 scene: {frame_dir}: {F0_VIEWS} views at {F0_RES}², "
        f"{N_GAUSSIANS} Gaussians around z = {F0_CENTER[2]}, {F0_POINTS} "
        f"init points, written in {time.perf_counter() - t0:.1f} s")

    # -- kernel vs plain, forward ------------------------------------------
    start_gs = g0.pad_to(MAX_NUM)
    eval_cam = Camera.from_c2w(c2ws[EVAL_VIEW], (FOV, FOV), OUT_HW,
                               device=dev).batched()
    depth_cams = Camera.stack([Camera.from_c2w(c2ws[v], (FOV, FOV),
                                               (128, 128), device=dev)
                               for v in INPUT_VIEWS])
    f0_cam = Camera.from_c2w(c2ws_f0[0], (FOV, FOV), (F0_RES, F0_RES),
                             device=dev).batched()
    eval_budget = build_raster_settings(*OUT_HW).max_pairs
    all_modes = ("color", "color_depth", "full")
    # the frame-0 view in the modes frame 0 runs: color its steps, full
    # its regulariser (and bench/roofline at 512²)
    shapes = (("eval 1014x1352", start_gs, eval_cam, OUT_HW, eval_budget,
               all_modes),
              ("depth-carry 4x128x128", start_gs, depth_cams, (128, 128),
               1 << 19, all_modes),
              (F0_CASE, g_f0, f0_cam, (F0_RES, F0_RES), F0_MAX_PAIRS,
               ("color", "full")))
    cases, bwd_cases = [], []
    for name, g, cam, hw, budget, modes in shapes:
        for mode in modes:
            inputs = packed_inputs(g, cam, hw, mode, budget)
            cases.append(compare_kernel(name, *inputs, mode))
            bwd_cases.append(compare_backward(name, *inputs, mode))
            del inputs
    bad = [f"{c['case']}/{c['mode']}" for c in cases if not c["ok"]]
    if bad:
        raise RuntimeError(
            f"blend kernel disagrees with its plain version in {bad} "
            f"(tolerance {TOL_ABS} off flip pixels, flips ≤ {TOL_FLIP_FRAC} "
            "of pixels)")

    # -- kernel vs plain, backward and segmented scan ------------------------
    bad = [f"{c['case']}/{c['mode']}" for c in bwd_cases if not c["ok"]]
    if bad:
        raise RuntimeError(
            f"blend backward kernel disagrees with its plain version or is "
            f"not bitwise repeatable in {bad} (tolerance {TOL_BWD_REL} of "
            "each lane group's largest grad)")
    scans = [compare_segscan(start_gs, eval_cam, lanes, eval_budget)
             for lanes in (16, 32)]
    if not all(c["ok"] for c in scans):
        raise RuntimeError(
            f"segmented scan disagrees with its plain version or is not "
            f"bitwise repeatable (tolerance {TOL_SCAN_REL} of the running "
            "|x| sum)")
    counts = [compare_count("eval 1014x1352", start_gs, eval_cam, OUT_HW,
                            eval_budget),
              compare_count(F0_CASE, g_f0, f0_cam,
                            (F0_RES, F0_RES), F0_MAX_PAIRS)]
    del g_f0
    if not all(c["ok"] for c in counts):
        raise RuntimeError(
            "count kernel disagrees with its plain version (more than "
            f"{TOL_FLIP_FRAC} of the pixels flipped), with the forward "
            "kernel's accepted pixel-pairs, or is not bitwise repeatable")

    # -- the windowed kernels vs plain, and vs the packed forward -------------
    win_cam = Camera.from_c2w(c2ws[EVAL_VIEW], (FOV, FOV),
                              (TRAIN_RES, TRAIN_RES), device=dev).batched()
    win_in = window_inputs(start_gs, win_cam, (TRAIN_RES, TRAIN_RES), 1 << 21)
    win_fwd, win_bwd, win_vs_packed = [], [], []
    for mode in ("color", "color_depth", "full"):
        for maxpt in WIN_BUDGETS:
            f, b, raw = compare_windowed(f"{TRAIN_RES}x{TRAIN_RES}", *win_in,
                                         mode, maxpt)
            win_fwd.append(f)
            win_bwd.append(b)
            if f["truncated_tiles"] == 0:
                win_vs_packed.append(windowed_vs_packed(*win_in, mode, raw))
            del raw
    del win_in
    bad = ([f"fwd {c['mode']}/{c['max_per_tile']}" for c in win_fwd
            if not c["ok"]]
           + [f"bwd {c['mode']}/{c['max_per_tile']}" for c in win_bwd
              if not c["ok"]]
           + [f"vs packed {c['mode']}" for c in win_vs_packed if not c["ok"]])
    if bad or len(win_vs_packed) != 3:
        raise RuntimeError(
            f"windowed kernels disagree with their plain versions, are not "
            f"bitwise repeatable, or disagree with the packed ones where "
            f"nothing truncates: {bad} (checked against packed: "
            f"{len(win_vs_packed)} of 3)")

    # -- the segscan layout probes vs plain and torch.mul ---------------------
    folds = compare_fold(dev)
    bad = [c["variant"] for c in folds if not c["ok"]]
    if bad:
        raise RuntimeError(f"segscan_fold kernels {bad} are not bit-equal to "
                           "their plain versions and torch.mul(x, 2.0)")

    # -- the main path -------------------------------------------------------
    model = build_model(SYSTEM, device=dev,
                        generator=torch.Generator().manual_seed(0))
    agm_ms, captured = [], []
    events = {}

    def pre_hook(_m, _args):
        events["start"] = torch.cuda.Event(enable_timing=True)
        events["start"].record()

    def post_hook(_m, _args, out):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        agm_ms.append(events["start"].elapsed_time(end))
        captured.append(out["images_pred"].clone())

    model.register_forward_pre_hook(pre_hook)
    model.register_forward_hook(post_hook)
    cfg, refine_cfg = build_stream_configs(OPT)
    cfg = dataclasses.replace(cfg, anchor_size=ANCHORS, neighbor_k=8,
                              depth_view_res=128, save_images=False,
                              workspace=workspace)
    log(f"configs: {cfg}; {refine_cfg}")
    settings = build_raster_settings(*OUT_HW)
    pipe = StreamingPipeline(model, stream, cfg, refine_cfg, settings,
                             device=dev)
    counters = launch_counters(blend, bw, segred, count_mod)
    key_inputs, key_launches = [], []
    refine_fn = pipe._refine

    def refine_with_counts(stream_gs, refine_data, radius):
        key_inputs.append(stream_gs.map(lambda x: x.clone()))
        before = counters.read()
        out = refine_fn(stream_gs, refine_data, radius)
        after = counters.read()
        key_launches.append({k: after[k] - before[k] for k in after})
        return out

    pipe._refine = refine_with_counts
    densify_log = log_densify(refine_mod)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    results = pipe.run(max_batches=2)
    wall = time.perf_counter() - t0
    launches = counters.read()
    log(f"stream: {wall:.2f} s wall for 2 windows with 2 key-frame "
        f"refines; AGM forward ms (CUDA events) {agm_ms}; AGM_times s "
        f"(host clock) {results['AGM_times']}")
    log(f"stream: psnr {json.dumps(results['psnr'])} avg {results['avg']:.4f}")
    log(f"stream: fps(render) {results['fps']:.3f} points_num "
        f"{results['points_num']} mask_num {results['mask_num']} "
        f"overflow_events {results['overflow_events']}")
    for rec, kl in zip(pipe.refine_log, key_launches):
        losses = rec["losses"]
        key_psnr = results["psnr"][f"frame_{rec['key'] - 1}"]
        log(f"refine: key {rec['key']} (batch {rec['batch']}): "
            f"{rec['seconds']:.3f} s, {rec['ms_per_step']:.3f} ms/step (CUDA "
            f"events), loss first 5 {losses[:5]} last 5 {losses[-5:]}, "
            f"points_num after densify {rec['points_num']}, re-rendered "
            f"eval PSNR {key_psnr:.4f}, "
            f"launches {json.dumps(kl)}")
    for d in densify_log:
        log(f"densify: {json.dumps(d)}")
    log(f"stream: launches {json.dumps(launches)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k in ("blend_fwd_packed/color", "blend_fwd_packed/color_depth",
              "blend_bwd_packed/color", "segmented_scan"):
        if launches[k] == 0:
            raise RuntimeError(f"the main path did not launch {k}")
    psnr = list(results["psnr"].values())
    if len(psnr) != n_items or not all(math.isfinite(p) for p in psnr):
        raise RuntimeError(f"non-finite or missing PSNR: {psnr}")
    if results["overflow_events"]:
        raise RuntimeError(f"overflow events: {results['overflow_events']}")
    if len(pipe.refine_log) != 2:
        raise RuntimeError(f"{len(pipe.refine_log)} key-frame refines, not 2")
    for rec in pipe.refine_log:
        losses = rec["losses"]
        first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        log(f"refine: key {rec['key']}: mean loss of the first 5 steps "
            f"{first5:.5f}, of the last 5 {last5:.5f}; eval PSNR "
            f"{rec['eval_psnr_before']:.4f} before the refine, "
            f"{rec['eval_psnr_after']:.4f} after")
        if not (len(losses) == cfg.refine_iterations
                and all(math.isfinite(x) for x in losses)
                and last5 < first5):
            raise RuntimeError(f"refine loss did not fall: {losses}")
        if not rec["eval_psnr_after"] >= rec["eval_psnr_before"]:
            raise RuntimeError(
                f"the refine lowered the eval PSNR of key {rec['key']}")
    first = captured[0]
    if first.shape != (B, 1, 3) + OUT_HW or not torch.isfinite(first).all():
        raise RuntimeError(f"bad images_pred {tuple(first.shape)}")

    # -- first window with the plain blend ------------------------------------
    kernel_fn = blend.blend_raw_packed_cuda
    captured.clear()
    blend.blend_raw_packed_cuda = blend.blend_raw_packed_plain
    try:
        plain_pipe = StreamingPipeline(
            model, stream, dataclasses.replace(cfg, refine_gs=False),
            refine_cfg, settings, device=dev)
        plain_pipe.run(max_batches=1)
    finally:
        blend.blend_raw_packed_cuda = kernel_fn
    diff = float((captured[0] - first).abs().max())
    log(f"first window, plain blend vs kernel: max |images_pred diff| {diff:.3g}"
        f" (tolerance {TOL_IMAGE})")
    if diff > TOL_IMAGE:
        raise RuntimeError("plain-blend rerun disagrees with the kernel run")

    # -- the first key frame's refine with the plain versions ---------------
    refine_args = refine_inputs(pipe, stream, key_inputs[0], refine_cfg)
    plain_refine_check(pipe, refine_args, blend, segred, eval_cam, stream)

    # -- frame 0: build_frame0, then the regulariser steps --------------------
    f0_rec, f0_launches = run_frame0(frame_dir, counters, dev, densify_log)
    reg_launches = frame0_reg_check(f0_rec, counters, blend, segred)
    f0_ms = f0_rec["ms_per_step"]
    del f0_rec

    # -- training: train_agm.run through the windowed route -------------------
    train = train_check(dev, workspace, counters, bw, segred, agm_mod)
    flows, flow_launches = flow_check(dev, train["root"], train["max_pairs"],
                                      train["max_per_tile"], counters, blend,
                                      bw)

    # -- profiles -------------------------------------------------------------
    profile_window(pipe, stream, torch)
    share = profile_refine_step(pipe, refine_args, blend, segred)
    # the blend kernels' share end to end, beside the kernel readings
    log(f"end to end (CUDA events): {json.dumps(share)}; frame-0 ms per "
        f"step {json.dumps(f0_ms)}; AGM forward ms {agm_ms}")

    # -- the measurement path, one subprocess a program -----------------------
    del pipe, refine_args, stream
    torch.cuda.empty_cache()
    measure_launches = measurement_path()

    # -- the streaming CLI, bf16 and float32 ----------------------------------
    cli_launches, enerf_launches = cli_phase(dev, workspace, counters)
    paths = {"stream": launches, "frame0": f0_launches,
             "regulariser": reg_launches, "train": train["launches"],
             "lpips": train["lpips"]["launches"], "flow": flow_launches,
             "measure": measure_launches, "cli": cli_launches,
             "enerf": enerf_launches}
    keys = [k for p in paths.values() for k in p]
    launches = {k: sum(p.get(k, 0) for p in paths.values())
                for k in dict.fromkeys(keys)}
    log(f"launches by path {json.dumps(paths)}; total {json.dumps(launches)}")

    # -- the kernels line ----------------------------------------------------
    # "timing" says how ms, plain_ms and library_ms were read: "eager" is
    # CUDA events around eager launches on one warm input; "graph_l2_cold"
    # the median of CUDA-graph replays on a rotation of inputs cold in L2
    # (compare_fold). B1 and B2 also carry their L2-cold medians, replayed
    # and eager (cold_ms)
    # B1 and B2: an entry for each mode at the shape of its earlier
    # entries (full forward: the frame-0 view, where its launches run) and
    # one for each frame-0 case; "launches" counts the mode at every
    # shape, "shape" names the case timed
    kernels = []
    for group, kernel, src, line, entries in (
            (cases, "blend_fwd_packed", "blend_fwd.cu", 893, (
                ("color", "eval 1014x1352", ""),
                ("color_depth", "depth-carry 4x128x128", ""),
                ("full", F0_CASE, ""), ("color", F0_CASE, "@frame0"))),
            (bwd_cases, "blend_bwd_packed", "blend_bwd.cu", 1121, (
                ("color", "eval 1014x1352", ""),
                ("color_depth", "eval 1014x1352", ""),
                ("full", "eval 1014x1352", ""),
                ("color", F0_CASE, "@frame0"), ("full", F0_CASE, "@frame0")))):
        by_case = {(c["case"], c["mode"]): c for c in group}
        for mode, case, suffix in entries:
            c = by_case[(case, mode)]
            kernels.append({
                "name": f"{kernel}/{mode}{suffix}",
                "route": "cuda",
                "source": f"igs_tpu_torch/csrc/{src}",
                "replaces": f"igs_tpu/ops/pallas_blend.py:{line}",
                "launches": launches[f"{kernel}/{mode}"],
                "max_abs_err": max(x["max_abs_err"] for x in group
                                   if x["mode"] == mode),
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": None, "timing": "eager", "shape": case,
                "graph_l2_cold_ms": c["graph_l2_cold_ms"],
                "eager_l2_cold_ms": c["eager_l2_cold_ms"],
            })
    c = scans[0]  # 16 lanes: the color-mode pack the refine reduces
    kernels.append({
        "name": "segmented_scan",
        "route": "cuda",
        "source": "igs_tpu_torch/csrc/segscan.cu",
        "replaces": "igs_tpu/ops/segred.py:59",
        "launches": launches["segmented_scan"],
        "max_abs_err": max(x["max_abs_err"] for x in scans),
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        "timing": "eager",
    })
    c = counts[1]  # the frame-0 view: the shape the main path counts
    kernels.append({
        "name": "count_contributions_packed",
        "route": "cuda",
        "source": "igs_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "igs_tpu/ops/pallas_blend.py:276",
        "launches": launches["count_contributions_packed"],
        "max_abs_err": max(x["max_abs_err"] for x in counts),
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": None, "timing": "eager",
    })
    for name, cases, src, line, mode in (
            ("blend_fwd_win", win_fwd, "blend_fwd.cu", 160, "full"),
            ("blend_fwd_win", win_fwd, "blend_fwd.cu", 160, "color"),
            ("blend_bwd_win", win_bwd, "blend_bwd.cu", 394, "full")):
        # the training path's mode (the flow render's: color) at the
        # window the training steps took
        c = [x for x in cases if x["mode"] == mode
             and x["max_per_tile"] == train["max_per_tile"]]
        c = (c or [x for x in cases if x["mode"] == mode])[-1]
        kernels.append({
            "name": f"{name}/{mode}",
            "route": "cuda",
            "source": f"igs_tpu_torch/csrc/{src}",
            "replaces": f"igs_tpu/ops/pallas_blend.py:{line}",
            "launches": launches[f"{name}/{mode}"],
            "max_abs_err": max(x["max_abs_err"] for x in cases),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": None, "timing": "eager",
            **{k: c[k] for k in ("whole_forward_ms", "whole_backward_ms")
               if k in c},
        })
    for c in folds:
        kernels.append({
            "name": f"segscan_fold/{c['variant']}",
            "route": "cuda",
            "source": "igs_tpu_torch/csrc/segscan_fold.cu",
            "replaces": "tools/tools_bench_segscan_fold.py:"
                        + ("57" if c["variant"] == "reshape" else "26"),
            "launches": launches[f"segscan_fold/{c['variant']}"],
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "timing": "graph_l2_cold",
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class launch_counters:
    """The kernels' launch counters, read and reset together. It holds
    the wrappers themselves, so a check that routes a module's kernel to
    its plain version for a while does not hide the counts."""

    def __init__(self, blend, bw, segred, count):
        self.by_mode = {"blend_fwd_packed": blend.blend_raw_packed_cuda,
                        "blend_bwd_packed": blend.blend_raw_packed_bwd_cuda,
                        "blend_fwd_win": bw.blend_raw_cuda,
                        "blend_bwd_win": bw.blend_raw_bwd_cuda}
        self.scan = segred.segmented_scan_cuda
        self.count = count.count_contributions_packed_cuda
        self.modes = list(blend.MODES)

    def reset(self):
        for fn in self.by_mode.values():
            fn.launches = 0
            fn.launches_by_mode = dict.fromkeys(self.modes, 0)
        self.scan.launches = 0
        self.count.launches = 0

    def read(self):
        out = {f"{name}/{m}": fn.launches_by_mode[m]
               for name, fn in self.by_mode.items() for m in self.modes}
        out["segmented_scan"] = self.scan.launches
        out["count_contributions_packed"] = self.count.launches
        return out


def log_densify(refine_mod):
    """Wrap the refine's densify to record, per event, the live rows, the
    free slots, the rows over the gradient threshold, and the live rows
    after it (densify then prune)."""
    import torch

    events = []
    densify = refine_mod.densify_and_prune

    def wrapped(state, cfg, extent, samples=None):
        g = state.gaussians
        grads = torch.where(state.denom > 0, state.xyz_grad_accum
                            / state.denom.clamp_min(1.0),
                            torch.zeros_like(state.denom))
        selected = (grads >= cfg.densify_grad_threshold) & g.valid
        out = densify(state, cfg, extent, samples)
        events.append({
            "step": state.step, "live_before": int(g.valid.sum()),
            "free": int((~g.valid).sum()), "selected": int(selected.sum()),
            "live_after": int(out.gaussians.valid.sum())})
        return out

    refine_mod.densify_and_prune = wrapped
    return events


def refine_inputs(pipe, stream, g_in, refine_cfg):
    """What the pipeline's first key-frame refine starts from: the carried
    Gaussians, the key frame's cameras and images, the view order."""
    import torch

    from igs_tpu_torch.core.camera import Camera
    from igs_tpu_torch.stream.refine import view_order

    key = min(stream.refine)
    data = stream.get_refine_data(key)
    with torch.inference_mode(False):
        g = g_in.map(lambda x: x.clone())
    cams = Camera.stack([pipe._camera(c, data["FOV"], *OUT_HW)
                         for c in data["c2ws"]])
    order = view_order(pipe.cfg.refine_iterations, len(data["images"]))
    return {"gaussians": g, "cams": cams,
            "gts": pipe._tensor(np.stack(data["images"])).float(),
            "order": order, "bg": pipe._tensor(data["bg"]).float(),
            "cfg": refine_cfg, "extent": float(stream[0]["radius"]),
            "capacity": pipe.cfg.max_num, "settings": pipe.refine_settings}


def plain_refine_check(pipe, ra, blend, segred, eval_cam, stream):
    """Five refine steps with the kernels, then with all three plain
    versions: per-step loss and the eval render afterwards."""
    import torch

    from igs_tpu_torch.ops.rasterize import rasterize
    from igs_tpu_torch.stream.refine import init_refine_state, refine_run

    steps = 5

    def run():
        st = init_refine_state(ra["gaussians"].map(lambda x: x.clone()),
                               ra["capacity"])
        losses = []
        st = refine_run(st, ra["cams"], ra["gts"], ra["order"][:steps],
                        ra["bg"], ra["cfg"], ra["settings"], ra["extent"],
                        steps, on_step=lambda it, s, m: losses.append(
                            m["loss"]))
        g = st.gaussians
        with torch.no_grad():
            img = rasterize(g.get_xyz, g.get_opacity, g.get_scaling,
                            g.get_rotation, eval_cam, shs=g.shs, bg=ra["bg"],
                            valid=g.valid, settings=ra["settings"])["color"]
        return [float(x) for x in losses], torch.clamp(img, 0, 1)

    k_losses, k_img = run()
    saved = (blend.blend_raw_packed_cuda, blend.blend_raw_packed_bwd_cuda,
             segred.segmented_scan_cuda)
    blend.blend_raw_packed_cuda = blend.blend_raw_packed_plain
    blend.blend_raw_packed_bwd_cuda = blend.blend_raw_packed_bwd_plain
    segred.segmented_scan_cuda = segred.segmented_scan_plain
    try:
        p_losses, p_img = run()
    finally:
        (blend.blend_raw_packed_cuda, blend.blend_raw_packed_bwd_cuda,
         segred.segmented_scan_cuda) = saved
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    diff = (k_img - p_img).abs()
    log(f"refine, kernels vs plain versions over {steps} steps of key frame "
        f"{min(stream.refine)}: losses {k_losses} vs {p_losses} (max rel "
        f"{loss_rel:.3g}, tolerance {TOL_REFINE_LOSS}); eval render mean "
        f"|diff| {float(diff.mean()):.3g} (tolerance {TOL_REFINE_IMAGE}), "
        f"max {float(diff.max()):.3g}")
    if loss_rel > TOL_REFINE_LOSS or float(diff.mean()) > TOL_REFINE_IMAGE:
        raise RuntimeError("the refine with the plain versions disagrees "
                           "with the kernel run")


def views_psnr(g, filt, cams, images, settings):
    """Mean PSNR of the color renders of every view against ``images``."""
    import torch

    from igs_tpu_torch.ops.rasterize import rasterize
    from igs_tpu_torch.train.frame0 import fused_render_args, views

    scales, opacity = fused_render_args(g, filt)
    out = []
    with torch.no_grad():
        for i, cam in enumerate(views(cams)):
            img = rasterize(g.xyz, opacity, scales, g.get_rotation, cam,
                            shs=g.shs, valid=g.valid,
                            settings=settings._replace(outputs="color"))
            mse = torch.mean((torch.clamp(img["color"], 0, 1) - images[i]) ** 2)
            out.append(float(-10 * torch.log10(mse)))
    return float(np.mean(out))


def tile_density(g, filt, cams, settings):
    """Per view of the importance pass: the densest tile's pairs, and the
    tiles past the JAX package's 2048-pair window."""
    from igs_tpu_torch.ops.rasterize import build_pairs_packed
    from igs_tpu_torch.train.frame0 import fused_render_args, views

    scales, opacity = fused_render_args(g, filt)
    densest, over = [], []
    for cam in views(cams):
        pairs = build_pairs_packed(g.xyz, opacity, scales, g.get_rotation,
                                   cam, valid=g.valid, settings=settings)
        densest.append(int(pairs.tile_count.max()))
        over.append(int((pairs.tile_count > JAX_MAX_PER_TILE).sum()))
    return {"densest_tile_pairs": max(densest),
            "tiles_over_2048": sum(over),
            "views_with_tiles_over_2048": sum(o > 0 for o in over)}


def run_frame0(frame_dir, counters, dev, densify_log):
    """The frame-0 build through ``build_frame0.train_one_frame``, counters
    reset just before and read just after; its checks; the record.
    ``densify_log`` collects the refine densify's events (rows selected,
    free slots), which the frame-0 densify calls before its own prunes."""
    import os

    import torch

    from igs_tpu_torch import build_frame0 as bf0
    from igs_tpu_torch.data.images import load_images_nchw
    from igs_tpu_torch.data.ply import load_gaussian_ply
    from igs_tpu_torch.ops.rasterize import RasterSettings
    from igs_tpu_torch.train import frame0 as f0

    # the initial Gaussians as train_one_frame makes them, for the PSNR
    # before training
    _, cams, images, pts, cols = bf0._load_frame(frame_dir, "images_512", 0,
                                                 dev)
    g_init = f0.create_from_points(pts, cols, F0_CAPACITY, device=dev)
    settings = RasterSettings(image_height=F0_RES, image_width=F0_RES,
                              max_pairs=F0_MAX_PAIRS)
    psnr_init = views_psnr(g_init, f0.compute_3d_filter(
        g_init.xyz, g_init.valid, cams), cams, images, settings)
    del g_init

    seen = {}
    importance = bf0.lightgaussian_importance

    def importance_seen(g, filt, cams_, settings_, **kw):
        seen.update(g=g, filt=filt, cams=cams_, settings=settings_)
        return importance(g, filt, cams_, settings_, **kw)

    bf0.lightgaussian_importance = importance_seen
    first_event = len(densify_log)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    try:
        rec = bf0.train_one_frame(
            frame_dir, "images_512", "3dgs_rade", F0_ITERS, F0_PRUNE,
            F0_CAPACITY, finetune_iters=F0_FINETUNE, device=dev,
            max_pairs=F0_MAX_PAIRS)
    finally:
        bf0.lightgaussian_importance = importance
    wall = time.perf_counter() - t0
    launches = counters.read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    density = tile_density(seen["g"], seen["filt"], seen["cams"],
                           seen["settings"])
    g = rec["state"].gaussians
    export = rec["export"]
    renders = load_images_nchw(
        [os.path.join(export["train_dir"], "gt", f"{i:05d}.png")
         for i in range(F0_VIEWS)], F0_RES, F0_RES)
    gts = images.cpu().numpy()
    psnr_export = float(np.mean(
        [-10 * np.log10(np.mean((renders[i] - gts[i]) ** 2))
         for i in range(F0_VIEWS)]))
    losses = rec["losses"]
    first50, last50 = float(np.mean(losses[:50])), float(np.mean(losses[-50:]))
    expect_kept = rec["n_after_train"] - f0.pruned_count(
        rec["n_after_train"], F0_PRUNE)
    log(f"frame0: {wall:.2f} s wall for {F0_ITERS} + {F0_FINETUNE} steps "
        f"at {F0_RES}² ({F0_VIEWS} views, capacity {F0_CAPACITY}); seconds "
        f"by stage {json.dumps(rec['seconds'])}; ms per step (CUDA events) "
        f"{json.dumps(rec['ms_per_step'])}; peak memory {peak:.2f} GiB")
    log(f"frame0: Gaussians init {rec['n_init']}, after training "
        f"{rec['n_after_train']}, after the prune {rec['n_after_prune']} "
        f"(expected {expect_kept}), final {rec['n_final']}; densify "
        f"{json.dumps(rec['densify'])}; before the size and z-cull prunes "
        f"{json.dumps(densify_log[first_event:])}")
    log(f"frame0: loss mean of the first 50 steps {first50:.5f}, of the "
        f"last 50 {last50:.5f}, fine-tune last {rec['finetune_losses'][-1]:.5f}"
        f"; views' PSNR {psnr_init:.4f} dB (init) → {psnr_export:.4f} dB "
        f"(exported renders); overflow {rec['overflow']}; importance "
        f"tiles {json.dumps(density)}")
    log(f"frame0: launches {json.dumps(launches)}")
    steps = F0_ITERS + F0_FINETUNE
    want = {"count_contributions_packed": F0_VIEWS,
            "blend_fwd_packed/color": steps, "blend_bwd_packed/color": steps,
            "segmented_scan": steps, "blend_fwd_packed/full": F0_VIEWS}
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad:
        raise RuntimeError(f"frame-0 launches (got, want): {bad}")
    if not last50 < first50:
        raise RuntimeError("frame-0 training did not lower the loss")
    if not psnr_export > psnr_init:
        raise RuntimeError("frame-0 build did not raise the views' PSNR")
    if rec["n_after_prune"] != expect_kept:
        raise RuntimeError("the importance prune kept the wrong count")
    if rec["overflow"]:
        raise RuntimeError(f"frame-0 pair budget overflow {rec['overflow']}")
    for sub in ("gt", "depth_expected_mm"):
        names = sorted(os.listdir(os.path.join(export["train_dir"], sub)))
        if names != [f"{i:05d}.png" for i in range(F0_VIEWS)]:
            raise RuntimeError(f"frame-0 export {sub}: {names}")
    if not os.path.exists(os.path.join(export["dir"], "cameras.json")):
        raise RuntimeError("frame-0 export wrote no cameras.json")
    back = load_gaussian_ply(export["ply"])
    live = g.valid.cpu()
    for name in ("xyz", "opacity", "rotation", "scaling", "shs"):
        if not torch.equal(getattr(back, name),
                           getattr(g, name).detach().cpu()[live]):
            raise RuntimeError(f"the PLY does not read back {name}")
    log(f"frame0: export {export['dir']}: {F0_VIEWS} gt and depth PNGs, "
        f"cameras.json, PLY of {back.num_capacity} rows read back bit for "
        "bit")
    return rec, launches


def frame0_reg_check(rec, counters, blend, segred):
    """F0_REG_STEPS steps with the depth-normal regulariser (full renders)
    from the fine-tuned state, with the kernels (counters reset just
    before) and again with all plain versions; losses and the first
    view's color render afterwards compared."""
    import torch

    from igs_tpu_torch.ops.rasterize import rasterize
    from igs_tpu_torch.train.frame0 import (
        frame0_step, fused_render_args, position_lr)

    cams, images, filt = rec["cameras"], rec["images"], rec["filter"]
    cfg, s, spatial = rec["cfg"], rec["settings"], rec["spatial"]
    bg = torch.zeros(3, device=images.device)
    base = F0_ITERS + F0_FINETUNE

    def run():
        st, losses = rec["state"], []
        for k in range(F0_REG_STEPS):
            v = k % F0_VIEWS
            st, loss = frame0_step(st, cams.view(v), images[v], bg, filt, cfg,
                                   s, position_lr(base + k + 1, cfg, spatial),
                                   reg_on=True)
            losses.append(loss)
        return [float(x) for x in losses], st.gaussians

    def render(g):
        scales, opacity = fused_render_args(g, filt)
        with torch.no_grad():
            img = rasterize(g.xyz, opacity, scales, g.get_rotation,
                            cams.view(0), shs=g.shs, bg=bg, valid=g.valid,
                            settings=s._replace(outputs="color"))["color"]
        return torch.clamp(img, 0, 1)

    counters.reset()
    k_losses, k_g = run()
    launches = counters.read()
    k_img = render(k_g)
    saved = (blend.blend_raw_packed_cuda, blend.blend_raw_packed_bwd_cuda,
             segred.segmented_scan_cuda)
    blend.blend_raw_packed_cuda = blend.blend_raw_packed_plain
    blend.blend_raw_packed_bwd_cuda = blend.blend_raw_packed_bwd_plain
    segred.segmented_scan_cuda = segred.segmented_scan_plain
    try:
        p_losses, p_g = run()
        p_img = render(p_g)
    finally:
        (blend.blend_raw_packed_cuda, blend.blend_raw_packed_bwd_cuda,
         segred.segmented_scan_cuda) = saved
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    diff = (k_img - p_img).abs()
    log(f"frame0 regulariser: {F0_REG_STEPS} steps, losses {k_losses} "
        f"(kernels) vs {p_losses} (plain versions), max rel {rel:.3g} "
        f"(tolerance {TOL_REFINE_LOSS}); view 0 render afterwards mean "
        f"|diff| {float(diff.mean()):.3g} (tolerance {TOL_REFINE_IMAGE}), "
        f"max {float(diff.max()):.3g}; launches {json.dumps(launches)}")
    if (rel > TOL_REFINE_LOSS or float(diff.mean()) > TOL_REFINE_IMAGE
            or not all(math.isfinite(x) for x in k_losses)):
        raise RuntimeError("the regulariser steps disagree with the plain "
                           "versions")
    for k in ("blend_fwd_packed/full", "blend_bwd_packed/full"):
        if launches[k] != F0_REG_STEPS:
            raise RuntimeError(f"the regulariser path launched {k} "
                               f"{launches[k]} times")
    return launches


def train_config(root, workspace, max_pairs=0):
    """The training recipe's sections as dicts, with the data at 512² and
    the pair budget ``max_pairs`` (0: the default, ~2 per pixel)."""
    data = {"background_color": [0.0, 0.0, 0.0],
            "data_path": "train_scene_pairs.json", "root_dir": root,
            "gs_mode": "3dgs_rade", "iter": "6000_compress",
            "input_height": TRAIN_RES, "input_width": TRAIN_RES,
            "output_height": TRAIN_RES, "output_width": TRAIN_RES,
            "num_input_views": 4, "num_output_views": 6, "up_sample": True,
            "max_sh_degree": 3}
    return {"system": TRAIN_SYSTEM,
            "opt": dict(TRAIN_OPT, workspace=workspace, max_pairs=max_pairs),
            "data": {"data_cls": "igs.data.data.N3dDataset", "data": data}}


def write_train_scene(dev, root):
    """The training scene through the port's writer: 14 cameras at 512²,
    TRAIN_FRAMES frames of the smoke's 120 000-Gaussian recipe."""
    from igs_tpu_torch.data.synthetic import build_synthetic_scene
    from igs_tpu_torch.ops.rasterize import RasterSettings

    return build_synthetic_scene(
        root, scene_name="train_scene", n_frames=TRAIN_FRAMES, n_cams=N_CAMS,
        n_gaussians=N_GAUSSIANS, height=TRAIN_RES, width=TRAIN_RES,
        interval=INTERVAL, motion_scale=0.3, static_frac=STATIC_FRAC,
        opacity_range=(-0.5, 2.0), scale_range=(-5.0, -3.8),
        settings=RasterSettings(max_pairs=1 << 23), device=dev)


def densest_train_tile(cfg, dev):
    """Over the output views of every key frame's Gaussians (the batches'
    renders at the start, where the deformation is near the identity):
    the densest tile and the window the windowed route takes (the next
    power of two, at least 512), the most pairs of a view and the pair
    budget taken (the next power of two over 1.25 times that, at least
    the default)."""
    from igs_tpu_torch.builders import build_dataset, build_raster_settings
    from igs_tpu_torch.core.camera import Camera
    from igs_tpu_torch.data.ply import load_gaussian_ply
    from igs_tpu_torch.ops.rasterize import RasterSettings, build_pairs_packed

    ds = build_dataset(cfg["data"], training=True)
    s = RasterSettings(image_height=TRAIN_RES, image_width=TRAIN_RES,
                       max_pairs=1 << 23, outputs="color")
    densest = most = 0
    seen = set()
    for i in range(len(ds)):
        item = ds[i]
        if item["gs_path"] in seen:
            continue
        seen.add(item["gs_path"])
        g = load_gaussian_ply(item["gs_path"], device=dev)
        cams = Camera.stack([Camera.from_c2w(c, tuple(item["FOV"]),
                                             (TRAIN_RES, TRAIN_RES),
                                             device=dev)
                             for c in item["c2w_output"]])
        pairs = build_pairs_packed(g.get_xyz, g.get_opacity, g.get_scaling,
                                   g.get_rotation, cams, valid=g.valid,
                                   settings=s)
        densest = max(densest, int(pairs.tile_count.max()))
        most = max(most, int(pairs.num_pairs.max()))
    default = build_raster_settings(TRAIN_RES, TRAIN_RES).max_pairs
    return (densest, max(512, 1 << math.ceil(math.log2(max(densest, 1)))),
            most, max(default, 1 << math.ceil(math.log2(1.25 * most))))


class StepTimer:
    """CUDA events at the train step's stage marks and around every
    ``deform_and_render`` call of the AGM forward (the renders)."""

    def __init__(self, torch, agm_mod):
        self.torch, self.agm_mod = torch, agm_mod
        self.marks, self.renders = [], []
        self.inner = agm_mod.deform_and_render

        @functools.wraps(self.inner)
        def timed(*a, **k):
            e0 = self.event()
            out = self.inner(*a, **k)
            self.renders.append((e0, self.event()))
            return out

        agm_mod.deform_and_render = timed

    def event(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stage(self, name):
        if name == "start":  # renders of an eval between steps do not count
            self.marks, self.renders = [], []
        self.marks.append((name, self.event()))

    def take(self):
        """ms by stage of the step just taken."""
        self.marks[-1][1].synchronize()
        ms = {b[0]: a[1].elapsed_time(b[1])
              for a, b in zip(self.marks, self.marks[1:])}
        ms["render"] = sum(a.elapsed_time(b) for a, b in self.renders)
        ms["agm_forward"] = ms.pop("forward") - ms["render"]
        ms["step"] = self.marks[0][1].elapsed_time(self.marks[-1][1])
        return ms

    def close(self):
        self.agm_mod.deform_and_render = self.inner


class WindowGathers:
    """Counts the calls of ``blend_windowed.gather_tile_windows`` on CUDA
    tensors, with CUDA events around each, until ``close``. The windowed
    route's kernels read the pair rows in place, so only a plain version
    (or an earlier route) gathers a window on the card."""

    def __init__(self, bw):
        import torch

        self.bw, self.inner = bw, bw.gather_tile_windows
        self.calls, self.events = 0, []

        @functools.wraps(self.inner)
        def counted(feats_t, *a, **k):
            if not feats_t.is_cuda:
                return self.inner(feats_t, *a, **k)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = self.inner(feats_t, *a, **k)
            e1.record()
            self.calls += 1
            self.events.append((e0, e1))
            return out

        bw.gather_tile_windows = counted

    def take(self):
        """(calls, device ms) since the last take."""
        if self.events:
            self.events[-1][1].synchronize()
        out = (len(self.events),
               sum(a.elapsed_time(b) for a, b in self.events))
        self.events = []
        return out

    def close(self):
        self.bw.gather_tile_windows = self.inner


def run_training(cfg, dev, counters, maxpt, steps, impl="pallas",
                 timer=None, profile_step=None, gathers=None, label=None,
                 resume=None):
    """``train_agm.run`` for ``steps`` steps from the seeded weights; per
    step the metrics, the launches, (with ``timer``) ms by stage and (with
    ``gathers``, a ``WindowGathers``) the window gathers on the card and
    their ms; step ``profile_step`` runs under ``torch.profiler`` (its
    record adds the device busy ms and the profiled wall ms); ``resume``:
    the checkpoint ``train_agm.run`` resumes from."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from igs_tpu_torch import train_agm

    log_steps = []
    last = None
    prof = []

    def on_stage(name):
        nonlocal last
        if name == "start":  # an eval between steps launches too
            last = counters.read()
            if gathers is not None:
                gathers.take()
            if len(log_steps) + 1 == profile_step:
                torch.cuda.synchronize()
                p = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
                p.__enter__()
                prof[:] = [p, time.perf_counter()]
        if timer is not None:
            timer.stage(name)

    def on_step(step, m):
        profiled = {}
        if step == profile_step:
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - prof[1])
            prof[0].__exit__(None, None, None)
            profiled = {"profiled_wall_ms": wall_ms,
                        "profiled_busy_ms": log_profile(
                            prof[0], f"training step {step}", wall_ms, 20)}
        now = counters.read()
        rec = {"step": step, "loss": float(m["loss"]),
               **({"loss_lpips": float(m["loss_lpips"])}
                  if "loss_lpips" in m else {}),
               "psnr": float(m["psnr"]), "grad_norm": m["grad_norm"],
               "lr": m["lr"], "truncated_tiles": int(m["overflow_tiles"]),
               "launches": {k: now[k] - last[k] for k in now
                            if now[k] != last[k]}}
        rec.update(profiled)
        if gathers is not None:
            rec["window_gathers"], rec["window_gather_ms"] = gathers.take()
        if timer is not None:
            rec["ms"] = timer.take()
        log_steps.append(rec)
        log(f"train {label or impl}: {json.dumps(rec)}")

    out = train_agm.run(cfg, max_steps=steps, device=dev, impl=impl,
                        max_per_tile=maxpt, resume=resume,
                        generator=torch.Generator().manual_seed(0),
                        on_step=on_step, on_stage=on_stage)
    return out, log_steps


def train_check(dev, workspace, counters, bw, segred, agm_mod):
    """The training phase: the scene, the window, TRAIN_STEPS windowed
    steps (counters reset just before, read just after), then the first
    TRAIN_RERUN steps again through the packed route and through the
    windowed plain versions."""
    import os

    import torch

    t0 = time.perf_counter()
    root = os.path.join(workspace, "train_data")
    write_train_scene(dev, root)
    densest, maxpt, most, budget = densest_train_tile(
        train_config(root, ""), dev)
    log(f"train: scene {root}: {TRAIN_FRAMES} frames x {N_CAMS} views at "
        f"{TRAIN_RES}², {N_GAUSSIANS} Gaussians, written in "
        f"{time.perf_counter() - t0:.1f} s; densest tile {densest} pairs → "
        f"max_per_tile {maxpt}; most pairs of a view {most} → max_pairs "
        f"{budget}")
    cfg = train_config(root, os.path.join(workspace, "train_windowed"),
                       budget)

    timer = StepTimer(torch, agm_mod)
    gathers = WindowGathers(bw)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    try:
        out, steps = run_training(cfg, dev, counters, maxpt, TRAIN_STEPS,
                                  timer=timer, profile_step=TRAIN_PROFILED,
                                  gathers=gathers)
    finally:
        timer.close()
        gathers.close()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    # warm steps: past the first two, and not the profiled one
    warm = [r["ms"] for r in steps[2:] if r["step"] != TRAIN_PROFILED]
    mean_ms = {k: float(np.mean([w[k] for w in warm])) for k in warm[0]}
    mixed = mixed_precision_steps(root, workspace, dev, counters, maxpt,
                                  budget, agm_mod, steps, mean_ms, peak)
    launches = counters.read()
    profiled = next(r for r in steps if r["step"] == TRAIN_PROFILED)
    log(f"train: {len(steps)} steps in {wall:.2f} s wall (data prep, "
        f"checkpoint and eval included); mean ms per warm step (CUDA "
        f"events, {len(warm)} steps from step 3, the profiled one left "
        f"out) {json.dumps(mean_ms)}; peak memory {peak:.2f} GiB; window "
        f"gathers on the card {gathers.calls} ({profiled['window_gathers']} "
        f"in the profiled step {TRAIN_PROFILED}, "
        f"{profiled['profiled_busy_ms']:.1f} ms device busy); eval "
        f"{json.dumps(out['eval'])}; launches {json.dumps(launches)}")
    losses = [r["loss"] for r in steps]
    if len(steps) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"training losses: {losses}")
    if any(r["truncated_tiles"] for r in steps):
        raise RuntimeError("a training step truncated tiles past "
                           f"max_per_tile {maxpt}")
    for k in ("blend_fwd_win/full", "blend_bwd_win/full"):
        if launches[k] == 0:
            raise RuntimeError(f"the training path did not launch {k}")
    if gathers.calls:
        raise RuntimeError(f"the windowed route gathered {gathers.calls} "
                           "windows on the card")
    lpips_run = lpips_steps(root, workspace, dev, counters, maxpt, budget,
                            agm_mod, mean_ms, peak)
    resumed = flax_resume_check(out, root, workspace, dev, counters, maxpt,
                                budget)
    del out

    # the first steps again, from the same seeded state
    reruns = {"windowed": [r["loss"] for r in steps[:TRAIN_RERUN]]}
    cfg_p = train_config(root, os.path.join(workspace, "train_packed"),
                         budget)
    _, st = run_training(cfg_p, dev, counters, maxpt, TRAIN_RERUN,
                         impl="pallas_packed")
    reruns["packed"] = [r["loss"] for r in st]
    saved = (bw.blend_raw_cuda, bw.blend_raw_bwd_cuda,
             segred.segmented_scan_cuda)
    bw.blend_raw_cuda = bw.blend_raw_pairs_plain
    bw.blend_raw_bwd_cuda = bw.blend_raw_bwd_pairs_plain
    segred.segmented_scan_cuda = segred.segmented_scan_plain
    try:
        cfg_w = train_config(root, os.path.join(workspace, "train_plain"),
                             budget)
        _, st = run_training(cfg_w, dev, counters, maxpt, TRAIN_RERUN)
    finally:
        (bw.blend_raw_cuda, bw.blend_raw_bwd_cuda,
         segred.segmented_scan_cuda) = saved
    reruns["windowed_plain"] = [r["loss"] for r in st]
    first = reruns["windowed"][0]
    rel = {k: abs(v[0] - first) / abs(first) for k, v in reruns.items()}
    log(f"train: the first {TRAIN_RERUN} losses by route {json.dumps(reruns)}"
        f"; step-1 relative difference to the windowed kernels "
        f"{json.dumps(rel)} (tolerance {TOL_TRAIN_LOSS})")
    if max(rel.values()) > TOL_TRAIN_LOSS:
        raise RuntimeError("the routes disagree on the first step's loss")
    return {"launches": launches, "steps": steps, "mean_ms": mean_ms,
            "peak_gib": peak, "max_per_tile": maxpt, "max_pairs": budget,
            "mixed": mixed, "resumed": resumed, "root": root,
            "lpips": lpips_run}


def write_lpips_weights(path):
    """A seeded LPIPS ``state_dict`` (lpipsPyTorch's names) written with
    ``torch.save``: the weights file of the LPIPS term and the metrics."""
    import torch

    from igs_tpu_torch.train.lpips import LPIPS

    torch.save(LPIPS(generator=torch.Generator().manual_seed(LPIPS_SEED))
               .state_dict(), path)
    return path


def lpips_steps(root, workspace, dev, counters, maxpt, budget, agm_mod,
                f32_ms, f32_peak):
    """LPIPS_STEPS steps through ``train_agm.run`` with ``opt.lambda_lpips``
    and ``opt.lpips_weights`` (a seeded LPIPS written by the port) on the
    windowed kernels, counters reset just before and read just after (the
    "lpips" path): the file must load 18 tensors, every ``loss_lpips``
    must be finite and > 0, and both windowed kernels must launch; the
    LPIPS forward and backward ms inside the step and the peak memory
    logged beside the float32 steps'. Then the LPIPS on the card against
    the port's CPU LPIPS on the same 256² batch (the key frames' output
    views, 12 images a side) and weights: TOL_LPIPS_REL."""
    import contextlib
    import os

    import torch

    from igs_tpu_torch.builders import build_dataset
    from igs_tpu_torch.train.driver import lpips_prep
    from igs_tpu_torch.train.lpips import make_lpips

    weights = write_lpips_weights(os.path.join(workspace, "lpips.pth"))
    cfg = train_config(root, os.path.join(workspace, "train_lpips"), budget)
    cfg["opt"] = dict(cfg["opt"], lambda_lpips=LPIPS_LAMBDA,
                      lpips_weights=weights)
    timer = StepTimer(torch, agm_mod)
    tee = Tee(sys.stdout)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    try:
        with contextlib.redirect_stdout(tee):
            _, steps = run_training(cfg, dev, counters, maxpt, LPIPS_STEPS,
                                    timer=timer, label="pallas lpips")
    finally:
        timer.close()
    launches = counters.read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm = steps[1:]  # past the first step's set-up
    ms = {k: float(np.mean([r["ms"][k] for r in warm]))
          for k in warm[0]["ms"]}
    losses = [r.get("loss_lpips", float("nan")) for r in steps]
    log(f"train lpips: loss_lpips by step {losses}; mean ms of steps 2-"
        f"{LPIPS_STEPS} (CUDA events) {json.dumps(ms)}: the LPIPS forward "
        f"{ms.get('lpips', float('nan')):.2f} ms and backward "
        f"{ms.get('lpips_backward', float('nan')):.2f} ms of a "
        f"{ms['step']:.2f} ms step, beside float32's warm mean without "
        f"the term {json.dumps(f32_ms)}; peak memory {peak:.2f} GiB beside "
        f"{f32_peak:.2f} GiB; launches {json.dumps(launches)}; card "
        f"{card_line()}")
    if f"loaded 18 LPIPS tensors from {weights}" not in "".join(tee.text):
        raise RuntimeError("train lpips: the run did not load the 18 LPIPS "
                           "tensors of the weights file")
    if len(steps) != LPIPS_STEPS or not all(
            math.isfinite(x) and x > 0 for x in losses):
        raise RuntimeError(f"train lpips: loss_lpips {losses}")
    if not all(math.isfinite(r["loss"]) for r in steps):
        raise RuntimeError("train lpips: a non-finite loss")
    if any(r["truncated_tiles"] for r in steps):
        raise RuntimeError("train lpips: a step truncated tiles")
    for k in ("blend_fwd_win/full", "blend_bwd_win/full"):
        if launches[k] == 0:
            raise RuntimeError(f"the lpips path did not launch {k}")
    if "lpips" not in ms or "lpips_backward" not in ms:
        raise RuntimeError(f"train lpips: no LPIPS stage marks in {ms}")

    # the card's LPIPS against the CPU's, on the same 256² batch
    ds = build_dataset(cfg["data"], training=True)
    imgs = [torch.from_numpy(ds[i]["images_output"]) for i in range(4)]
    x = lpips_prep(torch.stack(imgs[:2]))
    y = lpips_prep(torch.stack(imgs[2:]))
    fn_card, ok_card = make_lpips(weights, device=dev)
    fn_cpu, ok_cpu = make_lpips(weights, device="cpu")
    with torch.no_grad():
        got = fn_card(x.to(dev), y.to(dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fn_cpu(x, y)
        cpu_s = time.perf_counter() - t0
        card_ms = cuda_ms(lambda: fn_card(x.to(dev), y.to(dev)), 5)
    rel = float(((got.cpu() - want).abs() / want.abs()).max())
    log(f"lpips card vs cpu: {tuple(x.shape)} a side, LPIPS {want.tolist()}"
        f"; max relative difference {rel:.3g} (tolerance {TOL_LPIPS_REL}); "
        f"{card_ms:.2f} ms on the card (CUDA events, forward of both "
        f"sides), {cpu_s:.2f} s on the CPU; card {card_line()}")
    if not (ok_card and ok_cpu) or rel > TOL_LPIPS_REL:
        raise RuntimeError("the LPIPS on the card disagrees with the CPU's "
                           f"({rel:.3g}) or its weights did not load")
    return {"launches": launches, "steps": steps, "ms": ms, "peak_gib": peak,
            "card_vs_cpu_rel": rel, "weights": weights}


def flax_resume_check(out, root, workspace, dev, counters, maxpt, budget):
    """The JAX package's checkpoint layout on the card (ROADMAP A10): the
    trained model and optimizer written as ``params.msgpack`` and its
    ``.opt`` through ``utils/flax_msgpack.dumps``, read back bit for bit,
    and one step resumed from them through ``train_agm.run``, whose loss
    must equal that of the step resumed from the port's own ``.pth``."""
    import os

    import torch

    from igs_tpu_torch.models.convert import flax_from_state_dict
    from igs_tpu_torch.train.driver import (
        flax_optimizer_state, load_flax_checkpoint, read_optimizer_state,
        save_checkpoint)
    from igs_tpu_torch.utils import flax_msgpack

    model, opt = out["model"], out["optimizer"]
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    ckdir = os.path.join(workspace, "train_ckpt")
    os.makedirs(ckdir, exist_ok=True)
    msgpack_path = os.path.join(ckdir, "params.msgpack")
    t0 = time.perf_counter()
    flax_msgpack.dump(msgpack_path, {"params": flax_from_state_dict(sd),
                                     "step": out["steps"]})
    flax_msgpack.dump(msgpack_path + ".opt", flax_optimizer_state(opt, sd))
    write_s = time.perf_counter() - t0
    pth = os.path.join(ckdir, "params.pth")
    save_checkpoint(pth, sd, opt.state_dict(), step=out["steps"])

    t0 = time.perf_counter()
    got, step = load_flax_checkpoint(msgpack_path, sd)
    state = read_optimizer_state(msgpack_path + ".opt", opt)
    read_s = time.perf_counter() - t0
    bad = [k for k in sd if not torch.equal(got[k], sd[k])]
    bad += [f"{name}.{k}" for name in ("mu", "nu")
            for k, v in getattr(opt, name).items()
            if not torch.equal(state[name][k], v.cpu())]
    if (bad or step != out["steps"] or state["count"] != opt.count
            or state["mini_step"] != opt.mini_step):
        raise RuntimeError(f"the flax-layout checkpoint does not read back "
                           f"as written: {bad[:8]}, step {step}, count "
                           f"{state['count']} of {opt.count}")
    sizes = {p: os.path.getsize(p) for p in (msgpack_path,
                                             msgpack_path + ".opt")}
    losses = {}
    for name, path in (("msgpack", msgpack_path), ("pth", pth)):
        cfg = train_config(root, os.path.join(workspace, f"train_{name}"),
                           budget)
        res, st = run_training(cfg, dev, counters, maxpt, 1, resume=path,
                               label=f"pallas resumed from {name}")
        losses[name] = st[0]["loss"]
        if res["optimizer"].count != opt.count + 1:
            raise RuntimeError(f"resumed from {name}: optimizer count "
                               f"{res['optimizer'].count}, want "
                               f"{opt.count + 1}")
    log(f"train flax checkpoint: {len(sd)} tensors and the optimizer state "
        f"(count {opt.count}) written in {write_s:.2f} s ({sizes} bytes), "
        f"read back bit-equal in {read_s:.2f} s; step {opt.count + 1} "
        f"resumed from each: loss {json.dumps(losses)}")
    if losses["msgpack"] != losses["pth"]:
        raise RuntimeError("the step resumed from the flax files has another "
                           "loss than the one resumed from the .pth")
    return {"tensors": len(sd), "losses": losses, "write_s": write_s,
            "read_s": read_s, "bytes": sizes}


def flow_views(batch, gs, dev):
    """Over the batch's output views at FLOW_HW: the densest tile and the
    most pairs of a view, of all the valid Gaussians (the flow renders the
    masked ones among them)."""
    from igs_tpu_torch.core.camera import Camera
    from igs_tpu_torch.ops.rasterize import RasterSettings, build_pairs_packed

    s = RasterSettings(image_height=FLOW_HW[0], image_width=FLOW_HW[1],
                       max_pairs=1 << 23, outputs="color")
    densest = most = 0
    for b in range(batch["c2w_output"].shape[0]):
        g = gs.map(lambda x: x[b])
        fov = (batch["FOV"][b, 0], batch["FOV"][b, 1])
        cams = Camera.stack([Camera.from_c2w(c, fov, FLOW_HW)
                             for c in batch["c2w_output"][b]])
        pairs = build_pairs_packed(g.get_xyz, g.get_opacity, g.get_scaling,
                                   g.get_rotation, cams, valid=g.valid,
                                   settings=s)
        densest = max(densest, int(pairs.tile_count.max()))
        most = max(most, int(pairs.num_pairs.max()))
    return densest, most


def flow_check(dev, root, budget, maxpt, counters, blend, bw):
    """AGM-Net with ``render_flow`` on a training batch (two items, six
    output views at 512²; the flow at FLOW_HW): one forward through the
    windowed route (the flow on B5a, color mode) and one through the
    packed route (B1), counters reset just before each and read just
    after; each forward timed with and without the flow render and rerun
    with the route's plain version, flow_pred and flow_mask held to it.
    The residual heads are drawn small from the seed (at their zero init
    the flow is zero)."""
    import torch

    from igs_tpu_torch.builders import (
        build_dataset, build_model, build_raster_settings)
    from igs_tpu_torch.train_agm import prep_batch

    cfg = train_config(root, "")
    ds = build_dataset(cfg["data"], training=True)
    batch, state, gs = prep_batch(ds, [ds[0], ds[1]], dev, ANCHORS, 8)
    system = dict(TRAIN_SYSTEM, renderer={
        "render_flow": True, "flow_height": FLOW_HW[0],
        "flow_width": FLOW_HW[1]})
    gen = torch.Generator().manual_seed(0)
    model = build_model(system, device=dev, generator=gen)
    with torch.no_grad():
        for layer, scale in ((model.render.out_layers[0], 1e-3),
                             (model.render.out_layers[1], 1e-2)):
            layer.weight.copy_(scale * torch.randn(layer.weight.shape,
                                                   generator=gen))
    densest, most = flow_views(batch, gs, dev)
    max_pairs = max(budget, 1 << math.ceil(math.log2(1.25 * most)))
    window = max(maxpt, 1 << math.ceil(math.log2(max(densest, 1))))
    log(f"flow: {FLOW_HW[0]}x{FLOW_HW[1]} flow of 2 items x "
        f"{batch['c2w_output'].shape[1]} views; densest tile {densest}, most "
        f"pairs of a view {most} → max_pairs {max_pairs}, max_per_tile "
        f"{window}")
    plain = {"pallas": ((bw, "blend_raw_cuda"), bw.blend_raw_pairs_plain),
             "pallas_packed": ((blend, "blend_raw_packed_cuda"),
                               blend.blend_raw_packed_plain)}
    n_flow = 2 * batch["c2w_output"].shape[1]
    results, launches = [], {}
    for impl, kernel in (("pallas", "blend_fwd_win/color"),
                         ("pallas_packed", "blend_fwd_packed/color")):
        settings = build_raster_settings(
            TRAIN_RES, TRAIN_RES, clamp=True, max_pairs=max_pairs,
            max_per_tile=window, impl=impl)

        def forward():
            return model(batch, state, gs, settings)

        with torch.no_grad():
            counters.reset()
            out = forward()
            torch.cuda.synchronize()
            counts = counters.read()
            ms = cuda_ms(forward, reps=FLOW_REPS)
            model.render_flow = False
            ms_without = cuda_ms(forward, reps=FLOW_REPS)
            model.render_flow = True
            (mod, attr), plain_fn = plain[impl]
            kernel_fn = getattr(mod, attr)
            setattr(mod, attr, plain_fn)
            try:
                ref = forward()
            finally:
                setattr(mod, attr, kernel_fn)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        fp, fm = out["flow_pred"], out["flow_mask"]
        rp, rm = ref["flow_pred"], ref["flow_mask"]
        # the flow is in pixels and divides by the world z of the means,
        # so a few Gaussians near z = 0 carry huge flows: phase 4's 2e-4 is
        # taken relative to 1 + |flow| pixel by pixel; a pixel off it, or
        # whose mask moved past 2e-4 (a pair taken on one side only), is a
        # flip
        scale = float(rp.abs().max())
        diff = (fp - rp).abs()
        err = float(diff.max())
        rel = float((diff / (1 + rp.abs())).max())
        flip = ((fm - rm).abs() > TOL_ABS) | (
            diff > TOL_ABS * (1 + rp.abs())).any(dim=2)
        rec = {"route": impl, "flow_pred": list(fp.shape),
               "flow_mask": list(fm.shape), "max_abs_flow": scale,
               "max_abs_err": err, "max_err_rel_1_plus_flow": rel,
               "max_mask_err": float((fm - rm).abs().max()),
               "flips": int(flip.sum()), "pixels": flip.numel(),
               "ms_with_flow": ms,
               "ms_without_flow": ms_without, "kernel_launches": counts[
                   kernel], "launches": {k: v for k, v in counts.items()
                                         if v}}
        log(f"flow {impl}: {json.dumps(rec)}")
        ok = (tuple(fp.shape) == (2, n_flow // 2, 2) + FLOW_HW
              and tuple(fm.shape) == (2, n_flow // 2) + FLOW_HW
              and bool(torch.isfinite(fp).all()) and scale > 0
              and rec["flips"] <= TOL_FLIP_FRAC * flip.numel()
              and counts[kernel] == n_flow
              and int(out["overflow_tiles"].max()) == 0)
        if not ok:
            raise RuntimeError(
                f"flow render on {impl}: wrong shape, launches, overflow, "
                f"or off its plain version (flow within {TOL_ABS}·(1 + "
                f"|flow|) and mask within {TOL_ABS} but on at most "
                f"{TOL_FLIP_FRAC} of the pixels)")
        results.append(rec)
    return results, launches


def mixed_precision_steps(root, workspace, dev, counters, maxpt, budget,
                          agm_mod, f32_steps, f32_ms, f32_peak):
    """TRAIN_RERUN steps with ``opt.mixed_precision: bf16`` from the same
    seeded state as the float32 steps, on the windowed kernels (their
    launches count to the training path): every loss finite, the first
    within TOL_MIXED_LOSS of the float32 one; ms by stage and the peak
    memory logged beside the float32 steps'."""
    import os

    import torch

    cfg = train_config(root, os.path.join(workspace, "train_bf16"), budget)
    cfg["opt"] = dict(cfg["opt"], mixed_precision="bf16")
    timer = StepTimer(torch, agm_mod)
    torch.cuda.reset_peak_memory_stats()
    try:
        _, steps = run_training(cfg, dev, counters, maxpt, TRAIN_RERUN,
                                timer=timer, label="pallas bf16")
    finally:
        timer.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in steps]
    f32 = [r["loss"] for r in f32_steps[:TRAIN_RERUN]]
    rel = abs(losses[0] - f32[0]) / abs(f32[0])
    warm = steps[-1]["ms"]  # past the first step's set-up
    log(f"train bf16: losses {losses} beside float32 {f32}; step-1 "
        f"relative difference {rel:.3g} (tolerance {TOL_MIXED_LOSS}); ms by "
        f"stage of step {TRAIN_RERUN} {json.dumps(warm)} beside float32's "
        f"warm mean {json.dumps(f32_ms)}; peak memory {peak:.2f} GiB "
        f"beside float32's {f32_peak:.2f} GiB")
    if len(steps) != TRAIN_RERUN or not all(math.isfinite(x)
                                            for x in losses):
        raise RuntimeError(f"mixed-precision training losses: {losses}")
    if rel > TOL_MIXED_LOSS:
        raise RuntimeError("the mixed-precision step's first loss is "
                           f"{rel:.3g} off the float32 one")
    return {"losses": losses, "ms": warm, "peak_gib": peak,
            "rel_first_loss": rel}


def profile_refine_step(pipe, ra, blend, segred):
    """One refine step timed by stage with CUDA events, and one under
    ``torch.profiler`` (device busy, idle share)."""
    from dataclasses import replace

    import torch
    from torch.profiler import ProfilerActivity, profile

    from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
    from igs_tpu_torch.ops.blend import (
        blend_raw_packed, pack_features, raw_to_outputs_color)
    from igs_tpu_torch.ops.projection import project
    from igs_tpu_torch.ops.segred import gather_pairs
    from igs_tpu_torch.stream.refine import (
        TRAINABLE, init_refine_state, loss_and_grads, refine_step)
    from igs_tpu_torch.train.losses import l1_loss, ssim

    st = init_refine_state(ra["gaussians"].map(lambda x: x.clone()),
                           ra["capacity"])
    v = ra["order"][0]
    cam, gt, bg, cfg, s = (ra["cams"].view(v), ra["gts"][v], ra["bg"],
                           ra["cfg"], ra["settings"])
    refine_step(st, cam, gt, bg, cfg, s)  # warm-up
    h, w = OUT_HW
    gx, gy = image_tile_grid(h, w)
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    spans = {"blend_bwd": [], "segscan": []}

    def timed(fn, key):
        # wraps: the kernel wrapper counts its launches on the name it is
        # bound to, which is this function while the profile runs
        @functools.wraps(fn)
        def run(*a, **k):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = fn(*a, **k)
            e1.record()
            spans[key].append((e0, e1))
            return out
        return run

    g = st.gaussians
    torch.cuda.synchronize()
    mark("start")
    params = {k: getattr(g, k).detach().requires_grad_(True)
              for k in TRAINABLE}
    m2o = torch.zeros((g.num_capacity, 2), device=g.xyz.device,
                      requires_grad=True)
    gg = replace(g, **params)
    proj = project(gg.get_xyz, gg.get_scaling, gg.get_rotation,
                   gg.get_opacity, cam.batched(), shs=gg.shs, valid=gg.valid,
                   geometry=False)
    scale = torch.tensor([0.5 * w, 0.5 * h], device=g.xyz.device)
    proj = proj._replace(means2d=proj.means2d + m2o * scale)
    mark("projection")
    pairs = build_tile_pairs(proj, gx, gy, s.max_pairs, segred_aux=True)
    mark("binning")
    rows = pack_features(proj)[..., :16].reshape(-1, 16).t().contiguous()
    feats_t = gather_pairs(rows, pairs.gauss_id, pairs.exp_to_sorted,
                           pairs.exp_gauss_id, pairs.gauss_last_row)
    mark("gather")
    raw = blend_raw_packed(feats_t, pairs.tile_start, pairs.tile_count, gx,
                           gy, "color")
    mark("blend forward")
    img = raw_to_outputs_color(raw, 1, gx, gy, h, w, bg).color[0]
    loss = cfg.lambda_l1 * l1_loss(img, gt) + (1 - cfg.lambda_l1) * (
        1.0 - ssim(img, gt)[0])
    mark("loss")
    saved = (blend.blend_raw_packed_bwd_cuda, segred.segmented_scan_cuda)
    blend.blend_raw_packed_bwd_cuda = timed(saved[0], "blend_bwd")
    segred.segmented_scan_cuda = timed(saved[1], "segscan")
    try:
        torch.autograd.grad(loss, list(params.values()) + [m2o])
    finally:
        blend.blend_raw_packed_bwd_cuda, segred.segmented_scan_cuda = saved
    mark("backward")
    torch.cuda.synchronize()
    stage = {b[0]: a[1].elapsed_time(b[1]) for a, b in zip(marks, marks[1:])}
    total = marks[0][1].elapsed_time(marks[-1][1])
    bwd = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    stage["blend backward"] = bwd["blend_bwd"]
    stage["segscan"] = bwd["segscan"]
    stage["rest of autograd"] = stage.pop("backward") - sum(bwd.values())

    def ev_ms(fn):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    step_ms = ev_ms(lambda: refine_step(st, cam, gt, bg, cfg, s))
    grads_ms = ev_ms(lambda: loss_and_grads(g, cam, gt, bg, cfg, s))
    stage["Adam and densify stats"] = step_ms - grads_ms
    log(f"refine step by stage (CUDA events, ms): loss and grads "
        f"{total:.3f}, {json.dumps(stage)}; a whole refine_step "
        f"{step_ms:.3f}, loss_and_grads {grads_ms:.3f}")
    blend_ms = stage["blend forward"] + stage["blend backward"]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        refine_step(st, cam, gt, bg, cfg, s)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    log_profile(prof, "one refine step", wall_ms, 20)
    return {"refine_step_ms": step_ms,
            "refine_blend_fwd_ms": stage["blend forward"],
            "refine_blend_bwd_ms": stage["blend backward"],
            "refine_blend_share": blend_ms / step_ms}


def log_profile(prof, what, wall_ms, top):
    """Log the device busy time, idle share and the ``top`` kernels by
    device time of a ``torch.profiler`` run, and every attention kernel
    below them: device-side events only (kernels, copies), since the aten
    ops that launched them carry the same device time again. Returns the
    busy ms."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"profile: {what}, {wall_ms:.1f} ms wall (profiled), device busy "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    if not rows:
        log("profile: the profiler saw no device time")
    for key, ms, n in rows[:top]:
        log(f"profile: {ms:9.3f} ms  x{n:<5d} {key[:100]}")
    # every attention kernel, so that each SDPA call's backend shows
    for key, ms, n in rows[top:]:
        if re.search("sdpa|fmha|flash|attention", key, re.I):
            log(f"profile: {ms:9.3f} ms  x{n:<5d} {key[:100]} (attention)")
    return busy_ms


def layer_ms(pipe, forward, torch):
    """CUDA-event ms of each top-level AGM-Net module over one forward
    (``render`` is the residual decoder); the rest (deform, projection,
    binning, blend, untiling, resizes) is the total less their sum."""
    spans = {}
    hooks = []
    for name, mod in pipe.model.named_children():
        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans.setdefault(name, []).append([ev, None])

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[name][-1][1] = ev

        hooks += [mod.register_forward_pre_hook(pre),
                  mod.register_forward_hook(post)]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    try:
        start.record()
        forward()
        end.record()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    ms = {name: sum(a.elapsed_time(b) for a, b in evs)
          for name, evs in spans.items()}
    total = start.elapsed_time(end)
    ms["rest"] = total - sum(ms.values())
    log(f"layers: one AGM forward {total:.2f} ms (CUDA events); "
        f"{json.dumps(ms)}")


def profile_window(pipe, stream, torch):
    """Device time by kernel over one AGM forward of the first window."""
    from torch.profiler import ProfilerActivity, profile

    from igs_tpu_torch.ops.anchors import AnchorState, select_anchors

    cfg = pipe.cfg
    batch = stream.collate([stream[i] for i in range(B)])
    g = batch["gs"][0].to(pipe.device).pad_to(cfg.max_num)
    jbatch = {k: pipe._tensor(v) for k, v in batch.items()
              if isinstance(v, np.ndarray)}
    with torch.inference_mode():
        state1 = select_anchors(g.xyz, jbatch["bounding_box"][0],
                                valid=g.valid, anchor_size=cfg.anchor_size,
                                k=cfg.neighbor_k)
        state = AnchorState(*(x.expand((B,) + x.shape) for x in state1))
        gs = g.map(lambda x: x.expand((B,) + x.shape))
        layer_ms(pipe, lambda: pipe._agm(jbatch, state, gs,
                                         cfg.shared_window_pairs), torch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe._agm(jbatch, state, gs, cfg.shared_window_pairs)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    log_profile(prof, "one AGM forward", wall_ms, 25)


# the streaming CLI's phase: the JAX results.json keys
# (igs_tpu/stream/pipeline.py:580-591)
RESULTS_KEYS = ("psnr", "avg", "total_time", "sec/frame", "mask_num",
                "points_num", "fps", "per_frame_times", "AGM_times",
                "overflow_events")
TOL_CLI_PSNR = 0.5  # dB a frame, bf16 against float32, random weights
# the metrics CLI on the bf16 run's eval frames: PNG, then JPEG copies of
# renders and GT (the port's encoder, quality 95): PSNR and SSIM a frame
# may move by these between the two (at 48×64 on the CPU they moved by
# up to 0.55 dB and 0.013; a broken decoder moves them by many dB)
METRICS_QUALITY = 95
TOL_METRICS_PSNR = 1.0
TOL_METRICS_SSIM = 0.05
# the enerf run: one window with its key-frame refine on an ENeRF-layout
# copy of the scene (images_2 and images_512 as JPEGs from the port's
# encoder); a decoded frame must sit this close to its source PNG
ENERF_QUALITY = 95
ENERF_MIN_PSNR = 30.0
BF16_FLAGS = ("encoder_bf16", "cnn_bf16", "ft_bf16")


class Tee:
    """Standard output both logged and kept."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def write_cli_weights(root):
    """A reference IGS ``.pth`` (every tensor but the backbone's, in a
    ``{"model": ...}`` wrapper) and a GMFlow ``.pth`` (the backbone's,
    under GMFlow's names) of a port model seeded 1, its zero-init residual
    heads drawn small from the same generator so that the deform follows
    the network. Returns the two paths and their tensor counts."""
    import os

    import torch

    from igs_tpu_torch.builders import build_model

    gen = torch.Generator().manual_seed(1)
    sd = build_model(SYSTEM, device="cpu", generator=gen).state_dict()
    for k, scale in (("render.out_layers.0.weight", 1e-3),
                     ("render.out_layers.1.weight", 1e-2)):
        sd[k] = scale * torch.randn(sd[k].shape, generator=gen)
    igs = {k: v for k, v in sd.items() if not k.startswith("backbone.")}
    gmflow = {k[len("backbone."):]: v for k, v in sd.items()
              if k.startswith("backbone.")}
    paths = (os.path.join(root, "igs.pth"), os.path.join(root, "gmflow.pth"))
    torch.save({"model": igs}, paths[0])
    torch.save({"model": gmflow}, paths[1])
    return paths, (len(igs), len(gmflow))


def cli_phase(dev, workspace, counters):
    """The streaming CLI at full width: an on-disk N3DV-layout scene from
    the port's writer, the weights as reference files, and
    ``infer_stream.run`` at the card's default (bf16) and with the three
    flags off, counters reset just before each and read just after; each
    run checked, the bf16 and float32 AGM forwards profiled."""
    import contextlib
    import os

    import torch

    from igs_tpu_torch import infer_stream
    from igs_tpu_torch.data.synthetic import build_synthetic_scene
    from igs_tpu_torch.ops.rasterize import RasterSettings

    t0 = time.perf_counter()
    root = os.path.join(workspace, "cli_scene")
    scene = build_synthetic_scene(
        root, n_frames=2 * B + 1, n_cams=N_CAMS, n_gaussians=N_GAUSSIANS,
        height=IN_RES, width=IN_RES, interval=INTERVAL, motion_scale=0.15,
        static_frac=STATIC_FRAC, opacity_range=(-0.5, 2.0),
        scale_range=(-5.0, -3.8), out_height=OUT_HW[0], out_width=OUT_HW[1],
        settings=RasterSettings(max_pairs=1 << 23), device=dev)
    (igs, gmflow), (n_igs, n_gmflow) = write_cli_weights(root)
    log(f"cli: scene {root}: {2 * B + 1} frames x {N_CAMS} views, inputs "
        f"{IN_RES}², outputs {OUT_HW[0]}x{OUT_HW[1]}, {N_GAUSSIANS} "
        f"Gaussians; weights {igs} ({n_igs} tensors) and {gmflow} "
        f"({n_gmflow}); written in {time.perf_counter() - t0:.1f} s")
    data = {"background_color": [0.0, 0.0, 0.0],
            "data_path": scene["pairs"], "root_dir": root,
            "gs_mode": "3dgs_rade", "iter": "6000_compress",
            "input_height": IN_RES, "input_width": IN_RES,
            "output_height": OUT_HW[0], "output_width": OUT_HW[1],
            "scene_type": "n3d", "depth_id_offset": 0, "up_sample": True,
            "max_sh_degree": 3, "start_gs_path": scene["start_gs_path"]}
    pipes = []

    class Captured(infer_stream.StreamingPipeline):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            pipes.append(self)

    runs, launches = {}, {}
    infer_stream.StreamingPipeline, inner = Captured, \
        infer_stream.StreamingPipeline
    try:
        for name, flags in (("bf16", {}),
                            ("f32", dict.fromkeys(BF16_FLAGS, False))):
            ws = os.path.join(workspace, f"cli_{name}")
            backbone = dict(SYSTEM["backbone"],
                            pretrained_model_name_or_path=gmflow)
            sections = {"system": dict(SYSTEM, backbone=backbone, **flags),
                        "opt": dict(OPT, workspace=ws, resume=igs),
                        "data": {"data_cls": "igs.data.infer_data.N3dDataset",
                                 "data": data}}
            tee = Tee(sys.stdout)
            counters.reset()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee):
                res = infer_stream.run(sections, max_batches=2, device=dev)
            wall = time.perf_counter() - t0
            launches[name] = counters.read()
            runs[name] = cli_check(name, res, pipes[-1], ws, "".join(
                tee.text), (n_igs, n_gmflow), wall, launches[name])
        diff = {k: runs["bf16"]["psnr"][k] - runs["f32"]["psnr"][k]
                for k in runs["f32"]["psnr"]}
        log(f"cli: psnr bf16 - f32 by frame {json.dumps(diff)} (tolerance "
            f"{TOL_CLI_PSNR} dB)")
        if not all(abs(d) <= TOL_CLI_PSNR for d in diff.values()):
            raise RuntimeError("the bf16 stream's PSNR is off the float32 one")

        # the bf16 run's weights as the JAX package's native checkpoint,
        # and the stream again with free_view
        from igs_tpu_torch.models.convert import flax_from_state_dict
        from igs_tpu_torch.utils import flax_msgpack

        sd = pipes[0].model.state_dict()
        ckpt = os.path.join(root, "params.msgpack")
        flax_msgpack.dump(ckpt, {"params": flax_from_state_dict(sd),
                                 "step": 0})
        ws = os.path.join(workspace, "cli_free_view")
        backbone = dict(SYSTEM["backbone"],
                        pretrained_model_name_or_path=gmflow)
        sections = {"system": dict(SYSTEM, backbone=backbone),
                    "opt": dict(OPT, workspace=ws, resume=ckpt,
                                free_view=True),
                    "data": {"data_cls": "igs.data.infer_data.N3dDataset",
                             "data": data}}
        tee = Tee(sys.stdout)
        counters.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            res = infer_stream.run(sections, max_batches=2, device=dev)
        wall = time.perf_counter() - t0
        launches["free_view"] = counters.read()
        free_view_check(res, pipes[-1], ws, "".join(tee.text), ckpt,
                        (len(sd), n_gmflow), wall, launches, runs["bf16"])

        # the metrics CLI on the bf16 run's frames, then the enerf layout
        metrics_check(workspace, pipes[0])
        enerf_launches = enerf_check(dev, workspace, root, data, igs, gmflow,
                                     counters, pipes)
    finally:
        infer_stream.StreamingPipeline = inner
    for name, pipe in zip(("bf16", "f32"), pipes):
        log(f"cli: profiles of the {name} run's AGM forward")
        profile_window(pipe, pipe.dataset, torch)
    keys = dict.fromkeys(k for ls in launches.values() for k in ls)
    return ({k: sum(ls[k] for ls in launches.values()) for k in keys},
            enerf_launches)


def cli_check(name, res, pipe, ws, out, counts, wall, launches):
    """One CLI run: the JAX results keys, no overflow, the eval PNGs, each
    refine lowering its loss, both overlays loading every tensor, the
    flags as asked and the kernels launched; logged."""
    import os

    import torch

    from igs_tpu_torch.data.images import read_png

    dtypes = {
        "cnn": pipe.model.backbone.backbone.conv1.compute_dtype,
        "ft": pipe.model.backbone.transformer.layers[0].self_attn.q_proj
        .compute_dtype,
        "encoder": pipe.model.triplane_encoder.conv.transformer_blocks[0]
        .attn1.dtype}
    log(f"cli {name}: {wall:.2f} s wall; compute types "
        f"{ {k: str(v) for k, v in dtypes.items()} }; psnr "
        f"{json.dumps(res['psnr'])} avg {res['avg']:.4f}; AGM_times "
        f"{res['AGM_times']}; sec/frame {res['sec/frame']:.4f}; "
        f"fps(render) {res['fps']:.3f}; points_num {res['points_num']}; "
        f"overflow_events {res['overflow_events']}; launches "
        f"{json.dumps(launches)}")
    want = torch.bfloat16 if name == "bf16" else None
    if set(dtypes.values()) != {want}:
        raise RuntimeError(f"cli {name}: compute types {dtypes}")
    with open(os.path.join(ws, "results.json")) as f:
        saved = json.load(f)
    if set(saved) != set(RESULTS_KEYS):
        raise RuntimeError(f"cli {name}: results.json keys {sorted(saved)}")
    psnr = list(res["psnr"].values())
    if len(psnr) != 2 * B or not all(math.isfinite(p) for p in psnr):
        raise RuntimeError(f"cli {name}: PSNR {psnr}")
    if res["overflow_events"]:
        raise RuntimeError(f"cli {name}: overflow {res['overflow_events']}")
    pngs = sorted(os.listdir(os.path.join(ws, "eval_pred")))
    if pngs != [f"{i:05d}.png" for i in range(2 * B)]:
        raise RuntimeError(f"cli {name}: eval PNGs {pngs}")
    img = read_png(os.path.join(ws, "eval_pred", pngs[-1]))
    if img.shape != OUT_HW + (3,) or img.dtype != np.uint8:
        raise RuntimeError(f"cli {name}: eval PNG {img.shape} {img.dtype}")
    loaded = [int(n) for n in re.findall(r"loaded (\d+) ", out)]
    if sorted(loaded) != sorted(counts):
        raise RuntimeError(f"cli {name}: the overlays loaded {loaded} "
                           f"tensors of {list(counts)}")
    if len(pipe.refine_log) != 2:
        raise RuntimeError(f"cli {name}: {len(pipe.refine_log)} refines")
    for rec in pipe.refine_log:
        losses = rec["losses"]
        first5, last5 = np.mean(losses[:5]), np.mean(losses[-5:])
        log(f"cli {name}: refine key {rec['key']}: {rec['ms_per_step']:.3f}"
            f" ms/step, loss first 5 {first5:.5f} last 5 {last5:.5f}, eval "
            f"PSNR {rec['eval_psnr_before']:.4f} → "
            f"{rec['eval_psnr_after']:.4f}")
        if not last5 < first5:
            raise RuntimeError(f"cli {name}: refine loss did not fall")
    for k in ("blend_fwd_packed/color", "blend_fwd_packed/color_depth",
              "blend_bwd_packed/color", "segmented_scan"):
        if launches[k] == 0:
            raise RuntimeError(f"cli {name}: did not launch {k}")
    return res


def free_view_check(res, pipe, ws, out, ckpt, counts, wall, launches,
                    bf16):
    """The free-view CLI run, resumed from ``params.msgpack`` (the bf16
    run's weights): every tensor loaded, the per-frame PSNR the bf16 run's
    bit for bit, one PLY and one spiral PNG a frame, the MJPEG video, one
    B1 launch a frame more than the bf16 run, and one spiral view through
    B1 against its plain version at phase 4's tolerance; logged."""
    import os
    import struct

    from igs_tpu_torch.core.camera import Camera
    from igs_tpu_torch.data.images import read_png
    from igs_tpu_torch.data.jpeg import segments
    from igs_tpu_torch.data.ply import load_gaussian_ply, read_ply_vertices
    from igs_tpu_torch.utils.saving import avi_chunks

    n = 2 * B
    log_ = pipe.free_view_log
    ms = {k[:-2]: 1e3 * float(np.mean(v)) for k, v in log_.items()
          if k.endswith("_s") and v}
    extra = (launches["free_view"]["blend_fwd_packed/color"]
             - launches["bf16"]["blend_fwd_packed/color"])
    log(f"cli free_view: {wall:.2f} s wall; sec/frame "
        f"{res['sec/frame']:.4f} (bf16 run {bf16['sec/frame']:.4f}); ms a "
        f"frame {json.dumps(ms)}; B1 color launches "
        f"{launches['free_view']['blend_fwd_packed/color']} ({extra} more "
        f"than the bf16 run); launches "
        f"{json.dumps(launches['free_view'])}")
    loaded = [int(x) for x in re.findall(r"loaded (\d+) ", out)]
    if (f"loaded native checkpoint {ckpt}" not in out
            or sorted(loaded) != sorted(counts)):
        raise RuntimeError(f"cli free_view: the overlays loaded {loaded} "
                           f"tensors of {list(counts)}")
    if res["psnr"] != bf16["psnr"]:
        raise RuntimeError(
            f"cli free_view: PSNR {res['psnr']} is not the bf16 run's "
            f"{bf16['psnr']}: the native checkpoint or free_view changed "
            "the stream")
    if res["overflow_events"]:
        raise RuntimeError(f"cli free_view: overflow {res['overflow_events']}")
    pngs = sorted(os.listdir(os.path.join(ws, "free_view")))
    plys = sorted(os.listdir(os.path.join(ws, "gs")))
    if (pngs != [f"{i:05d}.png" for i in range(n)]
            or sorted(plys) != sorted(f"{i}.ply" for i in range(n))):
        raise RuntimeError(f"cli free_view: wrote {pngs} and {plys}")
    spread = []
    for i in range(n):
        img = read_png(os.path.join(ws, "free_view", pngs[i]))
        rows = len(read_ply_vertices(os.path.join(ws, "gs", f"{i}.ply")))
        spread.append(float(img.std()))
        if img.shape != OUT_HW + (3,) or img.dtype != np.uint8:
            raise RuntimeError(f"cli free_view: PNG {i}: {img.shape}")
        if rows != res["points_num"][i // B]:
            raise RuntimeError(f"cli free_view: PLY {i} has {rows} rows, "
                               f"the window {res['points_num'][i // B]}")
    video = os.path.join(ws, "free_view.avi")
    with open(video, "rb") as f:
        data = f.read()
    frames = [p for c, p in avi_chunks(data) if c == b"00dc"]
    sofs = [struct.unpack(">BHH", segments(p)[0xC0][0][:5])[1:]
            for p in frames
            if p[:2] == b"\xff\xd8" and p[-2:] == b"\xff\xd9"]
    log(f"cli free_view: {video}: {len(data)} bytes, {len(frames)} frames, "
        f"frame sizes {[len(p) for p in frames]}")
    if log_["video"] != video or len(frames) != n or sofs != [OUT_HW] * n:
        raise RuntimeError(f"cli free_view: video {log_['video']}: "
                           f"{len(frames)} frames, SOF0 sizes {sofs}")
    if extra != n:
        raise RuntimeError(f"cli free_view: {extra} more B1 launches than "
                           f"the bf16 run, want {n} (one render a frame)")
    # the spiral view that sees the most (its PNG's spread) through B1
    # and its plain version
    i = int(np.argmax(spread))
    log(f"cli free_view: spread of the spiral PNGs {spread}; frame {i} "
        "checked against the plain blend")
    g = load_gaussian_ply(os.path.join(ws, "gs", f"{i}.ply"), device=DEVICE)
    fov = np.asarray(pipe.dataset[0]["FOV"], np.float32)
    cam = Camera.from_c2w(pipe._spiral[i], (fov[0], fov[1]), OUT_HW,
                          device=DEVICE).batched()
    c = compare_kernel("free view 1014x1352", *packed_inputs(
        g, cam, OUT_HW, "color", pipe.refine_settings.max_pairs), "color")
    if not c["ok"] or c["pairs"] == 0:
        raise RuntimeError("cli free_view: the spiral view's blend kernel "
                           "disagrees with its plain version, or the view "
                           "is empty")


def metrics_check(workspace, pipe):
    """``python -m igs_tpu_torch.metrics`` as a subprocess on the bf16 CLI
    run's ``eval_pred/*.png`` against the scene's eval-view images under
    the same names, with a seeded LPIPS weights file: once on the PNGs,
    once on JPEG copies of both written by the port's encoder (every
    image through the decoder). Each must exit 0 and give finite PSNR,
    SSIM and LPIPS for every frame; the JPEG run's PSNR and SSIM a frame
    within TOL_METRICS_PSNR / TOL_METRICS_SSIM of the PNG run's; the ms
    per image (decode, PSNR and SSIM, LPIPS at 1014×1352, total)
    logged."""
    import os
    import shutil

    from igs_tpu_torch.data.images import read_png
    from igs_tpu_torch.data.infer_data import VIEW_TABLES
    from igs_tpu_torch.data.jpeg import encode_jpeg

    ds = pipe.dataset
    pred = os.path.join(workspace, "cli_bf16", "eval_pred")
    names = sorted(os.listdir(pred))
    base = os.path.join(workspace, "metrics")
    dirs = {k: os.path.join(base, k) for k in ("gt", "gt_jpg", "pred_jpg")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    vid = VIEW_TABLES[ds.cfg.scene_type]["eval"][0]
    t0 = time.perf_counter()
    for i, name in enumerate(names):
        item = ds.items[i]
        frame = os.path.join(ds.cfg.root_dir, item["scene_name"],
                             item["next_frame"])
        src = ds._paths_for(frame, frame, vid, ds.cameras_data)["next"]
        shutil.copy(src, os.path.join(dirs["gt"], name))
        for path, d in ((src, "gt_jpg"), (os.path.join(pred, name),
                                          "pred_jpg")):
            with open(os.path.join(dirs[d], name[:-4] + ".jpg"), "wb") as f:
                f.write(encode_jpeg(read_png(path), METRICS_QUALITY))
    log(f"metrics: {len(names)} frames; GT from the eval view {vid}; JPEG "
        f"copies at quality {METRICS_QUALITY} written in "
        f"{time.perf_counter() - t0:.1f} s")
    weights = write_lpips_weights(os.path.join(base, "lpips.pth"))
    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for kind, renders, gt in (("png", pred, dirs["gt"]),
                              ("jpeg", dirs["pred_jpg"], dirs["gt_jpg"])):
        dest = os.path.join(base, f"metric_results_{kind}.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "igs_tpu_torch.metrics", "--renders",
             renders, "--gt", gt, "--lpips-weights", weights, "--out", dest],
            cwd=repo, capture_output=True, text=True,
            timeout=MEASURE_TIMEOUT)
        wall = time.perf_counter() - t0
        for line in (proc.stdout + proc.stderr).splitlines():
            if line.strip():
                log(f"metrics {kind}: {line}")
        if proc.returncode != 0:
            raise RuntimeError(f"metrics {kind}: exit {proc.returncode}")
        with open(dest) as f:
            res = json.load(f)
        per = res["per_view"]
        vals = [v for m in ("psnr", "ssim", "lpips") for v in per[m].values()]
        want = [n[:-4] + (".png" if kind == "png" else ".jpg") for n in names]
        if (sorted(res["results"]) != ["LPIPS", "PSNR", "SSIM"]
                or any(sorted(per[m]) != want for m in per)
                or not all(math.isfinite(v) for v in vals)):
            raise RuntimeError(f"metrics {kind}: {json.dumps(res)[:2000]}")
        timing = re.search(r"ms per image (\{.*\})", proc.stderr)
        out[kind] = {"results": res["results"], "per_view": per,
                     "wall_s": wall,
                     "ms": json.loads(timing.group(1)) if timing else None}
        log(f"metrics {kind}: {json.dumps(res['results'])} in {wall:.2f} s "
            f"wall (the process, the weights and {len(names)} frames); ms "
            f"per image {json.dumps(out[kind]['ms'])}; card {card_line()}")
    dpsnr = [out["jpeg"]["per_view"]["psnr"][n[:-4] + ".jpg"]
             - out["png"]["per_view"]["psnr"][n] for n in names]
    dssim = [out["jpeg"]["per_view"]["ssim"][n[:-4] + ".jpg"]
             - out["png"]["per_view"]["ssim"][n] for n in names]
    log(f"metrics: JPEG - PNG a frame: PSNR {dpsnr} dB (tolerance "
        f"{TOL_METRICS_PSNR}), SSIM {dssim} (tolerance {TOL_METRICS_SSIM})")
    if (max(map(abs, dpsnr)) > TOL_METRICS_PSNR
            or max(map(abs, dssim)) > TOL_METRICS_SSIM):
        raise RuntimeError("metrics: the JPEG copies moved PSNR or SSIM past "
                           "the tolerance")
    return out


def enerf_check(dev, workspace, root, data, igs, gmflow, counters, pipes):
    """The streaming CLI at the card's default on an ENeRF-layout copy of
    the scene: every image the first window and its key-frame refine read
    written as JPEG by the port's encoder (``images_2`` at 1014×1352,
    ``images_512`` at 512²; depths stay PNG, offset -1), one window
    through ``infer_stream.run``, counters reset just before and read
    just after (the "enerf" path). Before the run frame 1's JPEGs are
    decoded against their source PNGs (PSNR > ENERF_MIN_PSNR). The run
    must decode every JPEG it reads through the port's decoder and no
    PNG but the depths, write ``results.json``, overflow nothing, lower
    the refine's loss and launch B1, B2 and B3; decode ms per image and
    ``sec/frame`` logged."""
    import contextlib
    import os
    import shutil

    from igs_tpu_torch import infer_stream
    from igs_tpu_torch.data import dataset as dataset_mod
    from igs_tpu_torch.data import images as images_mod
    from igs_tpu_torch.data.images import read_png
    from igs_tpu_torch.data.infer_data import N3dInferDataset, VIEW_TABLES
    from igs_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    t0 = time.perf_counter()
    enerf = os.path.join(workspace, "enerf_scene")
    shutil.copytree(root, enerf, ignore=shutil.ignore_patterns(
        "images_r2", "images_512", "gt", "*.pth", "*.msgpack"))
    edata = dict(data, root_dir=enerf, scene_type="enerf",
                 depth_id_offset=None,
                 start_gs_path=data["start_gs_path"].replace(root, enerf))
    ds = N3dInferDataset(edata)
    table = VIEW_TABLES["enerf"]
    wanted = set()
    for item in ds.items[:B]:
        cur = os.path.join(enerf, item["scene_name"], item["cur_frame"])
        nxt = os.path.join(enerf, item["scene_name"], item["next_frame"])
        for vid in table["eval"] + table["input"]:
            p = ds._paths_for(cur, nxt, vid, ds.cameras_data)
            wanted |= {p["next"], p["cur_512"], p["next_512"]}
    key = ds.items[B - 1]
    frame = os.path.join(enerf, key["scene_name"], key["next_frame"])
    for vid in range(len(ds.cameras_data)):
        if vid not in table["eval"]:
            wanted.add(ds._paths_for(frame, frame, vid,
                                     ds.cameras_data)["cur"])

    def source(path):
        rel = os.path.relpath(path, enerf).replace(
            os.sep + "images_2" + os.sep, os.sep + "images_r2" + os.sep)
        return os.path.join(root, rel[:-4] + ".png")

    first = os.path.join(ds.items[0]["scene_name"], ds.items[0]["next_frame"])
    checked = {"full": [], "512": []}
    for path in sorted(wanted):
        img = read_png(source(path))
        data_ = encode_jpeg(img, ENERF_QUALITY)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data_)
        if os.path.relpath(path, enerf).startswith(first):
            t1 = time.perf_counter()
            dec = decode_jpeg(data_)
            ms = 1e3 * (time.perf_counter() - t1)
            mse = float(np.mean((dec.astype(np.float64) - img) ** 2))
            psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
            checked["512" if "images_512" in path else "full"].append(
                (psnr, ms, img.shape[:2]))
    log(f"enerf: scene {enerf}: {len(wanted)} JPEGs at quality "
        f"{ENERF_QUALITY} (every image one window and its key-frame refine "
        f"read), written in {time.perf_counter() - t0:.1f} s; frame "
        f"{first} decoded against its PNGs: {json.dumps(checked)} (PSNR dB, "
        f"decode ms, shape); card {card_line()}")
    if not checked["full"] or not checked["512"] or min(
            p for v in checked.values() for p, _, _ in v) <= ENERF_MIN_PSNR:
        raise RuntimeError(f"enerf: decoded frames off their PNGs: {checked}")

    reads = []
    inner = images_mod.read_image

    def timed_read(path):
        t1 = time.perf_counter()
        out = inner(path)
        reads.append((os.fspath(path), 1e3 * (time.perf_counter() - t1),
                      out.shape[:2]))
        return out

    ws = os.path.join(workspace, "cli_enerf")
    backbone = dict(SYSTEM["backbone"], pretrained_model_name_or_path=gmflow)
    sections = {"system": dict(SYSTEM, backbone=backbone),
                "opt": dict(OPT, workspace=ws, resume=igs),
                "data": {"data_cls": "igs.data.infer_data.N3dDataset",
                         "data": edata}}
    images_mod.read_image = dataset_mod.read_image = timed_read
    tee = Tee(sys.stdout)
    counters.reset()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            res = infer_stream.run(sections, max_batches=1, device=dev)
    finally:
        images_mod.read_image = dataset_mod.read_image = inner
    wall = time.perf_counter() - t0
    launches = counters.read()
    pipe = pipes[-1]
    jpgs = [r for r in reads if r[0].endswith(".jpg")]
    others = [r[0] for r in reads if not r[0].endswith(".jpg")]
    by_size = {}
    for _, ms, hw in jpgs:
        by_size.setdefault(f"{hw[0]}x{hw[1]}", []).append(ms)
    decode_ms = {k: float(np.mean(v)) for k, v in by_size.items()}
    log(f"cli enerf: {wall:.2f} s wall; psnr {json.dumps(res['psnr'])}; "
        f"sec/frame {res['sec/frame']:.4f}; AGM_times {res['AGM_times']}; "
        f"overflow_events {res['overflow_events']}; JPEG reads "
        f"{len(jpgs)} ({len({r[0] for r in jpgs})} files), mean decode ms "
        f"by size {json.dumps(decode_ms)} ({sum(r[1] for r in jpgs):.0f} ms "
        f"in all); other reads {len(others)}; launches {json.dumps(launches)}"
        f"; card {card_line()}")
    with open(os.path.join(ws, "results.json")) as f:
        saved = json.load(f)
    if set(saved) != set(RESULTS_KEYS):
        raise RuntimeError(f"cli enerf: results.json keys {sorted(saved)}")
    psnr = list(res["psnr"].values())
    if len(psnr) != B or not all(math.isfinite(p) for p in psnr):
        raise RuntimeError(f"cli enerf: PSNR {psnr}")
    if res["overflow_events"]:
        raise RuntimeError(f"cli enerf: overflow {res['overflow_events']}")
    if {r[0] for r in jpgs} != wanted:
        raise RuntimeError(
            f"cli enerf: read {len({r[0] for r in jpgs})} of the "
            f"{len(wanted)} JPEGs written; unread "
            f"{sorted(wanted - {r[0] for r in jpgs})[:4]}")
    if any("depth_expected_mm" not in p for p in others):
        raise RuntimeError(f"cli enerf: read non-JPEG images {others[:4]}")
    if len(pipe.refine_log) != 1:
        raise RuntimeError(f"cli enerf: {len(pipe.refine_log)} refines")
    losses = pipe.refine_log[0]["losses"]
    first5, last5 = np.mean(losses[:5]), np.mean(losses[-5:])
    log(f"cli enerf: refine key {pipe.refine_log[0]['key']}: "
        f"{pipe.refine_log[0]['ms_per_step']:.3f} ms/step, loss first 5 "
        f"{first5:.5f} last 5 {last5:.5f}")
    if not last5 < first5:
        raise RuntimeError("cli enerf: the refine loss did not fall")
    for k in ("blend_fwd_packed/color", "blend_bwd_packed/color",
              "segmented_scan"):
        if launches[k] == 0:
            raise RuntimeError(f"cli enerf: did not launch {k}")
    return launches


MEASURE_PROGRAMS = (
    ("igs_tpu_torch.tools.bench_segscan_fold", ()),
    ("igs_tpu_torch.tools.bench_segscan_kernel", ()),
    ("igs_tpu_torch.bench", ()),
    ("igs_tpu_torch.roofline", ()),  # its default: the bf16 flags on
    ("igs_tpu_torch.roofline", ("--f32",)),
    ("igs_tpu_torch.profile_stages", ()),
    ("igs_tpu_torch.profile_stages", ("--cnn-bf16",)),
)
MEASURE_TIMEOUT = 300  # seconds a program may take
# the keys the JAX scripts write (roofline.py, profile_stages.py)
ROOFLINE_KEYS = ("anchors_s", "raster_fwd_s", "raster_fwd_bwd_s",
                 "raster_fwd_bwd_mpix_s", "refine_loop_s", "refine_step_s",
                 "agm_forward_s", "agm_forward_exact_pairs_s",
                 "stream_s_per_frame", "stream_fps")
PROFILE_KEYS = tuple(f"refine/{k}_s" for k in (
    "project_fwd", "binning", "packed_binning", "raster_fwd",
    "raster_fwd_bwd", "ssim_l1_grad", "full_step")) + tuple(
    f"agm/{k}_s" for k in (
        "cnn_encoder", "feature_transformer", "motion_transformer",
        "motion_features", "condition3d", "triplane_encoder",
        "interp_decode", "renders"))
# each program's kernels that must have launched
MEASURE_KERNELS = {
    "bench_segscan_fold": ("segscan_fold/copy_folded",
                           "segscan_fold/copy_padded",
                           "segscan_fold/reshape"),
    "bench_segscan_kernel": ("segmented_scan",),
    "bench": ("blend_fwd_packed/full", "blend_bwd_packed/full",
              "segmented_scan"),
    "roofline": ("blend_fwd_packed/full", "blend_fwd_packed/color",
                 "blend_bwd_packed/color", "blend_fwd_packed/color_depth"),
    "profile_stages": ("blend_fwd_packed/color", "blend_bwd_packed/color",
                       "segmented_scan", "blend_fwd_packed/color_depth"),
}


def measurement_path():
    """Each program of the measurement path as a subprocess at its
    defaults, from the checkout's root (the kernels built above are
    found in ``build/cuda``): its output logged here, its exit code and
    results checked. Returns the kernel launches summed over the
    programs, each of which starts from zero and prints its own."""
    import hashlib
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    tpu_roofline = os.path.join(root, "roofline.json")

    def digest():
        if not os.path.exists(tpu_roofline):
            return None
        with open(tpu_roofline, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = digest()
    total, timings = {}, {}
    for module, args in MEASURE_PROGRAMS:
        name = module.rsplit(".", 1)[-1]
        label = " ".join((name,) + args)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", module, *args], cwd=root,
                              capture_output=True, text=True,
                              timeout=MEASURE_TIMEOUT)
        for line in proc.stdout.splitlines():
            log(f"{label}: {line}")
        for line in proc.stderr.splitlines():
            log(f"{label} (stderr): {line}")
        log(f"{label}: exit {proc.returncode} after "
            f"{time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0:
            raise RuntimeError(f"python -m {module} exited {proc.returncode}")
        counts = [json.loads(line.split("kernel launches ", 1)[1])
                  for line in proc.stderr.splitlines()
                  if "kernel launches " in line]
        if len(counts) != 1:
            raise RuntimeError(f"{module} printed no kernel launches")
        missing = [k for k in MEASURE_KERNELS[name] if not counts[0].get(k)]
        if missing:
            raise RuntimeError(f"{module} did not launch {missing}")
        for k, v in counts[0].items():
            total[k] = total.get(k, 0) + v
        timings[label] = measure_results(name, proc.stdout, root)
    if digest() != before:
        raise RuntimeError("the measurement path changed the repo-root "
                           "roofline.json")
    log(f"measure: {json.dumps(timings)}")
    for key in ("agm_forward_s", "agm_forward_exact_pairs_s", "stream_fps"):
        log(f"measure: roofline {key} bf16 (default) "
            f"{timings['roofline'][key]} beside --f32 "
            f"{timings['roofline --f32'][key]}")
    log(f"measure: profile_stages agm/cnn_encoder_s --cnn-bf16 "
        f"{timings['profile_stages --cnn-bf16']['agm/cnn_encoder_s']} "
        f"beside float32 {timings['profile_stages']['agm/cnn_encoder_s']}")
    return total


def measure_results(name, stdout, root):
    """The results a program printed or wrote, checked: finite, positive,
    every expected key or line."""
    import os

    def finite(values, what):
        bad = {k: v for k, v in values.items()
               if not (isinstance(v, (int, float)) and math.isfinite(v)
                       and v > 0)}
        if bad:
            raise RuntimeError(f"{name}: bad {what} {bad}")
        return values

    if name.startswith("bench_segscan"):
        lines = dict(line.rsplit(": ", 1) for line in stdout.splitlines())
        # the fold tool: four timeit_device lines and their four L2-cold,
        # graph-replayed lines
        want = 8 if name == "bench_segscan_fold" else 6
        if len(lines) != want:
            raise RuntimeError(f"{name}: {len(lines)} lines, not {want}")
        return finite({k: float(v.split()[0]) for k, v in lines.items()},
                      "times (ms)")
    if name == "bench":
        res = json.loads(stdout.strip().splitlines()[-1])
        import torch

        if (res["metric"] != "rasterize_fwd_bwd_mpix_per_s_512"
                or res["unit"] != "Mpix/s"
                or res["device"] != torch.cuda.get_device_name(0)):
            raise RuntimeError(f"bench: unexpected line {res}")
        finite({k: res[k] for k in ("value", "vs_baseline")}, "rate")
        return res
    keys = ROOFLINE_KEYS if name == "roofline" else PROFILE_KEYS
    with open(os.path.join(root, "logs", "igs_tpu_torch",
                           f"{name}.json")) as f:
        res = json.load(f)
    return finite({k: res.get(k) for k in keys}, "results")


if __name__ == "__main__":
    sys.exit(main())
