"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. card and settings: name and power limit, TF32 off for matmuls and
     cuDNN convolutions (the float32 paths stay float32; the bf16 flags
     and mixed precision compute in bf16 where they say);
  2. build every kernel of the main paths from ``igs_tpu_torch/csrc``
     (blend_fwd.cu, blend_bwd.cu, segscan.cu, segscan_fold.cu,
     attention.cu: one nvcc per source, started together; blend_fwd.cu
     holds the packed and the windowed forward and the contribution
     count, blend_bwd.cu the packed and the windowed backward,
     attention.cu AGM-Net's attention forward and its dK/dV and dQ
     kernels), with ptxas registers and spills per source;
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
 5b. the attention kernels (B7, the forward, and B8, its dK/dV and dQ
     kernels, ``ops/attention.py``) against their plain version
     (``attention_plain``, autograd for the gradients) on seeded inputs
     at the main path's calls: the triplane encoder's (5, 8, 8192, 64),
     the feature transformer's windows (80, 4, 1024, 128) with the shift's
     region ids and without, and a ragged (2, 4, 1000, 32), each in f32
     (output within 2e-5 of its largest entry, each gradient within 1e-4
     of its largest) and bf16 (each within 1.5x the plain bf16 route's
     own distance from the plain f32 route on the same inputs); the
     gradients launched twice, bit-equal; each timed eagerly on one warm
     input and replayed on an L2-cold rotation, beside the plain
     version, SDPA (flash for bf16 without ids, memory-efficient
     otherwise: a yardstick the port never calls) and the operations
     bound;
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
     densest tile of the key frames' output views. 15 steps with the
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
     ``…roofline`` (its default: the bf16 flags on) and
     ``…profile_stages``, each a subprocess at the JAX programs' sizes
     whose output is logged here (their runs in the other precision,
     ``roofline --f32`` and ``profile_stages --cnn-bf16``, were cut in PR
     17 for time: the stream and the CLI run the f32 network); each must
     exit 0 and print its results (finite, the
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
 15. the oracle routes, which launch no kernel of their own: (a) at the
     eval view (1014×1352, 5440 tiles, deepest tile under the 4096-row
     window) ``impl="tiles"`` against the packed route in full mode on
     every map (the kernels B1, B2, B3), and the gradients of the six
     inputs from a seeded cotangent on color, depth and normal; both
     routes' forward and forward+backward timed (CUDA events) with the
     peak memory; (b) the four 128² depth-carry views at the JAX stream's
     512-row window, tiles against the windowed route (B5a), their
     ``overflow_tiles`` equal; (c) 3 000 Gaussians at 96×136 (partial
     tiles): ``"reference"`` against tiles against packed, forward and
     gradients, the reference timed; (d) compact binning against the sort
     route at the eval view: lists and counts equal, the tiles render from
     either bit for bit, both binnings timed; (e) one window (B=5) and its
     key-frame refine (10 steps on 13 views at 1014×1352: the stream's 50
     cut for time; 20 until PR 17, whose attention phase and probes took
     the time) through
     ``StreamingPipeline`` with ``impl="tiles"`` (the JAX package's route
     off a TPU: full outputs, a 512-row depth-carry window, no budget
     calibration), which must launch no rasterizer kernel (the
     network's attention runs B7 on every route), lower its loss and keep
     the window's first four PSNRs within 0.05 dB of phase 6's packed
     window; (f) a finding only: the tiles past the JAX ``build_frame0``'s
     2048-pair window on the frame-0 cell's 20 views, for its scene and
     its exported Gaussians. Maps are held at 2e-5 off threshold-flip
     pixels (at most TOL_FLIP_FRAC of them), gradients to 2e-5 of each
     tensor's largest entry. Counters are reset just before (a) and read
     after (d): the "oracles" path.
 16. the parallel paths over ``torch.distributed`` (``parallel/``), on
     the stream's scene and model at 1024×1352 outputs (64 tile rows: the
     strip refine refuses 1014 rows at 2 and 4 strips, ROADMAP C30): (a)
     the eval view rendered whole and in 2 and 4 tile-row strips
     (``rasterize(strip_row0=)``), color forward and backward through B1,
     B2 and B3: the joined strips within TOL_ABS of the whole render (bit
     equality logged), the strips' summed gradients within 1e-5 of each
     tensor's largest entry, whole and strip ms; B1, B2 and B3 against
     their plain versions on the second of 2 strips. (b) One window of 4
     and its key-frame refine cut to 20 steps, with ``data_parallel`` 2
     and ``refine_parallel`` 2 on two ranks sharing the card over gloo
     (``parallel/launch.spawn``), against one process on the same config:
     PSNR within 0.01 dB before the refine and 0.05 dB on the refined
     frame, equal live counts, per-step refine loss within 1e-3 relative,
     both ranks' results equal. (c) Three data-parallel train steps of the
     training recipe (batch 2 over the two ranks) against one process at
     batch 2: loss within 1e-5 relative and the clipped gradient of step 1
     within C18's bounds. (d) ``build_frame0``'s sweep on two frames over
     two ranks (200 + 20 steps: the 6000 + 1000 cut for time) against the
     sequential build of each frame under the sweep's view order: the same
     exported count and render PSNR within 0.05 dB; then ``--workers 2
     --devices 0,0`` as a subprocess must exit 0 and write both frames.
     (e) A rank of a world-size-1 NCCL group: NCCL's gather, sum and max
     and one data-parallel train step through it; ``bench_scaling`` at
     world size 1 under NCCL. Every group and join has a timeout
     (PAR_JOIN_S). The
     ranks' launches and (a)'s renders are the "parallel" path (the pool's
     subprocesses and ``bench_scaling``'s groups are not counted). Times of
     two ranks on one card time the path, not scaling.
 17. from a capture to a stream, and the graft entry: (a) a capture of
     CAP_FRAMES frames (0–5: one window of B=5 and key frame 5) of the
     stream's recipe (120 000 Gaussians, no static shell, moved to z ≈ 6
     with the rig so that frame 0's z-cull keeps them), each of the 14
     views rendered through the packed forward at 1014×1352 into
     ``colmap_<f>/images/`` (``images_r2`` a link to it, the n3d layout),
     and COLMAP's binary ``sparse/0`` a frame: one PINHOLE camera at
     2704×2028, the 14 posed images, 20 000 of the frame's centres. (b)
     ``python -m igs_tpu_torch.prepare_data`` as subprocesses: ``cameras
     --downscale 2``, ``points`` and ``subsample --size 512 --workers 5``
     a frame, ``aabb`` and ``pairs``, each timed (subsample in images
     per second); every cameras.json within 1e-6 relative of the scene's
     table. (c) ``panoptic`` on a Panoptic-shaped frame (4 hd cameras at
     1920×1080, five distortion coefficients) with a stub ``colmap``
     first on PATH that records its arguments: 4 undistorted 1920×1080
     PNGs, the three colmap commands, the database's camera and image
     rows, the manual model and the moved model files; the undistortion
     timed per image. (d) The stream's first window batch (25 PNGs at
     1014×1352, 30 at 512²) through the host library against the numpy
     codec: bit-equal, both timed. (e) ``build_frame0``'s CLI (``main``,
     in this process) on the prepared ``colmap_0`` (``cameras.json``,
     ``images/``, ``points3D.npz``), 300 + 50 steps (its 6000 + 1000 cut
     for time), which must lower its loss and overflow nothing; then
     ``infer_stream.run`` for one window and its key-frame refine on the
     prepared ``bbox.json``, pairs and ``images_512/`` from that export:
     ``results.json`` with the JAX keys, no overflow, the refine's loss
     lowered. Counters are reset before (b) and read after (e): the
     "capture" path, which must launch B1, B2, B3 and B4. (f)
     ``graft_entry.entry()``'s forward on the card, then
     ``graft_entry.run_dryrun(2)`` on two gloo ranks sharing the card:
     its four lines (a finite loss); this process's and the ranks'
     launches are the "graft" path, which must launch B1, B2 and B3.
 18. the rasterizer, refine and AGM-Net probes of ``igs_tpu_torch/tools/``
     (the JAX package's ``tools/`` probes): each of the 22 through its
     ``main`` in this process at a reduced shape (20 000 Gaussians at
     256², one timing call, 4 refine steps on 4 views; the attention at
     (1, 8, 2048, 64), the feature transformer's 2 layers on 4 maps, the
     network at full width on 2 candidates of 128² inputs; the sweep runs
     the refine-loop probe as its subprocess), counters reset just before
     each and read just after: each must exit 0, write its JSON and
     launch the kernels its path runs (``PROBE_RUNS``; the binning and
     expansion probes launch none), ``packed_test`` and
     ``precision_check`` holding their own tolerances (B1/B2 against
     plain, and the packed route against the windowed one); their sum is
     the "probes" path. Then a progressive JPEG (written here from numpy:
     the DC first and refine, two AC bands) and a 4-bit palette PNG in a
     batch with an 8-bit RGB PNG through the datasets' batch loader,
     equal to the pixels computed from numpy (the palette file's
     indices, as PIL and the JAX loader read it), and a 1014×1352
     progressive decode on the host timed beside the baseline decode of
     the same coefficients.
Kernel launches are counted per path (stream, frame 0, regulariser,
training, lpips, flow, measurement, CLI, enerf, oracles, parallel,
capture, graft, probes); the kernels line carries their sums.
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
# 30 until PR 17, cut to keep the smoke under its limit on a slow host
TRAIN_STEPS = 15
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


def build_stream(dev, n_items, out_hw=OUT_HW, interval=INTERVAL):
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
        render(frames[0], c2ws[v], out_hw, "color_depth")[1].cpu().numpy()
        for v in INPUT_VIEWS])
    depth0 = np.clip(depth0 * 1000.0, 0, 65535).astype(np.uint16) / 1000.0
    h8 = IN_RES // 8 * 2
    dirs = local_ray_directions(h8, h8, FOV, FOV)
    centers = c2ws[:, :3, 3]
    radius = 1.1 * np.linalg.norm(centers - centers.mean(0), axis=1).max()
    items = []
    for f in range(n_items):
        key = (f // interval) * interval
        out_imgs = np.stack([render(frames[f + 1], c2ws[v], out_hw)[0]
                             for v in vids])
        it = {
            "cur_images_input": inputs[key],
            "next_images_input": inputs[f + 1],
            "images_output": out_imgs,
            "c2w_output": c2ws[list(vids)],
            "c2w_input": c2ws[list(INPUT_VIEWS)],
            "FOV": np.float32([FOV, FOV]),
            "background_color": np.zeros(3, np.float32),
            "resolution": np.int32(out_hw),
            "radius": np.float32(radius),
            "bounding_box": BBOX,
            "depth": depth0.astype(np.float32),
            "local_rays": dirs,
            "rays": world_rays(dirs, c2ws[list(INPUT_VIEWS)]),
            "keyframe": 1 if f % interval == 0 else 0,
            "idx": f,
        }
        items.append(it)
    # refine data of each key frame (1-based key = the frame refined):
    # every camera but the eval one (infer_data.get_refine_data)
    train_vids = [v for v in range(N_CAMS) if v != EVAL_VIEW]
    refine = {key: {"images": [render(frames[key], c2ws[v], out_hw)[0]
                               for v in train_vids],
                    "c2ws": list(c2ws[train_vids]),
                    "FOV": np.float32([FOV, FOV]),
                    "bg": np.zeros(3, np.float32)}
              for key in range(interval, n_items + 1, interval)}
    return Stream(items, frames[0].to("cpu"), refine), frames[0], c2ws


def write_frame0(dev, root, frame=0, seed=1):
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
        0.0, N_GAUSSIANS, seed=seed, static_frac=STATIC_FRAC)
    xyz = xyz + F0_CENTER
    g = Gaussians.create(xyz, opacity, rot, scaling, shs, device=dev)
    c2ws = make_cameras(F0_VIEWS)
    c2ws[:, :3, 3] += F0_CENTER
    frame_dir = os.path.join(root, f"colmap_{frame}")
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


def packed_inputs(g, cam, hw, mode, max_pairs, strip_row0=None):
    """The packed blend's inputs of one render (``hw``: the image, or the
    strip of ``hw[0]`` rows from tile row ``strip_row0`` of ``cam``'s)."""
    from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
    from igs_tpu_torch.ops.blend import pack_features
    from igs_tpu_torch.ops.projection import project
    from igs_tpu_torch.ops.rasterize import to_strip

    proj = project(g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                   cam, shs=g.shs, valid=g.valid, geometry=mode != "color")
    if strip_row0 is not None:
        proj = to_strip(proj, strip_row0, hw[0] // 16)
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
# phase 5b: the attention kernels (B7 forward, B8 backward)
# ---------------------------------------------------------------------------

# (case, (B, H, L, C), with the swin shift's region ids): the triplane
# encoder's call (5 candidates, 8 heads of 64 over 8192 anchors), the
# feature transformer's (40 image pairs concatenated both ways = 80, its
# 2x2 windows of a 64x64 map as H, 1024 tokens of 128 channels), shifted
# and not, and a ragged length at a small head dim
ATTN_CASES = (("triplane", (5, 8, 8192, 64), False),
              ("swin shifted", (80, 4, 1024, 128), True),
              ("swin", (80, 4, 1024, 128), False),
              ("ragged", (2, 4, 1000, 32), False))
ATTN_SWIN_MAP = 64  # the feature map whose 2x2 windows the swin cases hold
TOL_ATTN_OUT = 2e-5  # f32 output, of its largest |entry|
TOL_ATTN_GRAD = 1e-4  # f32 gradients, of each one's largest |entry| (C18)
# bf16: each output within this many times the plain bf16 route's own
# max distance from the plain f32 route on the same inputs (C21)
TOL_ATTN_BF16 = 1.5
ATTN_REPS = 5  # eager launches a forward timing, 3 a backward's


def attention_inputs(dev, shape, shifted, dtype, seed):
    """q, k, v and a cotangent from a seeded generator on the card, in
    ``dtype``, and the region ids of the swin shift (or None)."""
    import torch

    from igs_tpu_torch.models.swin import shift_window_region_ids

    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randn(shape, generator=gen, device=dev).to(dtype)
          for _ in range(4)]
    ids = None
    if shifted:
        w = ATTN_SWIN_MAP // 2
        ids = torch.from_numpy(shift_window_region_ids(
            ATTN_SWIN_MAP, ATTN_SWIN_MAP, w, w, w // 2, w // 2)).to(dev)
    return xs, ids


def attention_pairs(shape, ids):
    """The (query, key) pairs the function needs: all, or those of one
    region."""
    b, h, length, _ = shape
    if ids is None:
        return b * h * length * length
    counts = [np.bincount(row) for row in ids.cpu().numpy()]
    return b * sum(int((c.astype(np.int64) ** 2).sum()) for c in counts)


def attention_bounds(shape, pairs, esz):
    """The least times of B7 (``bound_ms``) and B8 (``bwd_bound_ms``) on
    (B, H, L, C) inputs of ``esz``-byte entries with ``pairs`` (query,
    key) pairs: bf16 against its tensor-core rate, f32 against 3xTF32's,
    the CUDA cores' f32 rate beside it (``bound_cuda_core_ms``)."""
    from igs_tpu_torch.utils import h100

    b, h, length, c = shape
    n = b * h * length * c
    rows = 4 * b * h * length  # one f32 a row
    # forward: q, k, v read, o and lse written; backward: q, k, v, o, dout
    # and lse read, dq, dk, dv written; 2 and 5 products of 2·C a pair
    work = {"": (4 * esz * n + rows, 4 * c * pairs),
            "bwd_": (8 * esz * n + rows, 10 * c * pairs)}
    res = {}
    for pre, (nbytes, ops) in work.items():
        if esz == 2:
            res[f"{pre}bound_ms"], res[f"{pre}bound_by"] = h100.bound(
                nbytes, ops, h100.BF16_TC_FLOPS)
        else:
            # the least time at f32 accuracy is 3xTF32's, three TF32
            # products a product on the tensor cores (csrc/attention.cu)
            res[f"{pre}bound_ms"], res[f"{pre}bound_by"] = h100.bound(
                nbytes, 3 * ops, h100.TF32_TC_FLOPS)
            res[f"{pre}bound_cuda_core_ms"] = h100.bound(
                nbytes, ops, h100.FP32_FLOPS)[0]
    return res


def attention_library(q, k, v, scale, ids, dout):
    """One PyTorch call computing the same function, timed (never called by
    the port): SDPA's flash backend for bf16 without ids, its
    memory-efficient backend otherwise (ids as a boolean mask). Returns
    (backend, forward ms, backward ms, None), or (backend, None, None,
    why) where the backend refuses the call."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    flash = q.dtype == torch.bfloat16 and ids is None
    backend = (SDPBackend.FLASH_ATTENTION if flash
               else SDPBackend.EFFICIENT_ATTENTION)
    mask = None if ids is None else (ids[:, :, None] == ids[:, None, :])[None]
    ins = [x.detach().requires_grad_(True) for x in (q, k, v)]
    try:
        with sdpa_kernel(backend):
            fwd_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                          scale=scale), reps=ATTN_REPS)
            out = sdpa(*ins, attn_mask=mask, scale=scale)
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                out, ins, dout, retain_graph=True), reps=3)
    except RuntimeError as e:
        return backend.name, None, None, str(e).splitlines()[0][:200]
    return backend.name, fwd_ms, bwd_ms, None


def attention_case(dev, name, shape, shifted, dtype, seed):
    """B7 and B8 against the plain version on one case: errors (f32
    against the plain f32 route; bf16 against the plain f32 route on the
    same bf16 inputs, held to TOL_ATTN_BF16 times the plain bf16 route's
    own distance), the gradients launched twice for bit equality, and
    eager, L2-cold replayed, plain and library times beside the bound."""
    import torch

    from igs_tpu_torch.ops import attention as A
    from igs_tpu_torch.utils.devtime import rotation_ms

    (q, k, v, dout), ids = attention_inputs(dev, shape, shifted, dtype, seed)
    scale = shape[-1] ** -0.5
    # the check run: the kernels count the tiles they list under ids
    with A.counting_tile_pairs(dev) as tiles:
        out, lse = A.attention_fwd_cuda(q, k, v, scale, ids)
        grads = A.attention_bwd_cuda(q, k, v, out, lse, dout, scale, ids)
    again = A.attention_bwd_cuda(q, k, v, out, lse, dout, scale, ids)
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again

    def plain(dt):
        ins = [x.to(dt).detach().requires_grad_(True) for x in (q, k, v)]
        o = A.attention_plain(*ins, scale, ids)
        g = torch.autograd.grad(o, ins, dout.to(dt))
        return [o.detach().float()] + [x.float() for x in g]

    ref = plain(torch.float32)
    got = [out.float()] + [x.float() for x in grads]
    err = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    scale_ref = [float(b.abs().max()) for b in ref]
    labels = ("out", "dq", "dk", "dv")
    res = {"case": name, "dtype": str(dtype).replace("torch.", ""),
           "shape": list(shape), "region_ids": shifted,
           "max_abs_err": dict(zip(labels, err)),
           "max_abs_ref": dict(zip(labels, scale_ref)),
           "bitwise_repeat_grads": repeat}
    if dtype == torch.bfloat16:
        pb = plain(torch.bfloat16)
        dist = [float((a - b).abs().max()) for a, b in zip(pb, ref)]
        del pb
        res["plain_bf16_distance"] = dict(zip(labels, dist))
        ok = all(e <= TOL_ATTN_BF16 * d for e, d in zip(err, dist))
    else:
        ok = (err[0] <= TOL_ATTN_OUT * scale_ref[0]
              and all(e <= TOL_ATTN_GRAD * r
                      for e, r in zip(err[1:], scale_ref[1:])))
    del ref, got
    torch.cuda.empty_cache()

    # times: eager on one warm input, replayed on an L2-cold rotation
    def fwd(x):
        return A.attention_fwd_cuda(x, k, v, scale, ids)

    def bwd(x):
        return A.attention_bwd_cuda(q, k, v, out, lse, x, scale, ids)

    res["ms"] = cuda_ms(lambda: fwd(q), reps=ATTN_REPS)
    res["bwd_ms"] = cuda_ms(lambda: bwd(dout), reps=3)
    live = q.numel() * q.element_size()
    copies = max(2, math.ceil(COLD_BYTES / live))
    for key, fn, x in (("graph_l2_cold_ms", fwd, q),
                       ("bwd_graph_l2_cold_ms", bwd, dout)):
        rot = rotation_ms({"k": fn}, [x] + [x.clone()
                                           for _ in range(copies - 1)],
                          rounds=1, n=4)["k"]
        res[key] = float(np.median(rot["graph"]))
        res[key.replace("graph", "eager")] = float(np.median(rot["eager"]))
    with torch.no_grad():
        res["plain_ms"] = cuda_ms(
            lambda: A.attention_plain(q, k, v, scale, ids), reps=1)
    ins = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o = A.attention_plain(*ins, scale, ids)
    res["bwd_plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
        o, ins, dout, retain_graph=True), reps=1)
    del o, ins
    torch.cuda.empty_cache()
    backend, lib_fwd, lib_bwd, why = attention_library(q, k, v, scale, ids,
                                                       dout)
    res.update({"library": backend, "library_ms": lib_fwd,
                "bwd_library_ms": lib_bwd})
    if why:
        res["library_unavailable"] = why
    pairs = attention_pairs(shape, ids)
    res.update(attention_bounds(shape, pairs, q.element_size()))
    res["pairs"] = pairs
    # (own tile, visited tile) pairs each kernel listed and skipped in the
    # check run, summed over its blocks, as the kernels counted them
    res["tile_pairs"] = {kern: (v_ if ids is not None else None)
                         for kern, v_ in tiles.items()}
    res["tile_pairs_skipped"] = {
        kern: (None if v_ is None else v_[1] - v_[0])
        for kern, v_ in res["tile_pairs"].items()}
    # under the swin shift's ids every kernel lists tiles and skips some
    skips = ids is None or all(0 < v_[0] < v_[1] for v_ in tiles.values())
    log(f"attention {json.dumps(res)}")
    res["ok"] = bool(ok and repeat and skips)
    return res


def attention_phase(dev):
    """Every ATTN_CASES case in f32 and bf16; fails unless each agrees
    with the plain version within its tolerance, repeats its gradients
    bit for bit and, under region ids, skips tiles in every kernel."""
    import torch

    t0 = time.perf_counter()
    out = []
    for i, (name, shape, shifted) in enumerate(ATTN_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            out.append(attention_case(dev, name, shape, shifted, dtype,
                                      seed=100 + i))
            torch.cuda.empty_cache()
    bad = [f"{c['case']}/{c['dtype']}" for c in out if not c["ok"]]
    log(f"attention: phase 5b {time.perf_counter() - t0:.1f} s")
    if bad:
        raise RuntimeError(
            f"attention kernels disagree with their plain version, do not "
            f"repeat their gradients or, under region ids, skip no tile in "
            f"{bad} (f32: {TOL_ATTN_OUT} of the output's largest, "
            f"{TOL_ATTN_GRAD} of each gradient's; bf16: {TOL_ATTN_BF16}x the "
            f"plain bf16 route's distance)")
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
    # attention.cu (30 template instantiations, ~35 s of nvcc) builds in a
    # thread while the scenes are made and the blend kernels checked; the
    # attention phase waits for it
    sources = ["blend_fwd.cu", "blend_bwd.cu", "segscan.cu", "segscan_fold.cu"]
    t_build = time.perf_counter()
    attn_build = background_build(cuda_build, ["attention.cu"])
    cuda_build.build(sources)
    log(f"build: {time.perf_counter() - t_build:.2f} s wall; per source "
        f"{json.dumps(cuda_build.BUILD_SECONDS)}")
    log_ptxas(cuda_build, sources)

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

    # -- the attention kernels vs plain ---------------------------------------
    t1 = time.perf_counter()
    attn_build()
    # no entry: the library was already built in this checkout
    built = cuda_build.BUILD_SECONDS.get("attention.cu")
    log(f"build: attention.cu "
        + ("prebuilt" if built is None else f"{built:.2f} s in the background")
        + f", waited {time.perf_counter() - t1:.2f} s; "
        f"{time.perf_counter() - t_build:.2f} s since the build started")
    log_ptxas(cuda_build, ["attention.cu"])
    attn = attention_phase(dev)

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
              "blend_bwd_packed/color", "segmented_scan", "attention_fwd"):
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
    # window 1 of the packed stream, beside the tiles stream of phase 15
    key1 = pipe.refine_log[0]
    packed_window = {
        "agm_ms": agm_ms[0], "refine_ms_per_step": key1["ms_per_step"],
        "refine_s": key1["seconds"],
        "eval_psnr_before": key1["eval_psnr_before"],
        "eval_psnr_after": key1["eval_psnr_after"],
        "psnr": dict(list(results["psnr"].items())[:B])}

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
    f0_cams = Camera.stack([Camera.from_c2w(c, (FOV, FOV), (F0_RES, F0_RES),
                                            device=dev) for c in c2ws_f0])
    f0_window_rec = frame0_window(g_f0, f0_cams, f0_rec)
    del f0_rec, g_f0, f0_cams

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
    del pipe, refine_args
    torch.cuda.empty_cache()
    measure_launches = measurement_path()

    # -- the streaming CLI, bf16 and float32 ----------------------------------
    cli_launches, enerf_launches = cli_phase(dev, workspace, counters)

    # -- the oracle routes ----------------------------------------------------
    oracle_launches = oracle_phase(
        dev, start_gs, eval_cam, depth_cams, c2ws, model, stream, cfg,
        refine_cfg, counters, agm_ms, packed_window, f0_window_rec)
    del stream

    # -- the parallel paths -------------------------------------------------
    parallel_launches = parallel_phase(dev, workspace, counters, c2ws,
                                       train["root"], train["max_pairs"])

    # -- from a capture to a stream, and the graft entry --------------------
    torch.cuda.empty_cache()
    capture_launches, graft_launches = capture_phase(dev, workspace, counters)

    # -- the rasterizer and refine probes, and the image kinds ---------------
    torch.cuda.empty_cache()
    probe_launches = probe_phase(workspace, counters)
    paths = {"stream": launches, "frame0": f0_launches,
             "regulariser": reg_launches, "train": train["launches"],
             "lpips": train["lpips"]["launches"], "flow": flow_launches,
             "measure": measure_launches, "cli": cli_launches,
             "enerf": enerf_launches, "oracles": oracle_launches,
             "parallel": parallel_launches, "capture": capture_launches,
             "graft": graft_launches, "probes": probe_launches}
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
    # B7 and B8 at the main path's two calls (the triplane encoder's and
    # the shifted swin windows'), in each precision; "launches" counts the
    # kernel's calls on every path, "shape" names the case timed
    by_case = {(c["case"], c["dtype"]): c for c in attn}
    for case, site in (("triplane", "igs_tpu/models/transformer1d.py:88"),
                       ("swin shifted", "igs_tpu/models/swin.py:150")):
        for dt in ("float32", "bfloat16"):
            c = by_case[(case, dt)]
            for kernel, pre, errs in (("attention_fwd", "", ("out",)),
                                      ("attention_bwd", "bwd_",
                                       ("dq", "dk", "dv"))):
                kernels.append({
                    "name": f"{kernel}/{dt}@{case}",
                    "route": "cuda",
                    "source": "igs_tpu_torch/csrc/attention.cu",
                    "replaces": site,
                    "launches": launches[kernel],
                    "max_abs_err": max(c["max_abs_err"][e] for e in errs),
                    "ms": c[f"{pre}ms"], "plain_ms": c[f"{pre}plain_ms"],
                    "bound_ms": c[f"{pre}bound_ms"],
                    "bound_by": c[f"{pre}bound_by"],
                    "bound_cuda_core_ms": c.get(
                        f"{pre}bound_cuda_core_ms"),
                    "library_ms": c[f"{pre}library_ms"],
                    "library": c["library"], "timing": "eager",
                    "shape": c["shape"],
                    "graph_l2_cold_ms": c[f"{pre}graph_l2_cold_ms"],
                    "eager_l2_cold_ms": c[f"{pre}eager_l2_cold_ms"],
                })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def background_build(cuda_build, sources):
    """Start ``cuda_build.build(sources)`` in a thread; returns a function
    that waits for it and raises what the build raised."""
    import threading

    failed = []

    def run():
        try:
            cuda_build.build(sources)
        except Exception as e:  # re-raised in the waiting thread
            failed.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if failed:
            raise failed[0]
    return wait


def log_ptxas(cuda_build, sources):
    for src in sources:
        for line in cuda_build.BUILD_LOG.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")


class launch_counters:
    """The kernels' launch counters, read and reset together. It holds
    the wrappers themselves, so a check that routes a module's kernel to
    its plain version for a while does not hide the counts."""

    def __init__(self, blend, bw, segred, count):
        from igs_tpu_torch.ops import attention

        self.attention = {"attention_fwd": attention.attention_fwd_cuda,
                          "attention_bwd": attention.attention_bwd_cuda}
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
        for fn in self.attention.values():
            fn.launches = 0

    def read(self):
        out = {f"{name}/{m}": fn.launches_by_mode[m]
               for name, fn in self.by_mode.items() for m in self.modes}
        out["segmented_scan"] = self.scan.launches
        out["count_contributions_packed"] = self.count.launches
        out.update({k: fn.launches for k, fn in self.attention.items()})
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
    for k in ("blend_fwd_win/full", "blend_bwd_win/full", "attention_fwd",
              "attention_bwd"):
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



# ---------------------------------------------------------------------------
# phase 15: the oracle routes (impl="tiles", "reference", compact binning)
# ---------------------------------------------------------------------------

ORACLE_MAPS = ("color", "alpha", "coord", "mcoord", "depth", "mdepth",
               "normal")
ORACLE_GRADS = ("means3d", "opacity", "scaling", "rotation", "shs",
                "means2d_offset")
# the oracles against the kernels: the issue's 2e-4 absolute on maps and
# 1e-3 of each gradient's largest entry, tightened to what the runs on
# an NVIDIA H100 80GB HBM3 at 700 W showed (maps ≤ 3.34e-6, gradients ≤
# 3.81e-6)
TOL_ORACLE_ABS = 2e-5
TOL_ORACLE_GRAD = 2e-5  # of each gradient's largest entry
TOL_ORACLE_PSNR = 0.05  # dB a frame, tiles stream against the packed one
ORACLE_DEPTH_WINDOW = 512  # the JAX stream's depth-carry window off a TPU
ORACLE_SMALL_N = 3000
ORACLE_SMALL_HW = (96, 136)  # partial tiles on both axes
# the key-frame refine on the tiles route, cut from the stream's 50 steps
# (~3.8–4.7 s a step at 1014×1352; 20 until PR 17) to keep the smoke
# under its limit
ORACLE_REFINE_STEPS = 10


def oracle_render(g, cam, settings, cot=None):
    """``rasterize`` of ``g`` through ``settings``: the outputs and, with
    a seeded cotangent ``cot`` on color, depth and normal, the gradients
    of the six inputs (activated parameters as leaves)."""
    import torch

    from igs_tpu_torch.ops.rasterize import rasterize

    grad = cot is not None
    leaves = [x.detach().clone().requires_grad_(grad) for x in (
        g.get_xyz, g.get_opacity, g.get_scaling, g.get_rotation, g.shs)]
    leaves.append(torch.zeros(g.xyz.shape[:-1] + (2,), device=g.xyz.device,
                              requires_grad=grad))
    with torch.set_grad_enabled(grad):
        out = rasterize(*leaves[:4], cam, shs=leaves[4],
                        means2d_offset=leaves[5], valid=g.valid,
                        settings=settings)
        if not grad:
            return out, None
        loss = sum((cot[k] * out[k]).sum() for k in cot)
        return out, torch.autograd.grad(loss, leaves)


def oracle_cotangent(out, seed):
    import torch

    gen = torch.Generator(device=out["color"].device).manual_seed(seed)
    return {k: torch.randn(out[k].shape, generator=gen,
                           device=out[k].device)
            for k in ("color", "depth", "normal")}


def compare_outputs(name, got, want, positions=True):
    """Every map of ``got`` against ``want`` off the threshold-flip pixels:
    those whose contributor count (``positions``; else whether any pair
    contributes) or median (mdepth, mcoord past TOL_ORACLE_ABS) differ.
    The flips may cover at most TOL_FLIP_FRAC of the pixels."""
    import torch

    got = {k: v.detach() for k, v in got.items()}
    want = {k: v.detach() for k, v in want.items()}
    a, b = got["n_contrib"], want["n_contrib"]
    flip = (a != b) if positions else ((a > 0) != (b > 0))
    med = ((got["mdepth"] - want["mdepth"]).abs() > TOL_ORACLE_ABS) | (
        (got["mcoord"] - want["mcoord"]).abs().amax(-3) > TOL_ORACLE_ABS)
    flip = flip | med
    keep = ~flip
    errs = {}
    for k in ORACLE_MAPS:
        d = (got[k] - want[k]).abs()
        if d.dim() == keep.dim() + 1:
            d = d.amax(-3)
        errs[k] = float(d[keep].max()) if bool(keep.any()) else 0.0
    frac = float(flip.float().mean())
    rec = {"case": name, "max_abs_err": errs, "flip_frac": frac,
           "flip_pixels": int(flip.sum()),
           "finite": all(bool(torch.isfinite(got[k]).all())
                         for k in ORACLE_MAPS)}
    rec["ok"] = (rec["finite"] and frac <= TOL_FLIP_FRAC
                 and max(errs.values()) <= TOL_ORACLE_ABS)
    return rec


def compare_grads(name, got, want):
    import torch

    rel = {}
    for k, g, w in zip(ORACLE_GRADS, got, want):
        scale = float(w.abs().max())
        rel[k] = float((g - w).abs().max()) / max(scale, 1e-30)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    return {"case": name, "rel_err": rel, "finite": finite,
            "ok": finite and max(rel.values()) <= TOL_ORACLE_GRAD}


def oracle_times(g, cam, settings, cot, reps_fwd, reps_bwd):
    """ms of the forward (no autograd) and of forward + backward through
    ``rasterize`` (CUDA events), and the peak memory of the latter above
    what was allocated before."""
    import torch

    fwd = cuda_ms(lambda: oracle_render(g, cam, settings), reps_fwd)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fb = cuda_ms(lambda: oracle_render(g, cam, settings, cot), reps_bwd)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return {"fwd_ms": fwd, "fwd_bwd_ms": fb, "fwd_bwd_peak_gib": peak}


def oracle_eval_view(g, cam, budget):
    """(a) the eval view: tiles against the packed route (B1, B2, B3) in
    full mode, forward and the six gradients, and both timed."""
    from igs_tpu_torch.ops.rasterize import RasterSettings

    s = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                       max_pairs=budget, outputs="full")
    tiles = s._replace(impl="tiles")
    packed_out, _ = oracle_render(g, cam, s)
    cot = oracle_cotangent(packed_out, seed=11)
    packed_out, packed_g = oracle_render(g, cam, s, cot)
    tiles_out, tiles_g = oracle_render(g, cam, tiles, cot)
    fwd = compare_outputs("eval 1014x1352", tiles_out, packed_out)
    bwd = compare_grads("eval 1014x1352", tiles_g, packed_g)
    fwd["overflow_tiles"] = [int(tiles_out["overflow_tiles"]),
                             int(packed_out["overflow_tiles"])]
    del packed_out, packed_g, tiles_out, tiles_g
    times = {"tiles": oracle_times(g, cam, tiles, cot, 3, 2),
             "pallas_packed": oracle_times(g, cam, s, cot, 10, 10)}
    return fwd, bwd, times


def oracle_depth_carry(g, cams):
    """(b) the 4×128² depth carry at the JAX stream's 512-row window:
    tiles against the windowed route (B5a), both dropping the same
    pairs."""
    from igs_tpu_torch.ops.rasterize import RasterSettings

    s = RasterSettings(image_height=128, image_width=128, max_pairs=1 << 19,
                       impl="pallas", max_per_tile=ORACLE_DEPTH_WINDOW,
                       outputs="full")
    win, _ = oracle_render(g, cams, s)
    tiles, _ = oracle_render(g, cams, s._replace(impl="tiles"))
    rec = compare_outputs("depth-carry 4x128x128 window 512", tiles, win)
    ovf_t = tiles["overflow_tiles"].tolist()
    ovf_w = win["overflow_tiles"].tolist()
    rec.update(overflow_tiles={"tiles": ovf_t, "pallas": ovf_w})
    rec["ok"] = rec["ok"] and ovf_t == ovf_w and max(ovf_t) > 0
    rec["ms"] = {
        "tiles": cuda_ms(lambda: oracle_render(
            g, cams, s._replace(impl="tiles")), 3),
        "pallas": cuda_ms(lambda: oracle_render(g, cams, s), 10)}
    return rec


def oracle_small_scene(dev, c2ws):
    """(c) ~3 000 Gaussians at 96×136: reference against tiles against
    packed, forward and the six gradients; the reference timed."""
    from igs_tpu_torch.core.camera import Camera
    from igs_tpu_torch.core.gaussians import Gaussians
    from igs_tpu_torch.ops.rasterize import RasterSettings

    g = Gaussians.create(*scene_gaussians(0.0, ORACLE_SMALL_N, seed=1,
                                          static_frac=0.0,
                                          scale_range=(-3.2, -2.2)),
                         device=dev)
    cam = Camera.from_c2w(c2ws[EVAL_VIEW], (FOV, FOV), ORACLE_SMALL_HW,
                          device=dev)
    s = RasterSettings(image_height=ORACLE_SMALL_HW[0],
                       image_width=ORACLE_SMALL_HW[1], max_pairs=1 << 20,
                       outputs="full")
    routes = {"reference": s._replace(impl="reference"),
              "tiles": s._replace(impl="tiles"), "pallas_packed": s}
    ref_out, _ = oracle_render(g, cam, routes["reference"])
    cot = oracle_cotangent(ref_out, seed=12)
    res = {k: oracle_render(g, cam, v, cot) for k, v in routes.items()}
    recs = []
    for a, b in (("tiles", "reference"), ("pallas_packed", "reference"),
                 ("tiles", "pallas_packed")):
        name = f"small {ORACLE_SMALL_HW[0]}x{ORACLE_SMALL_HW[1]} {a} vs {b}"
        fwd = compare_outputs(name, res[a][0], res[b][0],
                              positions=b != "reference")
        bwd = compare_grads(name, res[a][1], res[b][1])
        recs.append({"case": name, "fwd": fwd, "bwd": bwd,
                     "ok": fwd["ok"] and bwd["ok"]})
    del res
    return recs, oracle_times(g, cam, routes["reference"], cot, 3, 2)


def oracle_compact(g, cam, budget):
    """(d) compact against sort binning at the eval view: the lists and
    counts equal (no tile truncates at 4096), and the tiles route's render
    from the compact lists bit-equal to the sort route's; both binnings
    timed."""
    import torch

    from igs_tpu_torch.ops.binning import (
        build_tile_lists_compact, build_tile_pairs, image_tile_grid)
    from igs_tpu_torch.ops.projection import project
    from igs_tpu_torch.ops.rasterize import RasterSettings
    from igs_tpu_torch.ops.render_tiles import pairs_to_idx_table

    maxpt = 4096
    proj = project(g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                   cam, shs=g.shs, valid=g.valid)
    gx, gy = image_tile_grid(*OUT_HW)

    def sort():
        pairs = build_tile_pairs(proj, gx, gy, budget)
        return pairs_to_idx_table(pairs, maxpt), pairs.tile_count

    def compact():
        return build_tile_lists_compact(proj, gx, gy, maxpt)

    s_idx, s_cnt = sort()
    c_idx, c_cnt = compact()
    c_idx, c_cnt = c_idx.reshape(s_idx.shape), c_cnt.reshape(-1)
    whole = s_cnt <= maxpt
    lists_equal = bool(torch.equal(c_idx[whole], s_idx[whole])) and bool(
        torch.equal(c_cnt[whole], s_cnt[whole]))
    rec = {"lists_equal": lists_equal, "tiles": int(s_cnt.numel()),
           "truncated_tiles": int((~whole).sum()),
           "deepest": int(s_cnt.max()),
           "sort_ms": cuda_ms(sort, 5), "compact_ms": cuda_ms(compact, 5)}
    del s_idx, c_idx
    s = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                       max_pairs=budget, impl="tiles", max_per_tile=maxpt,
                       outputs="full")
    a, _ = oracle_render(g, cam, s)
    b, _ = oracle_render(g, cam, s._replace(binning="compact"))
    rec["render_bit_equal"] = all(bool(torch.equal(a[k], b[k]))
                                  for k in ORACLE_MAPS + ("n_contrib",))
    rec["ok"] = lists_equal and rec["render_bit_equal"]
    return rec


def oracle_stream(dev, model, stream, cfg, refine_cfg, counters, agm_ms):
    """(e) one window (B=5) and its key-frame refine through
    ``StreamingPipeline`` with ``impl="tiles"``: AGM ms (the model's CUDA
    event hooks), refine ms a step and s, PSNR; the route must launch no
    rasterizer kernel (the network's attention is B7 on every route)."""
    import torch

    from igs_tpu_torch.builders import build_raster_settings
    from igs_tpu_torch.stream.pipeline import StreamingPipeline

    settings = build_raster_settings(*OUT_HW, impl="tiles")
    pipe = StreamingPipeline(
        model, stream, dataclasses.replace(
            cfg, refine_iterations=ORACLE_REFINE_STEPS), refine_cfg,
        settings, device=dev)
    before, first_agm = counters.read(), len(agm_ms)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = pipe.run(max_batches=1)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    after = counters.read()
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    rec = pipe.refine_log[0]
    losses = rec["losses"]
    return {
        "wall_s": wall, "peak_gib": peak, "agm_ms": agm_ms[first_agm:],
        "refine_ms_per_step": rec["ms_per_step"],
        "refine_s": rec["seconds"], "refine_steps": len(losses),
        "loss_first5": float(np.mean(losses[:5])),
        "loss_last5": float(np.mean(losses[-5:])),
        "psnr": res["psnr"], "eval_psnr_before": rec["eval_psnr_before"],
        "eval_psnr_after": rec["eval_psnr_after"],
        "overflow_events": res["overflow_events"], "fps_render": res["fps"],
        "settings": {k: getattr(pipe, k)._asdict() for k in (
            "agm_settings", "depth_settings", "refine_settings")},
        "kernel_launches": launched,
    }


def frame0_window(g_scene, cams_scene, rec):
    """(f) the frame-0 cell's 20 views at 512²: the tiles past the JAX
    build_frame0's 2048-pair window (build_frame0.py:155,268), for the
    scene the views were rendered from and for the exported Gaussians."""
    from igs_tpu_torch.ops.rasterize import RasterSettings, build_pairs_packed

    s = RasterSettings(image_height=F0_RES, image_width=F0_RES,
                       max_pairs=F0_MAX_PAIRS)
    densest, over = [], []
    for v in range(cams_scene.world_view_transform.shape[0]):
        pairs = build_pairs_packed(g_scene.get_xyz, g_scene.get_opacity,
                                   g_scene.get_scaling, g_scene.get_rotation,
                                   cams_scene.view(v), valid=g_scene.valid,
                                   settings=s)
        densest.append(int(pairs.tile_count.max()))
        over.append(int((pairs.tile_count > JAX_MAX_PER_TILE).sum()))
    return {"scene": {"densest_tile_pairs": max(densest),
                      "tiles_over_2048": sum(over),
                      "views_with_tiles_over_2048": sum(o > 0 for o in over)},
            "exported": tile_density(rec["state"].gaussians, rec["filter"],
                                     rec["cameras"], rec["settings"])}


def oracle_phase(dev, start_gs, eval_cam, depth_cams, c2ws, model, stream,
                 cfg, refine_cfg, counters, agm_ms, packed, f0_window_rec):
    """Phase 15, (a)–(f); counters reset just before and read just after
    (the "oracles" path: the kernel launches of the routes held against
    the oracles). ``packed`` holds the packed stream's window-1 numbers
    from phase 6 (None skips the comparison)."""
    import torch

    from igs_tpu_torch.builders import build_raster_settings

    torch.cuda.empty_cache()
    budget = build_raster_settings(*OUT_HW).max_pairs
    counters.reset()
    t0 = time.perf_counter()
    fwd, bwd, times = oracle_eval_view(start_gs, eval_cam, budget)
    log(f"oracle eval tiles vs packed (B1 full): {json.dumps(fwd)}")
    log(f"oracle eval tiles vs packed (B2 + B3 full): {json.dumps(bwd)}")
    log(f"oracle eval times (CUDA events; peak above the live set): "
        f"{json.dumps(times)}")
    depth = oracle_depth_carry(start_gs, depth_cams)
    log(f"oracle depth carry tiles vs windowed (B5a full): "
        f"{json.dumps(depth)}")
    torch.cuda.empty_cache()
    small, ref_times = oracle_small_scene(dev, c2ws)
    for r in small:
        log(f"oracle {r['case']}: {json.dumps(r)}")
    log(f"oracle small reference times: {json.dumps(ref_times)}")
    compact = oracle_compact(start_gs, eval_cam, budget)
    log(f"oracle compact vs sort binning (eval): {json.dumps(compact)}")
    torch.cuda.empty_cache()
    kernel_wall = time.perf_counter() - t0
    launches = counters.read()
    stream_rec = oracle_stream(dev, model, stream, cfg, refine_cfg, counters,
                               agm_ms)
    log(f"oracle stream (impl=tiles): {json.dumps(stream_rec)}")
    if packed is not None:
        log(f"oracle stream, the packed stream's window 1 of phase 6: "
            f"{json.dumps(packed)}")
    log(f"oracle frame-0 window (JAX build_frame0's 2048 rows): "
        f"{json.dumps(f0_window_rec)}")
    log(f"oracles: {kernel_wall:.1f} s for (a)-(d), {stream_rec['wall_s']:.1f}"
        f" s for (e); launches {json.dumps(launches)}")

    bad = [r["case"] for r in (fwd, bwd, depth) if not r["ok"]]
    bad += [r["case"] for r in small if not r["ok"]]
    if not compact["ok"]:
        bad.append("compact vs sort binning")
    if bad:
        raise RuntimeError(f"the oracles disagree with the kernel routes: "
                           f"{bad}")
    # the tiles route renders through no kernel of ours; the network's
    # attention runs B7 on every route
    raster = {k: v for k, v in stream_rec["kernel_launches"].items()
              if not k.startswith("attention_")}
    if raster or not stream_rec["kernel_launches"].get("attention_fwd"):
        raise RuntimeError(f"the tiles stream launched rasterizer kernels "
                           f"or no attention: "
                           f"{stream_rec['kernel_launches']}")
    if not (stream_rec["refine_steps"] == ORACLE_REFINE_STEPS
            and stream_rec["loss_last5"] < stream_rec["loss_first5"]
            and stream_rec["eval_psnr_after"]
            >= stream_rec["eval_psnr_before"]):
        raise RuntimeError("the tiles stream's refine did not lower the loss "
                           "or lowered the eval PSNR")
    psnr = list(stream_rec["psnr"].values())
    if len(psnr) != B or not all(math.isfinite(p) for p in psnr):
        raise RuntimeError(f"tiles stream PSNR {psnr}")
    if packed is not None:
        # the frames before the key frame's refine: the same AGM forward
        gap = max(abs(stream_rec["psnr"][k] - packed["psnr"][k])
                  for k in list(stream_rec["psnr"])[:B - 1])
        log(f"oracle stream: max |PSNR tiles - packed| over frames 0-{B - 2}"
            f" {gap:.5f} dB (tolerance {TOL_ORACLE_PSNR})")
        if gap > TOL_ORACLE_PSNR:
            raise RuntimeError("the tiles stream's PSNR disagrees with the "
                               "packed stream's")
    for k in ("blend_fwd_packed/full", "blend_bwd_packed/full",
              "segmented_scan", "blend_fwd_win/full"):
        if launches[k] == 0:
            raise RuntimeError(f"the oracle phase did not launch {k}")
    return launches


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
        if re.search("sdpa|fmha|flash|attention|attn_", key, re.I):
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
              "blend_bwd_packed/color", "segmented_scan", "attention_fwd"):
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
    ("igs_tpu_torch.profile_stages", ()),
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
                 "blend_bwd_packed/color", "blend_fwd_packed/color_depth",
                 "attention_fwd"),
    "profile_stages": ("blend_fwd_packed/color", "blend_bwd_packed/color",
                       "segmented_scan", "blend_fwd_packed/color_depth",
                       "attention_fwd"),
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
            f"{timings['roofline'][key]}")
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


# ---------------------------------------------------------------------------
# phase 16: the parallel paths over torch.distributed
# ---------------------------------------------------------------------------

PAR_HW = (1024, 1352)  # 64 tile rows split in 2 and 4 (1014 do not, C30)
PAR_B = 4  # eval_batch_size: two candidates a rank
PAR_ITEMS = 4  # one window and its key frame
PAR_RANKS = 2  # ranks sharing the one card over gloo
PAR_REFINE_STEPS = 20  # the stream's 50, cut for time (depth, not width)
PAR_JOIN_S = 420  # seconds a group of ranks may run before it is killed
TOL_STRIP_GRAD = 1e-5  # strips' summed grads, of each tensor's largest
TOL_PAR_PSNR = 0.01  # dB a frame before the refine (PERF.md §2)
TOL_PAR_PSNR_REFINED = 0.05  # dB, the refined frame
TOL_PAR_LOSS = 1e-3  # per-step refine loss, relative
DP_STEPS = 3
TOL_DP_LOSS = 1e-5  # C18
# C18's gradient bounds (tests/test_torch_port_train.py): 2e-4 of each
# tensor's largest entry plus 1e-3 relative, 2e-2 in the trained
# backbone's stem and first two stages
TOL_DP_GRAD = 2e-4
TOL_DP_GRAD_EARLY = 2e-2
EARLY_CNN = ("backbone.backbone.conv1.", "backbone.backbone.layer1.",
             "backbone.backbone.layer2.0.")
PAR_F0_ITERS = 200  # the frame-0 build's 6000, cut for time
PAR_F0_FINETUNE = 20
# bench_scaling's defaults: its train step and refine at world size 1
PAR_BENCH = dict(hw=128, n_gaussians=8192, anchors=512, iters=5)
PAR_POOL_ITERS = 30
PAR_POOL_FINETUNE = 10
TOL_F0_PSNR = 0.05  # dB, each frame's exported renders, sweep vs sequential


def _tf32_off():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _HostEvent:
    """A ``torch.cuda.Event`` stand-in on the host clock, for ranks on the
    CPU (the phase's rehearsal)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def _event(dev):
    """A recorded timing event on ``dev``."""
    import torch

    e = (torch.cuda.Event(enable_timing=True)
         if torch.device(dev).type == "cuda" else _HostEvent())
    e.record()
    return e


def _peak_gib(dev):
    import torch

    if torch.device(dev).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2**30


def _rank_counters():
    from igs_tpu_torch.ops import blend, segred
    from igs_tpu_torch.ops import blend_windowed as bw
    from igs_tpu_torch.ops import count as count_mod

    return launch_counters(blend, bw, segred, count_mod)


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def strip_render(g, cam, settings, row0, cot):
    """One color render (a strip from tile row ``row0``, or the whole image
    when None) with a gradient: (color, the grads of the five raw
    parameters and of the screen offset of sum(color · cotangent rows))."""
    import torch

    names = ("xyz", "opacity", "scaling", "rotation", "shs")
    params = {k: getattr(g, k).detach().clone().requires_grad_(True)
              for k in names}
    m2o = torch.zeros((g.num_capacity, 2), device=g.xyz.device,
                      requires_grad=True)
    gg = dataclasses.replace(g, **params)
    from igs_tpu_torch.ops.rasterize import rasterize

    out = rasterize(gg.get_xyz, gg.get_opacity, gg.get_scaling,
                    gg.get_rotation, cam, shs=gg.shs, means2d_offset=m2o,
                    valid=gg.valid, settings=settings, strip_row0=row0)
    r0 = 0 if row0 is None else row0 * 16
    loss = (out["color"] * cot[:, r0:r0 + settings.image_height]).sum()
    grads = torch.autograd.grad(loss, [params[k] for k in names] + [m2o])
    return out["color"].detach(), grads


def strip_check(g, c2w, counters):
    """(a) the eval view at PAR_HW rendered whole and in 2 and 4 strips,
    forward and backward through B1, B2 and B3; then B1, B2 and B3 against
    their plain versions on one strip. Returns the record and the
    launches of the renders."""
    import torch

    from igs_tpu_torch.builders import build_raster_settings
    from igs_tpu_torch.core.camera import Camera
    from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
    from igs_tpu_torch.ops.projection import project
    from igs_tpu_torch.ops.rasterize import to_strip
    from igs_tpu_torch.stream.refine import strip_settings

    dev = g.xyz.device
    cam = Camera.from_c2w(c2w, (FOV, FOV), PAR_HW, device=dev)
    full = build_raster_settings(*PAR_HW, clamp=False)._replace(
        outputs="color")
    gen = torch.Generator(device=dev).manual_seed(16)
    cot = 1e-3 * torch.randn((3,) + PAR_HW, generator=gen, device=dev)
    names = ("xyz", "opacity", "scaling", "rotation", "shs",
             "means2d_offset")  # the last: its y × strips, C33
    counters.reset()
    color, grads = strip_render(g, cam, full, None, cot)
    rec = {"hw": PAR_HW, "full_ms": cuda_ms(
        lambda: strip_render(g, cam, full, None, cot), reps=3)}
    for n in (2, 4):
        ss = strip_settings(full, n)
        rows = ss.image_height // 16
        parts = [strip_render(g, cam, ss, i * rows, cot) for i in range(n)]
        joined = torch.cat([c for c, _ in parts], dim=-2)
        sums = [sum(gr[j] for _, gr in parts) for j in range(len(names))]
        # a strip scales the offset's y by its own height (as the JAX
        # package, ROADMAP C33): scaled back to the image's here
        sums[-1] = sums[-1] * torch.tensor([1.0, PAR_HW[0] / ss.image_height],
                                           device=dev)
        rel = {k: float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
               for k, a, b in zip(names, sums, grads)}
        rec[f"strips_{n}"] = {
            "rows": ss.image_height,
            "forward_max_abs_diff": float((joined - color).abs().max()),
            "forward_bit_equal": bool(torch.equal(joined, color)),
            "grad_rel_err": rel,
            "strip_ms": [cuda_ms(lambda i=i: strip_render(
                g, cam, ss, i * rows, cot), reps=3) for i in range(n)]}
    launches = counters.read()
    log(f"parallel (a) strips: {json.dumps(rec)}")
    for n in (2, 4):
        r = rec[f"strips_{n}"]
        if (r["forward_max_abs_diff"] > TOL_ABS
                or max(r["grad_rel_err"].values()) > TOL_STRIP_GRAD):
            raise RuntimeError(f"{n} strips disagree with the whole render: "
                               f"{json.dumps(r)}")
    # the kernels against their plain versions on the last of 2 strips
    hs, row0 = PAR_HW[0] // 2, PAR_HW[0] // 32
    budget = full.max_pairs
    inputs = packed_inputs(g, cam.batched(), (hs, PAR_HW[1]), "color",
                           budget, strip_row0=row0)
    name = f"strip 2/2 {hs}x{PAR_HW[1]}"
    checks = {"fwd": compare_kernel(name, *inputs, "color"),
              "bwd": compare_backward(name, *inputs, "color")}
    proj = to_strip(project(g.get_xyz, g.get_scaling, g.get_rotation,
                            g.get_opacity, cam.batched(), shs=g.shs,
                            valid=g.valid, geometry=False), row0, hs // 16)
    ids = build_tile_pairs(proj, *image_tile_grid(hs, PAR_HW[1]), budget,
                           segred_aux=True).exp_gauss_id
    x = torch.where(ids[None] >= 0, 1e-3 * torch.randn(
        (16, ids.shape[0]), generator=gen, device=dev), torch.zeros(
            (16, ids.shape[0]), device=dev))
    abs_err, rel_err, repeat = scan_check(x, ids)
    log(f"parallel (a) segscan-vs-plain on {name}: "
        f"{json.dumps({'rows': int(ids.shape[0]), 'max_abs_err': abs_err, 'max_rel_err': rel_err, 'bitwise_repeat': repeat})}")
    if not (checks["fwd"]["ok"] and checks["bwd"]["ok"] and repeat
            and rel_err <= TOL_SCAN_REL):
        raise RuntimeError(f"a kernel disagrees with its plain version on "
                           f"{name}")
    return rec, launches


def par_stream_spec(dp, rp, workspace):
    """What ``par_stream_run`` reads of this module's settings (a spawned
    rank imports the module afresh, so its caller passes them)."""
    return {"system": SYSTEM, "anchors": ANCHORS, "hw": PAR_HW,
            "workspace": workspace,
            "opt": dict(OPT, eval_batch_size=PAR_B,
                        refine_iterations=PAR_REFINE_STEPS,
                        data_parallel=dp, refine_parallel=rp)}


def par_stream_run(rank, device, stream_path, spec):
    """One window and its key-frame refine through ``StreamingPipeline``
    on the config of ``spec`` (``par_stream_spec``), on this rank (or
    alone): results, refine log, AGM-forward ms and this process's
    launches."""
    import pickle

    import torch

    from igs_tpu_torch.builders import (
        build_model, build_raster_settings, build_stream_configs)
    from igs_tpu_torch.stream.pipeline import StreamingPipeline

    _tf32_off()
    dev = torch.device(device)
    with open(stream_path, "rb") as f:
        stream = pickle.load(f)
    model = build_model(spec["system"], device=dev,
                        generator=torch.Generator().manual_seed(0))
    agm_ms, ev = [], {}
    model.register_forward_pre_hook(lambda m, a: ev.update(s=_event(dev)))

    def post(m, a, out):
        e = _event(dev)
        e.synchronize()
        agm_ms.append(ev["s"].elapsed_time(e))

    model.register_forward_hook(post)
    cfg, rcfg = build_stream_configs(spec["opt"])
    cfg = dataclasses.replace(cfg, anchor_size=spec["anchors"], neighbor_k=8,
                              depth_view_res=128, save_images=False,
                              workspace=spec["workspace"])
    counters = _rank_counters()
    counters.reset()
    pipe = StreamingPipeline(model, stream, cfg, rcfg,
                             build_raster_settings(*spec["hw"]), device=dev)
    t0 = time.perf_counter()
    res = pipe.run(max_batches=1)
    return {"results": res, "refine_log": pipe.refine_log,
            "agm_ms": agm_ms, "wall_s": time.perf_counter() - t0,
            "launches": counters.read(), "peak_gib": _peak_gib(dev)}


def dp_train_spec(root, max_pairs):
    """What ``dp_train_steps`` reads of this module's settings."""
    return {"cfg": train_config(root, None, max_pairs), "res": TRAIN_RES,
            "anchors": ANCHORS, "steps": DP_STEPS}


def dp_train_steps(rank, device, spec):
    """``spec["steps"]`` train steps of the training recipe ``spec["cfg"]``
    on the items (0, 1), (2, 3), … of its scene through
    ``make_train_step``, data-parallel over the group's ranks (each its
    ``local_batch_slice``) or, alone, on the whole batch: per-step losses
    and ms, the clipped gradient of step 1 (Adam's first moment over
    1 − b1) and the launches."""
    import torch

    from igs_tpu_torch.builders import (
        build_dataset, build_model, build_opt_config, build_raster_settings)
    from igs_tpu_torch.parallel import distributed as D
    from igs_tpu_torch.parallel.mesh import make_mesh
    from igs_tpu_torch.train.driver import make_optimizer, make_train_step
    from igs_tpu_torch.train_agm import prep_batch

    _tf32_off()
    dev = torch.device(device)
    cfg = spec["cfg"]
    ds = build_dataset(cfg["data"], training=True)
    model = build_model(cfg["system"], device=dev, train=True,
                        generator=torch.Generator().manual_seed(0))
    ocfg = build_opt_config(cfg["opt"])
    settings = build_raster_settings(spec["res"], spec["res"], clamp=True,
                                     max_pairs=cfg["opt"]["max_pairs"])
    batch_size = cfg["opt"]["batch_size"]
    optimizer, _ = make_optimizer(
        model, ocfg, ocfg.num_epochs * (len(ds) // batch_size),
        train_backbone=model.train_backbone)
    world = D.process_count()
    mesh = make_mesh(data=world, tile=1, device=dev) if world > 1 else None
    step = make_train_step(ocfg, settings, mesh=mesh)
    counters = _rank_counters()
    counters.reset()
    losses, ms, mu1 = [], [], None
    for s in range(spec["steps"]):
        idxs = list(range(batch_size * s, batch_size * (s + 1)))
        items = [ds[i] for i in idxs[D.local_batch_slice(batch_size)]]
        batch = prep_batch(ds, items, dev, spec["anchors"], 8)
        e0 = _event(dev)
        m = step(model, optimizer, *batch)
        e1 = _event(dev)
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(m["loss"]))
        if s == 0:
            mu1 = {k: (v / (1 - ocfg.beta1)).cpu()
                   for k, v in optimizer.mu.items()}
    return {"losses": losses, "ms": ms, "mu1": mu1,
            "launches": counters.read()}


def nccl_rank(rank, device, bench_args):
    """(e) in a group of one rank under NCCL: NCCL's gather (of floats and
    of bools), sum and max through ``distributed``, and one data-parallel
    train step (bench_scaling's, at ``bench_args``) through its mesh."""
    import torch
    import torch.distributed as dist

    from igs_tpu_torch import bench_scaling
    from igs_tpu_torch.parallel import distributed as D

    _tf32_off()
    x = torch.arange(6.0, device=device)
    mask = x > 2
    gather_ok = (torch.equal(D.all_gather(x), x[None])
                 and torch.equal(D.all_gather(mask), mask[None])
                 and torch.equal(D.all_reduce(x), x)
                 and torch.equal(D.all_reduce(x, op="max"), x))
    counters = _rank_counters()
    counters.reset()
    step = bench_scaling.train_rank(rank, device, bench_args)
    return {"backend": dist.get_backend(), "world": D.process_count(),
            "gather_ok": bool(gather_ok), **step,
            "launches": counters.read()}


def frame_psnr(frame_dir, mode, iters):
    """Mean PSNR of a frame's exported renders against its images."""
    import glob
    import os

    from igs_tpu_torch.data.images import load_images_nchw

    gt_dir = os.path.join(frame_dir, mode, "train", f"ours_{iters}_compress",
                          "gt")
    names = sorted(os.listdir(gt_dir))
    outs = load_images_nchw([os.path.join(gt_dir, n) for n in names],
                            F0_RES, F0_RES)
    imgs = load_images_nchw(sorted(glob.glob(os.path.join(
        frame_dir, "images_512", "*.png")))[:len(names)], F0_RES, F0_RES)
    return float(np.mean([-10 * np.log10(np.mean((o - i) ** 2))
                          for o, i in zip(outs, imgs)]))


def parallel_phase(dev, workspace, counters, c2ws, train_root,
                   train_max_pairs):
    """Phase 16: the parallel paths. (a) strips on the kernels; (b) the
    stream on PAR_RANKS ranks sharing the card (gloo) against one
    process; (c) DP_STEPS data-parallel train steps against one process;
    (d) ``build_frame0 --spmd`` on two frames against the sequential
    build of each under the same view order, and the ``--workers`` pool;
    (e) NCCL at world size 1 and ``bench_scaling``. Returns the path's
    launches: (a)'s renders and every rank's."""
    import os
    import pickle

    import torch

    from igs_tpu_torch import bench_scaling
    from igs_tpu_torch.build_frame0 import train_frames_spmd, train_one_frame
    from igs_tpu_torch.parallel.launch import spawn

    gloo = dict(backend="gloo", devices=[str(dev)] * PAR_RANKS,
                timeout_s=PAR_JOIN_S)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # -- (b)'s scene, whose start Gaussians (a) renders
    t0 = time.perf_counter()
    stream, g0, _ = build_stream(dev, PAR_ITEMS, out_hw=PAR_HW,
                                 interval=PAR_B)
    stream_path = os.path.join(workspace, "par_stream.pkl")
    with open(stream_path, "wb") as f:
        pickle.dump(stream, f, protocol=pickle.HIGHEST_PROTOCOL)
    log(f"parallel: scene at {PAR_HW[0]}x{PAR_HW[1]}, {PAR_ITEMS} items, "
        f"written in {time.perf_counter() - t0:.1f} s")
    strips, launches = strip_check(g0.pad_to(MAX_NUM), c2ws[EVAL_VIEW],
                                   counters)
    del stream, g0
    torch.cuda.empty_cache()

    # -- (b) the stream: one process, then two ranks on the card
    t0 = time.perf_counter()
    one = par_stream_run(0, str(dev), stream_path, par_stream_spec(
        1, 1, os.path.join(workspace, "par_one")))
    t_one = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    two = spawn(par_stream_run, PAR_RANKS, (stream_path, par_stream_spec(
        PAR_RANKS, PAR_RANKS, os.path.join(workspace, "par_two"))), **gloo)
    t_two = time.perf_counter() - t0
    for r in two:
        _add(launches, r["launches"])
        if not r["launches"].get("attention_fwd"):
            raise RuntimeError("a rank of the parallel stream did not launch "
                               "the attention forward")
    want, got = one["results"], two[0]["results"]
    psnr_diff = {k: abs(got["psnr"][k] - w) for k, w in want["psnr"].items()}
    refined = f"frame_{PAR_B - 1}"
    w_log, g_log = one["refine_log"][0], two[0]["refine_log"][0]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(g_log["losses"],
                                                    w_log["losses"])]
    stream_rec = {
        "one_process": {"psnr": want["psnr"], "points_num":
                        want["points_num"], "agm_ms": one["agm_ms"],
                        "refine_ms_per_step": w_log["ms_per_step"],
                        "refine_s": w_log["seconds"], "wall_s": t_one,
                        "eval_psnr_before": w_log["eval_psnr_before"],
                        "peak_gib": one["peak_gib"]},
        "two_ranks_sharing_one_card": {
            "psnr": got["psnr"], "points_num": got["points_num"],
            "agm_ms": [r["agm_ms"] for r in two],
            "refine_ms_per_step": [r["refine_log"][0]["ms_per_step"]
                                   for r in two],
            "refine_s": [r["refine_log"][0]["seconds"] for r in two],
            "wall_s": t_two, "peak_gib": [r["peak_gib"] for r in two],
            "ranks_equal": all(r["results"]["psnr"] == got["psnr"]
                               for r in two)},
        "psnr_abs_diff": psnr_diff, "refine_loss_rel_diff": loss_rel,
        "refine_loss_first_last": [g_log["losses"][0], g_log["losses"][-1]]}
    log(f"parallel (b) stream: {json.dumps(stream_rec)}")
    if not (stream_rec["two_ranks_sharing_one_card"]["ranks_equal"]
            and all(d <= (TOL_PAR_PSNR_REFINED if k == refined
                          else TOL_PAR_PSNR) for k, d in psnr_diff.items())
            and got["points_num"] == want["points_num"]
            and len(loss_rel) == PAR_REFINE_STEPS
            and max(loss_rel) <= TOL_PAR_LOSS
            and got["overflow_events"] == want["overflow_events"] == []):
        raise RuntimeError("the stream on two ranks disagrees with one "
                           "process")
    os.remove(stream_path)

    # -- (c) data-parallel train steps
    torch.cuda.empty_cache()
    spec = dp_train_spec(train_root, train_max_pairs)
    one = dp_train_steps(0, str(dev), spec)
    two = spawn(dp_train_steps, PAR_RANKS, (spec,), **gloo)
    for r in two:
        _add(launches, r["launches"])
        if not (r["launches"].get("attention_fwd")
                and r["launches"].get("attention_bwd")):
            raise RuntimeError("the data-parallel train step did not launch "
                               "the attention kernels")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(two[0]["losses"],
                                                    one["losses"])]
    grad_err = {}
    for k, w in one["mu1"].items():
        tol = TOL_DP_GRAD_EARLY if k.startswith(EARLY_CNN) else TOL_DP_GRAD
        excess = ((two[0]["mu1"][k] - w).abs()
                  - (tol * float(w.abs().max()) + 1e-3 * w.abs() + 1e-7))
        grad_err[k] = float(excess.max())
    worst = max(grad_err, key=grad_err.get)
    train_rec = {"losses_one": one["losses"], "losses_two": two[0]["losses"],
                 "loss_rel_diff": loss_rel, "ms_one": one["ms"],
                 "ms_two_ranks_sharing_one_card": [r["ms"] for r in two],
                 "grad_tensors": len(grad_err), "worst_grad": worst,
                 "worst_grad_excess": grad_err[worst]}
    log(f"parallel (c) train: {json.dumps(train_rec)}")
    if max(loss_rel) > TOL_DP_LOSS or grad_err[worst] > 0:
        raise RuntimeError("the data-parallel step disagrees with one "
                           "process beyond C18's bounds")

    # -- (d) the frame-0 sweep over two ranks, the sequential build, the pool
    torch.cuda.empty_cache()
    f0_root = os.path.join(workspace, "par_frames")
    dirs = [write_frame0(dev, f0_root, frame=f, seed=1 + f)[0]
            for f in range(2)]
    t0 = time.perf_counter()
    recs = train_frames_spmd(dirs, "images_512", "spmd", PAR_F0_ITERS,
                             F0_PRUNE, F0_CAPACITY, n_devices=PAR_RANKS,
                             finetune_iters=PAR_F0_FINETUNE,
                             device=str(dev), backend="gloo",
                             share_card=True)
    t_sweep = time.perf_counter() - t0
    for r in {r["rank"]: r for r in recs}.values():
        _add(launches, r["rank_launches"])
    sweep = []
    for d, r in zip(dirs, recs):
        seq = train_one_frame(d, "images_512", "seq", PAR_F0_ITERS, F0_PRUNE,
                              F0_CAPACITY, finetune_iters=PAR_F0_FINETUNE,
                              device=dev, view_order=r["view_order"])
        sweep.append({
            "frame": d, "rank": r["rank"], "n_final": r["n_final"],
            "n_final_sequential": seq["n_final"],
            "psnr": frame_psnr(d, "spmd", PAR_F0_ITERS),
            "psnr_sequential": frame_psnr(d, "seq", PAR_F0_ITERS),
            "ms_per_step": r["ms_per_step"],
            "ms_per_step_sequential": seq["ms_per_step"]})
        del seq
    t0 = time.perf_counter()
    pool = subprocess.run(
        [sys.executable, "-m", "igs_tpu_torch.build_frame0", "--scene",
         f0_root, "--workers", "2", "--devices", "0,0", "--gs-mode", "pool",
         "--iterations", str(PAR_POOL_ITERS), "--finetune-iters",
         str(PAR_POOL_FINETUNE), "--capacity", str(F0_CAPACITY),
         "--device", dev.type],
        capture_output=True, text=True, timeout=PAR_JOIN_S)
    ply = os.path.join("pool", "point_cloud",
                       f"iteration_{PAR_POOL_ITERS}_compress",
                       "point_cloud.ply")
    frames_rec = {"sweep_s_two_ranks_sharing_one_card": t_sweep,
                  "frames": sweep, "pool_rc": pool.returncode,
                  "pool_s": time.perf_counter() - t0,
                  "pool_written": [os.path.exists(os.path.join(d, ply))
                                   for d in dirs]}
    log(f"parallel (d) frame 0: {json.dumps(frames_rec)}")
    if pool.returncode:
        log(pool.stdout[-4000:])
        log(pool.stderr[-4000:])
    if (pool.returncode or not all(frames_rec["pool_written"])
            or any(s["n_final"] != s["n_final_sequential"]
                   or abs(s["psnr"] - s["psnr_sequential"]) > TOL_F0_PSNR
                   for s in sweep)):
        raise RuntimeError("the frame-0 sweep disagrees with the sequential "
                           "build, or the worker pool failed")

    # -- (e) NCCL at world size 1, and bench_scaling
    torch.cuda.empty_cache()
    (nccl,) = spawn(nccl_rank, 1, (PAR_BENCH,), backend="nccl",
                    devices=["cuda:0"], timeout_s=PAR_JOIN_S)
    _add(launches, nccl.pop("launches"))
    bench = bench_scaling.run("all", max_ranks=1, device="cuda",
                              backend="nccl", out=os.path.join(
                                  workspace, "bench_scaling.json"),
                              **PAR_BENCH)
    log(f"parallel (e) nccl: {json.dumps(nccl)}; bench_scaling "
        f"{json.dumps(bench)}")
    if not (nccl["backend"] == "nccl" and nccl["world"] == 1
            and nccl["gather_ok"] and math.isfinite(nccl["sec_per_step"])
            and set(bench) == {"1", "refine_1"}):
        raise RuntimeError("NCCL at world size 1 or bench_scaling failed")
    for k in ("blend_fwd_packed/color", "blend_bwd_packed/color",
              "segmented_scan", "blend_fwd_packed/color_depth",
              "count_contributions_packed"):
        if launches.get(k, 0) == 0:
            raise RuntimeError(f"the parallel phase did not launch {k}")
    log(f"parallel: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{json.dumps(launches)}")
    return launches


# ---------------------------------------------------------------------------
# phase 17: from a capture to a stream, and the graft entry
# ---------------------------------------------------------------------------

CAP_FRAMES = 6  # frames 0-5: one window of B=5 and its key frame 5
CAP_DOWNSCALE = 2  # COLMAP's cameras at N3DV's full frames (2704x2028)
CAP_POINTS = 20_000  # the sparse cloud: that many of a frame's centres
CAP_SCENE = "capture"
CAP_WORKERS = 5  # subsample's pool (the reference's mp.Pool(5))
CAP_F0_ITERS = 300  # build_frame0's 6000 + 1000, cut for time (depth only)
CAP_F0_FINETUNE = 50
TOL_CAMERAS_REL = 1e-6
PANOPTIC_CAMS = 4
PANOPTIC_WH = (1920, 1080)
PANOPTIC_K = ((1395.2, 0.0, 955.3), (0.0, 1393.9, 541.7), (0.0, 0.0, 1.0))
PANOPTIC_DIST = (-0.225, 0.19, 0.0004, -0.0002, -0.07)
GRAFT_RANKS = 2
GRAFT_LINES = (
    r"dryrun_multichip OK: mesh=\{'data': 1, 'tile': 2\} "
    r"loss=(?P<loss>\S+) psnr=(?P<psnr>\S+)",
    r"dryrun_multichip pallas-sharded OK: images \(2, \d+, 3, 32, 32\)",
    r"dryrun_multichip sharded-refine OK: mesh=\{'data': 1, 'tile': 2\}",
    r"dryrun_multichip frame0-sweep OK: 2 frames over "
    r"mesh=\{'data': 2, 'tile': 1\}")

STUB_COLMAP = r"""#!{python}
# a stand-in for colmap: records its arguments, writes the three model
# files where point_triangulator is told to, exits 0
import os, sys
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\n")
if "--output_path" in sys.argv:
    out = sys.argv[sys.argv.index("--output_path") + 1]
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(out, name), "wb") as f:
            f.write(name.encode())
"""


def capture_cameras():
    """The stream's 14-view rig (``data/synthetic.make_cameras`` at
    1014×1352), moved to F0_CENTER with the scene: cameras.json
    records."""
    from igs_tpu_torch.data.synthetic import make_cameras as records

    cams = records(N_CAMS, height=OUT_HW[0], width=OUT_HW[1])
    for c in cams:
        c["position"] = (np.float32(c["position"]) + F0_CENTER).tolist()
    return cams


def write_colmap_sparse(sparse, cams, xyz, rgb):
    """COLMAP's binary model of one frame: one PINHOLE camera at
    CAP_DOWNSCALE times OUT_HW and the records' focal lengths, an image a
    record
    (the world-to-camera pose as COLMAP's qvec and tvec, no 2-D points)
    and the points with a track of one."""
    import os
    import struct

    from igs_tpu_torch.data.colmap_db import rotmat2qvec

    os.makedirs(sparse, exist_ok=True)
    s = CAP_DOWNSCALE
    w, h = s * OUT_HW[1], s * OUT_HW[0]
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 1, w, h)
                + struct.pack("<4d", s * cams[0]["fx"], s * cams[0]["fy"],
                              w / 2, h / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, c in enumerate(cams):
            c2w = np.eye(4)
            c2w[:3, :3] = np.array(c["rotation"], np.float64)
            c2w[:3, 3] = np.array(c["position"], np.float64)
            w2c = np.linalg.inv(c2w)
            f.write(struct.pack("<i", i + 1)
                    + struct.pack("<4d", *rotmat2qvec(w2c[:3, :3]))
                    + struct.pack("<3d", *w2c[:3, 3]) + struct.pack("<i", 1)
                    + (c["img_name"] + ".png").encode() + b"\0"
                    + struct.pack("<Q", 0))
    rec = np.zeros(len(xyz), np.dtype([
        ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("error", "<f8"),
        ("track", "<u8"), ("image", "<i4"), ("point2d", "<i4")]))
    rec["id"] = np.arange(len(xyz))
    rec["xyz"], rec["rgb"], rec["track"] = xyz, rgb, 1
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)) + rec.tobytes())


def write_capture(dev, root):
    """(a) CAP_FRAMES frames of the stream's recipe (N_GAUSSIANS, no
    static shell, moved to F0_CENTER): every view rendered through the
    packed forward at OUT_HW into ``colmap_<f>/images/`` (``images_r2``
    links to it: the n3d layout the stream reads), and COLMAP's
    ``sparse/0``. Returns the cameras and the seconds it took."""
    import os
    from multiprocessing.pool import ThreadPool

    import torch

    from igs_tpu_torch.builders import build_raster_settings
    from igs_tpu_torch.core.camera import Camera
    from igs_tpu_torch.core.gaussians import Gaussians
    from igs_tpu_torch.core.sh import SH_C0
    from igs_tpu_torch.data.images import write_png
    from igs_tpu_torch.ops.rasterize import rasterize

    t0 = time.perf_counter()
    cams = capture_cameras()
    settings = build_raster_settings(*OUT_HW, max_pairs=1 << 23)._replace(
        outputs="color")
    rng = np.random.RandomState(5)
    pool = ThreadPool(8)  # zlib releases the interpreter lock
    writes = []
    for f in range(CAP_FRAMES):
        xyz, opacity, rot, scaling, shs = scene_gaussians(
            0.4 * f, N_GAUSSIANS, static_frac=STATIC_FRAC)
        xyz = xyz + F0_CENTER
        g = Gaussians.create(xyz, opacity, rot, scaling, shs, device=dev)
        frame = os.path.join(root, CAP_SCENE, f"colmap_{f}")
        os.makedirs(os.path.join(frame, "images"))
        os.symlink("images", os.path.join(frame, "images_r2"))
        for c in cams:
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = np.array(c["rotation"])
            c2w[:3, 3] = np.array(c["position"])
            cam = Camera.from_c2w(c2w, (FOV, FOV), OUT_HW, device=dev)
            with torch.no_grad():
                out = rasterize(g.get_xyz, g.get_opacity, g.get_scaling,
                                g.get_rotation, cam, shs=g.shs, valid=g.valid,
                                settings=settings)
            if int(out["overflow_tiles"]):
                raise RuntimeError("capture render overflowed its budget")
            u8 = (torch.clamp(out["color"], 0, 1).permute(1, 2, 0) * 255).to(
                torch.uint8).cpu().numpy()
            writes.append(pool.apply_async(write_png, (os.path.join(
                frame, "images", c["img_name"] + ".png"), u8)))
        sel = rng.choice(N_GAUSSIANS, CAP_POINTS, replace=False)
        rgb = np.clip(255 * (0.5 + SH_C0 * shs[sel, 0]), 0, 255)
        write_colmap_sparse(os.path.join(frame, "sparse", "0"), cams,
                            xyz[sel].astype(np.float64), rgb.astype(np.uint8))
    for w in writes:
        w.get()
    pool.close()
    pool.join()
    return cams, time.perf_counter() - t0


def prep(*args):
    """``python -m igs_tpu_torch.prepare_data`` with ``args`` from the
    checkout's root: (its stdout, seconds); fails on a non-zero exit."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "igs_tpu_torch.prepare_data", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=MEASURE_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"prepare_data {args[0]} exited "
                           f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    return proc.stdout.strip(), time.perf_counter() - t0


def check_cameras_json(path, cams):
    """The prepared cameras.json against the scene's own table."""
    with open(path) as f:
        got = json.load(f)
    worst = 0.0
    if [c["img_name"] for c in got] != [c["img_name"] for c in cams]:
        raise RuntimeError(f"{path}: other images than the scene's")
    for g, c in zip(got, cams):
        if (g["width"], g["height"]) != (c["width"], c["height"]):
            raise RuntimeError(f"{path}: size {g['width']}x{g['height']}")
        for k in ("position", "rotation", "fx", "fy"):
            a, b = np.asarray(g[k], np.float64), np.asarray(c[k], np.float64)
            worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    if worst > TOL_CAMERAS_REL:
        raise RuntimeError(f"{path}: {worst:.3g} relative off the scene's "
                           f"cameras (tolerance {TOL_CAMERAS_REL})")
    return worst


def prepare_capture(root, cams):
    """(b) the data preparation as a user runs it: ``cameras --downscale
    CAP_DOWNSCALE``, ``points`` and ``subsample --size IN_RES`` a frame,
    ``aabb`` on frame 0 and ``pairs``; each timed."""
    import os

    scene = os.path.join(root, CAP_SCENE)
    times = {"cameras": 0.0, "points": 0.0, "subsample": 0.0}
    worst = 0.0
    n_images = 0
    for f in range(CAP_FRAMES):
        frame = os.path.join(scene, f"colmap_{f}")
        sparse = os.path.join(frame, "sparse", "0")
        out, sec = prep("cameras", "--sparse", sparse, "--out",
                        os.path.join(frame, "cameras.json"),
                        "--downscale", str(CAP_DOWNSCALE))
        times["cameras"] += sec
        worst = max(worst, check_cameras_json(
            os.path.join(frame, "cameras.json"), cams))
        out, sec = prep("points", "--sparse", sparse, "--out",
                        os.path.join(frame, "points3D.npz"))
        times["points"] += sec
        out, sec = prep("subsample", "--src", os.path.join(frame, "images"),
                        "--dst", os.path.join(frame, "images_512"),
                        "--size", str(IN_RES), "--workers", str(CAP_WORKERS))
        times["subsample"] += sec
        n_images += len(cams)
        if out != f"resized {len(cams)} images → " + os.path.join(
                frame, "images_512"):
            raise RuntimeError(f"subsample printed {out!r}")
    bbox, times["aabb"] = prep(
        "aabb", "--sparse", os.path.join(scene, "colmap_0", "sparse", "0"),
        "--scene-name", CAP_SCENE, "--out", os.path.join(root, "bbox.json"))
    pairs, times["pairs"] = prep(
        "pairs", "--scene-name", CAP_SCENE, "--frames", str(CAP_FRAMES),
        "--interval", str(INTERVAL), "--out",
        os.path.join(root, "pairs.json"))
    with open(os.path.join(scene, "colmap_0", "points3D.npz"), "rb") as f:
        pts = np.load(f)
        if pts["xyz"].shape != (CAP_POINTS, 3):
            raise RuntimeError(f"points3D.npz holds {pts['xyz'].shape}")
    log(f"capture (b) prepare_data: {json.dumps(times)} s in all "
        f"({CAP_FRAMES} frames); subsample {n_images / times['subsample']:.2f}"
        f" images/s with {CAP_WORKERS} workers; cameras.json against the "
        f"scene's table {worst:.3g} relative; {bbox}; {pairs}")
    return times, n_images / times["subsample"], worst


def panoptic_check(workspace):
    """(c) ``prepare_data panoptic`` on a Panoptic-shaped frame (PANOPTIC_CAMS
    hd cameras at 1920×1080, five distortion coefficients) with a stub
    ``colmap`` on PATH; the undistortion timed per image in this
    process with the same calls."""
    import glob
    import os
    import sqlite3
    import stat

    from igs_tpu_torch.data.images import png_size, write_png
    from igs_tpu_torch.data.undistort import (
        imread_bgr, init_undistort_rectify_map, optimal_new_camera_matrix,
        remap_linear)

    src = os.path.join(workspace, "panoptic")
    inp = os.path.join(src, "colmap_0", "input")
    os.makedirs(inp)
    rng = np.random.RandomState(6)
    cams = []
    for i in range(PANOPTIC_CAMS):
        u, _, vt = np.linalg.svd(rng.normal(size=(3, 3)))
        r = u @ vt * np.sign(np.linalg.det(u @ vt))
        k = np.array(PANOPTIC_K) + np.diag([i, -i, 0.0])
        cams.append({"name": f"00_{i:02d}", "type": "hd",
                     "resolution": list(PANOPTIC_WH), "K": k.tolist(),
                     "distCoef": list(PANOPTIC_DIST), "R": r.tolist(),
                     "t": rng.normal(0, 100, (3, 1)).tolist()})
        yy, xx = np.mgrid[:PANOPTIC_WH[1], :PANOPTIC_WH[0]]
        img = np.stack([(xx + 37 * i) % 256, (yy * 3) % 256,
                        (xx + yy) % 256], -1).astype(np.uint8)
        write_png(os.path.join(inp, f"hd_{cams[-1]['name']}.png"), img)
    with open(os.path.join(src, "calibration_capture.json"), "w") as f:
        json.dump({"cameras": cams}, f)
    stubs = os.path.join(workspace, "stubs")
    os.makedirs(stubs)
    stub_log = os.path.join(workspace, "colmap_calls.txt")
    stub = os.path.join(stubs, "colmap")
    with open(stub, "w") as f:
        f.write(STUB_COLMAP.format(python=sys.executable, log=stub_log))
    os.chmod(stub, os.stat(stub).st_mode | stat.S_IEXEC)
    log(f"capture (c) panoptic: a stub colmap at {stub} (records its "
        "arguments, exits 0) first on PATH")
    env = dict(os.environ, PATH=stubs + os.pathsep + os.environ["PATH"])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "igs_tpu_torch.prepare_data", "panoptic",
         "--src", src, "--start", "0", "--end", "1"], env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=MEASURE_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"panoptic exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    proj = os.path.join(src, "colmap_0")
    images = sorted(glob.glob(os.path.join(proj, "images", "*.png")))
    sizes = {png_size(p) for p in images}
    calls = [line.split()[0] for line in open(stub_log).read().splitlines()]
    conn = sqlite3.connect(os.path.join(proj, "input.db"))
    cam_rows = conn.execute("SELECT model, width, height FROM cameras"
                            ).fetchall()
    img_rows = conn.execute("SELECT name FROM images ORDER BY image_id"
                            ).fetchall()
    conn.close()
    manual = {n: open(os.path.join(proj, "manual", n)).read()
              for n in ("cameras.txt", "images.txt", "points3D.txt")}
    names = [f"hd_{c['name']}.png" for c in cams]
    ok = (len(images) == PANOPTIC_CAMS and sizes == {PANOPTIC_WH}
          and calls == ["feature_extractor", "exhaustive_matcher",
                        "point_triangulator"]
          and cam_rows == [(1,) + PANOPTIC_WH] * PANOPTIC_CAMS
          and [r[0] for r in img_rows] == names
          and len(manual["cameras.txt"].splitlines()) == PANOPTIC_CAMS
          and manual["images.txt"].count(".png") == PANOPTIC_CAMS
          and manual["points3D.txt"] == ""
          and sorted(os.listdir(os.path.join(proj, "sparse", "0"))) == [
              "cameras.bin", "images.bin", "points3D.bin"])
    # the undistortion of every view, timed here with the CLI's calls
    ms = []
    for c in cams:
        path = os.path.join(proj, "input_distorted", f"hd_{c['name']}.png")
        t1 = time.perf_counter()
        img = imread_bgr(path)
        k, d = np.array(c["K"]), np.array(c["distCoef"])
        new_k, roi = optimal_new_camera_matrix(k, d, PANOPTIC_WH, alpha=0)
        m1, m2 = init_undistort_rectify_map(k, d, None, new_k, PANOPTIC_WH)
        remap_linear(img, m1, m2)
        ms.append(1e3 * (time.perf_counter() - t1))
    log(f"capture (c) panoptic: exit 0 in {wall:.2f} s; {len(images)} "
        f"undistorted PNGs {sorted(sizes)}; colmap calls {calls}; database "
        f"cameras {cam_rows}, images {[r[0] for r in img_rows]}; roi of the "
        f"last view {roi}; undistortion (read, K', maps, remap) ms per "
        f"1920x1080 image {[round(x, 1) for x in ms]}")
    if not ok:
        raise RuntimeError("panoptic's outputs are not what it was asked for")
    return wall, float(np.mean(ms))


def native_check(root, cams):
    """(d) the stream's first window batch (B candidates: the eval and
    input views at OUT_HW and 512²) through the host library and through
    the numpy codec: bit-equal, both timed."""
    import os

    from igs_tpu_torch.data import native
    from igs_tpu_torch.data.images import read_png

    scene = os.path.join(root, CAP_SCENE)
    names = [cams[v]["img_name"] + ".png" for v in (EVAL_VIEW,) + INPUT_VIEWS]
    groups = {
        "full": [os.path.join(scene, f"colmap_{f + 1}", "images_r2", n)
                 for f in range(B) for n in names],
        "512": [os.path.join(scene, f"colmap_{f}", "images_512", n)
                for f in range(B + 1) for n in names]}
    out = {}
    native.native_available()  # the library built before the clocks
    for key, paths in groups.items():
        t0 = time.perf_counter()
        numpy_px = np.stack([read_png(p) for p in paths]).astype(
            np.float32).transpose(0, 3, 1, 2) * np.float32(1 / 255)
        t1 = time.perf_counter()
        lib_px = native.load_images_nchw(paths, *numpy_px.shape[-2:])
        t2 = time.perf_counter()
        if not np.array_equal(lib_px, numpy_px):
            raise RuntimeError(f"the host library's decode of the {key} "
                               "PNGs differs from the numpy codec's")
        out[key] = {"images": len(paths), "shape": list(numpy_px.shape[1:]),
                    "native_ms": 1e3 * (t2 - t1), "numpy_ms": 1e3 * (t1 - t0)}
    log(f"capture (d) native loader: bit-equal to the numpy codec; "
        f"{json.dumps(out)}")
    return out


def capture_stream(dev, root, workspace):
    """(e) ``build_frame0`` (its CLI's ``main``, in this process so that
    its launches count) on the prepared ``colmap_0``, then
    ``infer_stream.run`` for one window and its key-frame refine on the
    prepared bbox.json, pairs and ``images_512/``."""
    import contextlib
    import os

    from igs_tpu_torch import build_frame0, infer_stream

    scene = os.path.join(root, CAP_SCENE)
    records = []
    train = build_frame0.train_one_frame

    def recorded(*args, **kw):
        records.append(train(*args, **kw))
        return records[-1]

    build_frame0.train_one_frame = recorded
    t0 = time.perf_counter()
    try:
        build_frame0.main(["--scene", scene, "--frames", "0", "--images",
                           "images", "--iterations", str(CAP_F0_ITERS),
                           "--finetune-iters", str(CAP_F0_FINETUNE),
                           "--device", str(dev)])
    finally:
        build_frame0.train_one_frame = train
    f0_wall = time.perf_counter() - t0
    (rec,) = records
    losses = rec["losses"]
    log(f"capture (e) build_frame0: {f0_wall:.2f} s, {CAP_F0_ITERS} + "
        f"{CAP_F0_FINETUNE} steps at {OUT_HW[0]}x{OUT_HW[1]} on "
        f"{N_CAMS} views (the CLI's 6000 + 1000 cut for time); live "
        f"{rec['n_init']} → {rec['n_after_train']} → {rec['n_final']}; "
        f"loss first 20 {np.mean(losses[:20]):.5f} last 20 "
        f"{np.mean(losses[-20:]):.5f}; overflow {rec['overflow']}; ms a step "
        f"{json.dumps(rec['ms_per_step'])}; seconds {json.dumps(rec['seconds'])}")
    if rec["overflow"] or not np.mean(losses[-20:]) < np.mean(losses[:20]):
        raise RuntimeError("the capture's frame-0 build overflowed or did "
                           "not lower its loss")
    it_name = f"{CAP_F0_ITERS}_compress"
    data = {"background_color": [0.0, 0.0, 0.0], "data_path": "pairs.json",
            "root_dir": root, "bbox_path": "bbox.json",
            "gs_mode": "3dgs_rade", "iter": it_name,
            "input_height": IN_RES, "input_width": IN_RES,
            "output_height": OUT_HW[0], "output_width": OUT_HW[1],
            "scene_type": "n3d", "depth_id_offset": 0, "up_sample": True,
            "max_sh_degree": 3, "start_gs_path": rec["export"]["ply"]}
    ws = os.path.join(workspace, "capture_stream")
    sections = {"system": SYSTEM, "opt": dict(OPT, workspace=ws),
                "data": {"data_cls": "igs.data.infer_data.N3dDataset",
                         "data": data}}
    pipes = []

    class Captured(infer_stream.StreamingPipeline):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            pipes.append(self)

    inner = infer_stream.StreamingPipeline
    infer_stream.StreamingPipeline = Captured
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            res = infer_stream.run(sections, max_batches=1, device=dev)
    finally:
        infer_stream.StreamingPipeline = inner
    wall = time.perf_counter() - t0
    with open(os.path.join(ws, "results.json")) as f:
        written = json.load(f)
    (key,) = pipes[0].refine_log
    first5, last5 = np.mean(key["losses"][:5]), np.mean(key["losses"][-5:])
    log(f"capture (e) infer_stream: {wall:.2f} s for one window and its "
        f"key-frame refine; psnr {json.dumps(res['psnr'])}; sec/frame "
        f"{res['sec/frame']:.4f}; refine loss first 5 {first5:.5f} last 5 "
        f"{last5:.5f}; overflow_events {res['overflow_events']}")
    if not (set(RESULTS_KEYS) <= set(written) and len(res["psnr"]) == B
            and all(math.isfinite(v) for v in res["psnr"].values())
            and not res["overflow_events"] and last5 < first5):
        raise RuntimeError("the stream on the prepared capture failed its "
                           "checks")
    return f0_wall, wall


def graft_check(dev, counters):
    """(f) ``graft_entry.entry()``'s forward on the card, then the dry
    run on GRAFT_RANKS gloo ranks sharing the card: its four lines.
    Returns the launches: this process's and the ranks'."""
    import torch

    from igs_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device=dev)
    fn(*args)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images, depth = fn(*args)
    torch.cuda.synchronize()
    entry_ms = 1e3 * (time.perf_counter() - t0)
    if not (images.shape == (1, 1, 3, 32, 32) and depth.shape == (1, 1, 32, 32)
            and bool(torch.isfinite(images).all())
            and bool(torch.isfinite(depth).all())):
        raise RuntimeError("graft entry(): bad outputs")
    launches = counters.read()
    t0 = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    rec = graft_entry.run_dryrun(GRAFT_RANKS, device=str(dev),
                                 backend="gloo", share_card=on_card,
                                 timeout_s=PAR_JOIN_S)
    wall = time.perf_counter() - t0
    for line in rec["lines"]:
        log(f"capture (f) {line}")
    ok = len(rec["lines"]) == len(GRAFT_LINES) and all(
        re.fullmatch(pat, line) for pat, line in zip(GRAFT_LINES,
                                                     rec["lines"]))
    m = re.fullmatch(GRAFT_LINES[0], rec["lines"][0]) if rec["lines"] else None
    if not (ok and m and math.isfinite(float(m["loss"]))):
        raise RuntimeError(f"dryrun_multichip's lines: {rec['lines']}")
    for ranked in rec["launches"]:
        _add(launches, ranked)
    log(f"capture (f) graft: entry() forward {entry_ms:.2f} ms (host clock, "
        f"synchronised); dryrun_multichip({GRAFT_RANKS}) {wall:.2f} s on "
        f"gloo ranks sharing the card; launches {json.dumps(launches)}")
    return launches


def capture_phase(dev, workspace, counters):
    """Phase 17: a capture through ``prepare_data`` to ``build_frame0``
    and ``infer_stream`` (the "capture" path: counters reset before (b),
    read after (e)), then the graft entry (the "graft" path)."""
    import os

    t_phase = time.perf_counter()
    root = os.path.join(workspace, "capture_root")
    cams, sec = write_capture(dev, root)
    log(f"capture (a): {CAP_FRAMES} frames x {N_CAMS} views at "
        f"{OUT_HW[0]}x{OUT_HW[1]} through the packed forward, {N_GAUSSIANS} "
        f"Gaussians, COLMAP sparse/0 a frame ({CAP_DOWNSCALE * OUT_HW[1]}x"
        f"{CAP_DOWNSCALE * OUT_HW[0]} PINHOLE, {CAP_POINTS} points), "
        f"{sec:.2f} s")
    counters.reset()
    t0 = time.perf_counter()
    prepare_capture(root, cams)
    panoptic_check(workspace)
    native_check(root, cams)
    capture_stream(dev, root, workspace)
    capture = counters.read()
    log(f"capture: prepare_data to the stream {time.perf_counter() - t0:.2f}"
        f" s wall; launches {json.dumps(capture)}")
    for k in ("blend_fwd_packed/color", "blend_bwd_packed/color",
              "segmented_scan", "count_contributions_packed"):
        if capture.get(k, 0) == 0:
            raise RuntimeError(f"the capture path did not launch {k}")
    counters.reset()
    graft = graft_check(dev, counters)
    for k in ("blend_fwd_packed/color", "blend_bwd_packed/color",
              "segmented_scan"):
        if graft.get(k, 0) == 0:
            raise RuntimeError(f"the graft path did not launch {k}")
    log(f"capture: phase 17 {time.perf_counter() - t_phase:.1f} s")
    return capture, graft



# ---------------------------------------------------------------------------
# phase 18: the rasterizer and refine probes, and the image kinds
# ---------------------------------------------------------------------------

PROBE_RAST = ("--n", "20000", "--res", "256")
PROBE_TIMED = ("--K", "1", "--iters", "1")
PROBE_LOOP = ("--n", "20000", "--res", "256", "--steps", "4", "--views",
              "4", *PROBE_TIMED)
# the AGM-Net probes: the attention at 2048 tokens, the network at full
# width on 2 candidates of 128² inputs, 20 000 Gaussians, 2048 anchors
PROBE_ATTN = ("--shape", "1", "8", "2048", "64", "--K", "1", "--iters", "1")
PROBE_AGM = ("--n", "20000", "--anchors", "2048", "--res", "128", "--batch",
             "2", "--K", "1", "--iters", "1")
_PACKED = ("blend_fwd_packed/color", "blend_bwd_packed/color",
           "segmented_scan")
# (probe, its arguments at the phase's reduced shape, the kernels its run
# must launch)
PROBE_RUNS = (
    ("packed_test", PROBE_RAST + ("--what", "bwd"), _PACKED),
    ("precision_check", PROBE_RAST + ("--max-per-tile", "4096"),
     _PACKED + ("blend_fwd_packed/full", "blend_bwd_packed/full",
                "blend_fwd_win/color", "blend_bwd_win/color",
                "blend_fwd_win/full", "blend_bwd_win/full")),
    ("bench_blend", PROBE_RAST + PROBE_TIMED + ("--maxpt", "1024"),
     _PACKED + ("blend_fwd_win/color", "blend_bwd_win/color")),
    ("profile_raster", PROBE_RAST + PROBE_TIMED, _PACKED),
    ("bench_parts", PROBE_RAST + PROBE_TIMED + (
        "--attn", "5", "8", "2048", "64", "--attn-K", "1"),
     ("blend_fwd_win/color", "blend_bwd_win/color", "attention_fwd")),
    ("bench_binning", PROBE_RAST + PROBE_TIMED, ()),
    ("bench_binning2", PROBE_RAST + PROBE_TIMED, ()),
    ("bench_binning3", PROBE_RAST + PROBE_TIMED, ("segmented_scan",)),
    ("profile_bin_ablate", PROBE_LOOP, ("blend_fwd_packed/color",)),
    ("bench_expand", ("--n", "20000", *PROBE_TIMED), ()),
    ("bench_segred", ("--n", "20000", *PROBE_TIMED), ("segmented_scan",)),
    ("bench_segred_ab", PROBE_RAST + PROBE_TIMED,
     _PACKED + ("blend_fwd_packed/full", "blend_bwd_packed/full")),
    ("bench_segred_loop", PROBE_LOOP, _PACKED),
    ("bench_refine_loop", PROBE_LOOP, _PACKED),
    ("profile_refine_ablate", PROBE_LOOP + ("--rebin-every", "2"), _PACKED),
    ("sweep", ("--only", "refine_loop", "--args", "refine_loop",
               " ".join(PROBE_LOOP)), ()),
    ("bench_attn", PROBE_ATTN, ("attention_fwd", "attention_bwd")),
    ("bench_attn2", PROBE_ATTN, ("attention_fwd",)),
    ("bench_swin", ("--shape", "4", "128", "64", "64", "--layers", "2",
                    *PROBE_TIMED), ("attention_fwd",)),
    ("bench_agm_bf16", PROBE_AGM, ("attention_fwd", "blend_fwd_packed/color",
                                   "blend_fwd_packed/color_depth")),
    ("profile_agm_diff", PROBE_AGM, ("attention_fwd",
                                     "blend_fwd_packed/color")),
    ("bench_agm_plucker", PROBE_AGM, ("attention_fwd",
                                      "blend_fwd_packed/color")),
)
PROBE_BUDGET_S = 60  # the phase's probes together, logged against it
PROG_HW = (1014, 1352)  # the progressive decode's timing frame


def progressive_grey_jpeg(img, quality=90):
    """(H, W) uint8 → (a progressive JPEG of it: the DC first at Al 1,
    the DC refine, AC bands 1–5 and 6–63 at Al 0, the standard tables; a
    baseline JPEG of the same coefficients; the pixels both must decode
    to, by libjpeg's islow IDCT of the coefficients, from numpy)."""
    import struct

    from igs_tpu_torch.data import jpeg

    h, w = img.shape
    qt, _ = jpeg.quant_tables(quality)
    bh, bw = -(-h // 8), -(-w // 8)
    plane = np.pad(img, ((0, 8 * bh - h), (0, 8 * bw - w)), mode="edge")
    zz = jpeg._quantise(jpeg._blocks(plane), qt).reshape(-1, 64)
    nat = np.zeros_like(zz)
    nat[:, jpeg.ZIGZAG] = zz
    want = jpeg.idct_islow(nat.reshape(bh, bw, 64), qt).transpose(
        0, 2, 1, 3).reshape(8 * bh, 8 * bw)[:h, :w]
    dc_code, dc_len = jpeg.huffman_codes(jpeg.HUFF_DC_LUMA)
    ac_code, ac_len = jpeg.huffman_codes(jpeg.HUFF_AC_LUMA)

    def scan(items):
        bits = "".join(format(v, f"0{n}b") for v, n in items if n)
        bits += "1" * (-len(bits) % 8)
        data = int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""
        return data.replace(b"\xff", b"\xff\x00")

    def sym(code, length, s):
        return int(code[s]), int(length[s])

    def extra(v, s):
        return (v if v >= 0 else v + (1 << s) - 1), s

    dc_first, pred = [], 0
    for v in (zz[:, 0] >> 1).tolist():
        d, pred = v - pred, v
        s = abs(d).bit_length()
        dc_first += [sym(dc_code, dc_len, s), extra(d, s)]
    dc_refine = [(v & 1, 1) for v in zz[:, 0].tolist()]

    def band(ss, se):
        items = []
        for row in zz[:, ss:se + 1].tolist():
            run = 0
            for v in row:
                if not v:
                    run += 1
                    continue
                while run > 15:
                    items.append(sym(ac_code, ac_len, 0xF0))
                    run -= 16
                s = abs(v).bit_length()
                items += [sym(ac_code, ac_len, run << 4 | s), extra(v, s)]
                run = 0
            if run:
                items.append(sym(ac_code, ac_len, 0x00))  # EOB
        return items

    def seg(marker, body):
        return struct.pack(">HH", 0xFF00 | marker, len(body) + 2) + body

    def sos(ss, se, ah, al):
        return seg(0xDA, bytes([1, 1, 0x00, ss, se, ah << 4 | al]))

    head = (b"\xff\xd8" + seg(0xDB, bytes([0]) + bytes(qt[jpeg.ZIGZAG]
                                                      .tolist())))
    tables = (seg(0xC4, bytes([0x00]) + bytes(jpeg.HUFF_DC_LUMA[0])
                  + bytes(jpeg.HUFF_DC_LUMA[1]))
              + seg(0xC4, bytes([0x10]) + bytes(jpeg.HUFF_AC_LUMA[0])
                    + bytes(jpeg.HUFF_AC_LUMA[1])))
    frame = struct.pack(">BHHB", 8, h, w, 1) + bytes([1, 0x11, 0])
    prog = (head + seg(0xC2, frame) + tables
            + sos(0, 0, 0, 1) + scan(dc_first)
            + sos(0, 0, 1, 0) + scan(dc_refine)
            + sos(1, 5, 0, 0) + scan(band(1, 5))
            + sos(6, 63, 0, 0) + scan(band(6, 63)) + b"\xff\xd9")
    base = (head + seg(0xC0, frame) + tables + sos(0, 63, 0, 0)
            + jpeg._entropy_code(zz, np.zeros(len(zz), np.int64))
            + b"\xff\xd9")
    return prog, base, want


def palette_png(indices, palette):
    """A 4-bit palette PNG of (H, W) indices, from numpy and zlib."""
    import struct
    import zlib

    h, w = indices.shape
    px = np.concatenate([indices, np.zeros((h, w % 2), indices.dtype)],
                        axis=1).astype(np.uint8)
    rows = (px[:, 0::2] << 4 | px[:, 1::2]).astype(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 4, 3, 0, 0, 0))
            + chunk(b"PLTE", palette.astype(np.uint8).tobytes())
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


def image_kinds_check(workspace):
    """A progressive JPEG and a palette PNG (with an 8-bit RGB PNG in the
    same batch, which then goes whole through the PIL-pixel route, as the
    JAX loader's fallback) through the datasets' batch loader, against the
    pixels the smoke computes from numpy; then a 1014×1352 progressive
    decode timed beside the baseline decode of the same coefficients."""
    import os

    from igs_tpu_torch.data.images import load_images_nchw, write_png
    from igs_tpu_torch.data.jpeg import decode_jpeg

    rng = np.random.RandomState(18)
    d = os.path.join(workspace, "image_kinds")
    os.makedirs(d, exist_ok=True)
    h, w = 37, 53
    yy, xx = np.mgrid[0:h, 0:w]
    grey = np.clip(4 * xx + 2 * yy + rng.randint(-30, 31, (h, w)), 0,
                   255).astype(np.uint8)
    prog, base, want = progressive_grey_jpeg(grey)
    paths = {"prog": os.path.join(d, "prog.jpg"),
             "pal": os.path.join(d, "pal.png"),
             "rgb": os.path.join(d, "rgb.png")}
    with open(paths["prog"], "wb") as f:
        f.write(prog)
    idx = rng.randint(0, 16, (h, w))
    with open(paths["pal"], "wb") as f:
        f.write(palette_png(idx, rng.randint(0, 256, (16, 3))))
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    write_png(paths["rgb"], rgb)
    scale = np.float32(1 / 255)

    def nchw(px):
        px = px if px.ndim == 3 else np.repeat(px[:, :, None], 3, axis=2)
        return px.astype(np.float32).transpose(2, 0, 1) * scale

    if not (np.array_equal(decode_jpeg(prog), want)
            and np.array_equal(decode_jpeg(base), want)):
        raise RuntimeError("the progressive or baseline JPEG does not "
                           "decode to its coefficients' pixels")
    got = load_images_nchw([paths["prog"]], h, w)
    batch = load_images_nchw([paths["rgb"], paths["pal"]], h, w)
    # the palette PNG's pixels are its indices (PIL's mode P), as JAX reads
    if not (np.array_equal(got[0], nchw(want))
            and np.array_equal(batch[0], nchw(rgb))
            and np.array_equal(batch[1], nchw(idx.astype(np.uint8)))):
        raise RuntimeError("the batch loader's progressive JPEG or palette "
                           "PNG pixels differ from the expected ones")
    frame = np.clip(np.mgrid[0:PROG_HW[0], 0:PROG_HW[1]].sum(0) % 256
                    + rng.randint(-40, 41, PROG_HW), 0, 255).astype(np.uint8)
    prog, base, want = progressive_grey_jpeg(frame, 95)
    ms = {}
    for name, data in (("baseline", base), ("progressive", prog)):
        t0 = time.perf_counter()
        ok = np.array_equal(decode_jpeg(data), want)
        ms[name] = 1e3 * (time.perf_counter() - t0)
        if not ok:
            raise RuntimeError(f"the {PROG_HW} {name} JPEG decodes wrong")
    log(f"images: a progressive JPEG (DC first and refine, two AC bands) "
        f"and a 4-bit palette PNG in an RGB batch through the batch loader"
        f", equal to the numpy pixels; {PROG_HW[0]}x{PROG_HW[1]} grey q95 "
        f"decode on the host: baseline {ms['baseline']:.1f} ms, "
        f"progressive {ms['progressive']:.1f} ms ({len(base)} and "
        f"{len(prog)} bytes)")
    return ms


def probe_phase(workspace, counters):
    """Phase 18: each of the 22 rasterizer, refine and AGM-Net probes of
    ``igs_tpu_torch/tools/`` through its ``main`` in this process at a
    reduced shape (the sweep's program a subprocess), counters reset
    just before each and read just after: each must exit 0, write its
    JSON and launch its kernels (the "probes" path); then the image
    kinds."""
    import importlib
    import os

    t_phase = time.perf_counter()
    total = {}
    for name, args, want in PROBE_RUNS:
        module = importlib.import_module(f"igs_tpu_torch.tools.{name}")
        out = os.path.join(workspace, "probes", f"{name}.json")
        counters.reset()
        t0 = time.perf_counter()
        rc = module.main([*args, "--out", out])
        launches = counters.read()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"probe {name} exited {rc}")
        with open(out) as f:
            doc = json.load(f)
        if name == "sweep":
            child = doc["results"]["refine_loop"]
            if child["rc"] != 0 or not child["launches"].get(
                    "blend_fwd_packed/color"):
                raise RuntimeError(f"the sweep's refine loop failed or "
                                   f"launched no kernel: {child}")
        missing = [k for k in want if not launches.get(k)]
        if missing:
            raise RuntimeError(f"probe {name} did not launch {missing}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(f"probe {name}: {wall:.2f} s, launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}, "
            f"results {json.dumps(doc['results'], default=float)[:600]}")
    probes_s = time.perf_counter() - t_phase
    log(f"probes: {len(PROBE_RUNS)} in {probes_s:.1f} s (budget "
        f"{PROBE_BUDGET_S} s)")
    image_kinds_check(workspace)
    log(f"probes: phase 18 {time.perf_counter() - t_phase:.1f} s")
    return total

if __name__ == "__main__":
    sys.exit(main())
