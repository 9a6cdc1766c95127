"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. card and settings: name and power limit, TF32 off for matmuls and
     cuDNN convolutions (the port runs float32 throughout);
  2. build every kernel of the main path from ``igs_tpu_torch/csrc``
     (blend_fwd.cu, blend_bwd.cu, segscan.cu: one nvcc per source, started
     together), with ptxas registers and spills per source;
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
     (the n3d view table) at 1014×1352;
  4. kernel vs plain, forward: the packed blend kernel against its plain
     PyTorch version, color / color_depth / full, at the eval shape (64×85
     tiles) and the 128² depth-carry shape (four views in one launch);
  5. kernel vs plain, backward: the blend backward kernel against its
     plain version on the same forward and a seeded cotangent, all modes
     and both shapes; the segmented scan against its plain version on the
     eval view's expansion ids and on 2^21 seeded rows of synthetic runs,
     16 and 32 lanes, with ``index_add_`` as the library yardstick; both
     kernels launched twice for bit equality; the bounds count the
     pixel-pairs the forward accepted;
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
  9. one AGM-Net forward timed by top-level module and one under
     ``torch.profiler``; one refine step timed by stage (CUDA events) and
     one under ``torch.profiler``.
The line before the card line is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
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
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12  # outside the tensor cores
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


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# the synthetic stream (numpy; mirrors igs_tpu/data/synthetic.py:28-80)
# ---------------------------------------------------------------------------


def make_cameras(n_cams=N_CAMS, radius=4.0):
    c2ws = []
    for i in range(n_cams):
        theta = (i / n_cams - 0.5) * 1.6
        pos = np.array([radius * np.sin(theta), 0.15 * np.sin(3 * theta),
                        -radius * np.cos(theta)], np.float32)
        z = -pos / np.linalg.norm(pos)
        x = np.cross(np.float32([0.0, -1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.stack([x, y, z], 1)
        c2w[:3, 3] = pos
        c2ws.append(c2w)
    return np.stack(c2ws)


def scene_gaussians(t, n, seed=0, motion_scale=0.15,
                    static_frac=0.3, opacity_range=(-0.5, 2.0),
                    scale_range=(-5.0, -3.8)):
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


def local_ray_directions(h, w, fovx, fovy):
    fx, fy = w / (2 * np.tan(fovx / 2)), h / (2 * np.tan(fovy / 2))
    i, j = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                       np.arange(h, dtype=np.float32) + 0.5, indexing="xy")
    d = np.stack([(i - w / 2) / fx, (j - h / 2) / fy, np.ones_like(i)], -1)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def world_rays(directions, c2ws):
    dirs = np.einsum("vij,hwj->vhwi", c2ws[:, :3, :3], directions)
    ori = np.broadcast_to(c2ws[:, None, None, :3, 3], dirs.shape)
    return np.concatenate([ori, dirs], axis=-1).astype(np.float32)


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
    walked = float(kern[..., nc].sum())  # pairs up to each last contributor
    accepted = accepted_pixel_pairs(feats_t, start, count, gx, gy, kern, mode)
    nbytes = 4 * (live * LANES_READ[mode] + kern.numel())
    ops = (FLOPS_FWD_CANDIDATE * (walked - accepted)
           + FLOPS_FWD_ACCEPTED[mode] * accepted)
    bound_ms = 1e3 * max(nbytes / H100_BYTES_PER_S, ops / H100_FP32_FLOPS)
    res = {
        "case": name, "mode": mode, "tiles": int(count.numel()),
        "pairs": live, "walked_pixel_pairs": walked,
        "accepted_pixel_pairs": accepted, "flips": int(flip.sum()),
        "pixels": pixels,
        "pixels_over_tol": over,
        "max_abs_err": max(errs.values()), "err_by_lane": errs,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if nbytes / H100_BYTES_PER_S
        >= ops / H100_FP32_FLOPS else "operations",
        "bytes": nbytes, "flops": ops,
    }
    log(f"kernel-vs-plain {json.dumps(res)}")
    res["ok"] = (res["flips"] <= TOL_FLIP_FRAC * pixels
                 and res["max_abs_err"] <= TOL_ABS)
    return res


def accepted_pixel_pairs(feats_t, start, count, gx, gy, raw, mode,
                         tile_block=256, chunk=128):
    """The pixel-pairs the forward accepted, from its raw block: pair j of a
    tile counts for pixel p when j < n_contrib(p), power <= 0 and alpha >=
    1/255 (the plain version's candidate test)."""
    import torch

    from igs_tpu_torch.ops.blend import MIN_ALPHA, P, TILE_X, TILE_Y

    dev = feats_t.device
    nc = raw[..., 5 if mode == "color" else 16].long()
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
    walked = float(nc.sum())  # pixel-pairs up to each last contributor
    accepted = accepted_pixel_pairs(feats_t, start, count, gx, gy, raw, mode)
    nbytes = 4 * (2 * walked_pairs * lanes + 2 * raw.numel())
    ops = (FLOPS_BWD_CANDIDATE * (walked - accepted)
           + FLOPS_BWD_ACCEPTED[mode] * accepted)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_FP32_FLOPS
    res = {
        "case": name, "mode": mode, "tiles": int(count.numel()),
        "walked_pairs": walked_pairs, "walked_pixel_pairs": walked,
        "accepted_pixel_pairs": accepted,
        "max_abs_err": max(errs.values()), "err_by_group": errs,
        "rel_err_by_group": rel, "bitwise_repeat": bool(torch.equal(
            kern, again)),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": ops,
    }
    log(f"backward-vs-plain {json.dumps(res)}")
    res["ok"] = res["bitwise_repeat"] and max(rel.values()) <= TOL_BWD_REL
    return res


def synthetic_scan_ids(seed, n=1 << 21):
    """Seeded expansion ids with runs of 1 to 5 000 rows, many spanning
    several 1 024-row blocks, and pad runs (id -1) between them."""
    rng = np.random.RandomState(seed)
    kind = rng.choice(3, size=n // 8, p=[0.7, 0.25, 0.05])
    lengths = np.where(kind == 0, rng.randint(1, 30, kind.size),
                       np.where(kind == 1, rng.randint(30, 1000, kind.size),
                                rng.randint(1000, 5000, kind.size)))
    lengths = lengths[:np.searchsorted(np.cumsum(lengths), n)]
    ids = np.where(rng.rand(lengths.size) < 0.1, -1, np.arange(lengths.size))
    out = np.repeat(ids, lengths)
    return np.concatenate([out, np.full(n - out.size, -1)]).astype(np.int32)


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

    from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
    from igs_tpu_torch.ops.projection import project
    from igs_tpu_torch.ops.segred import (
        segment_sum_sorted, segmented_scan_cuda, segmented_scan_plain)

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
        "vjp_vs_index_add_max_abs": vjp_err,
        "bitwise_repeat": repeat,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S, "bound_by": "bytes",
        "bytes": nbytes,
    }
    log(f"segscan-vs-plain {json.dumps(res)}")
    res["ok"] = (repeat and syn_repeat and max(rel, syn_rel) <= TOL_SCAN_REL
                 and vjp_err <= TOL_SCAN_REL * float(x.abs().sum(1).max()))
    return res


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
        from igs_tpu_torch.ops import blend, cuda_build, segred
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
        "torch.backends.cudnn.allow_tf32=False (float32 throughout)")

    # -- build -------------------------------------------------------------
    sources = ["blend_fwd.cu", "blend_bwd.cu", "segscan.cu"]
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

    # -- kernel vs plain, forward ------------------------------------------
    start_gs = g0.pad_to(MAX_NUM)
    eval_cam = Camera.from_c2w(c2ws[EVAL_VIEW], (FOV, FOV), OUT_HW,
                               device=dev).batched()
    depth_cams = Camera.stack([Camera.from_c2w(c2ws[v], (FOV, FOV),
                                               (128, 128), device=dev)
                               for v in INPUT_VIEWS])
    eval_budget = build_raster_settings(*OUT_HW).max_pairs
    shapes = (("eval 1014x1352", eval_cam, OUT_HW, eval_budget),
              ("depth-carry 4x128x128", depth_cams, (128, 128), 1 << 19))
    cases, bwd_cases = [], []
    for mode in ("color", "color_depth", "full"):
        for name, cam, hw, budget in shapes:
            inputs = packed_inputs(start_gs, cam, hw, mode, budget)
            cases.append(compare_kernel(name, *inputs, mode))
            bwd_cases.append(compare_backward(name, *inputs, mode))
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
    workspace = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg, refine_cfg = build_stream_configs(OPT)
    cfg = dataclasses.replace(cfg, anchor_size=ANCHORS, neighbor_k=8,
                              depth_view_res=128, save_images=False,
                              workspace=workspace)
    log(f"configs: {cfg}; {refine_cfg}")
    settings = build_raster_settings(*OUT_HW)
    pipe = StreamingPipeline(model, stream, cfg, refine_cfg, settings,
                             device=dev)
    counters = launch_counters(blend, segred)
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

    # -- profiles -------------------------------------------------------------
    profile_window(pipe, stream, torch)
    profile_refine_step(pipe, refine_args, blend, segred)

    # -- the kernels line ----------------------------------------------------
    by_case = {(c["case"], c["mode"]): c for c in cases}
    kernels = []
    for mode, case in (("color", "eval 1014x1352"),
                       ("color_depth", "depth-carry 4x128x128")):
        c = by_case[(case, mode)]
        kernels.append({
            "name": f"blend_fwd_packed/{mode}",
            "route": "cuda",
            "source": "igs_tpu_torch/csrc/blend_fwd.cu",
            "replaces": "igs_tpu/ops/pallas_blend.py:893",
            "launches": launches[f"blend_fwd_packed/{mode}"],
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["mode"] == mode),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": None,
        })
    by_case = {(c["case"], c["mode"]): c for c in bwd_cases}
    for mode in ("color", "color_depth", "full"):
        c = by_case[("eval 1014x1352", mode)]
        kernels.append({
            "name": f"blend_bwd_packed/{mode}",
            "route": "cuda",
            "source": "igs_tpu_torch/csrc/blend_bwd.cu",
            "replaces": "igs_tpu/ops/pallas_blend.py:1121",
            "launches": launches[f"blend_bwd_packed/{mode}"],
            "max_abs_err": max(x["max_abs_err"] for x in bwd_cases
                               if x["mode"] == mode),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": None,
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
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class launch_counters:
    """The kernels' launch counters, read and reset together."""

    def __init__(self, blend, segred):
        self.fwd = blend.blend_raw_packed_cuda
        self.bwd = blend.blend_raw_packed_bwd_cuda
        self.scan = segred.segmented_scan_cuda
        self.modes = list(blend.MODES)

    def reset(self):
        for fn in (self.fwd, self.bwd):
            fn.launches = 0
            fn.launches_by_mode = dict.fromkeys(self.modes, 0)
        self.scan.launches = 0

    def read(self):
        out = {f"blend_fwd_packed/{m}": self.fwd.launches_by_mode[m]
               for m in self.modes}
        out.update({f"blend_bwd_packed/{m}": self.bwd.launches_by_mode[m]
                    for m in self.modes})
        out["segmented_scan"] = self.scan.launches
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


def profile_refine_step(pipe, ra, blend, segred):
    """One refine step timed by stage with CUDA events, and one under
    ``torch.profiler`` (device busy, idle share)."""
    from dataclasses import replace

    import torch
    from torch.autograd import DeviceType
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

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        refine_step(st, cam, gt, bg, cfg, s)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"profile: one refine step, {wall_ms:.1f} ms wall (profiled), "
        f"device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for key, ms, n in rows[:20]:
        log(f"profile: {ms:9.3f} ms  x{n:<5d} {key[:100]}")


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
    from torch.autograd import DeviceType
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
    # device-side events only (kernels, copies): the aten ops that launched
    # them carry the same device time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"profile: one AGM forward, {wall_ms:.1f} ms wall (profiled), "
        f"device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    if not rows:
        log("profile: the profiler saw no device time")
        return
    for key, ms, n in rows[:25]:
        log(f"profile: {ms:9.3f} ms  x{n:<5d} {key[:100]}")


if __name__ == "__main__":
    sys.exit(main())
