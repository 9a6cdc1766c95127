"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. card and settings: name and power limit, TF32 off for matmuls and
     cuDNN convolutions (the port runs float32 throughout);
  2. build every kernel of the main path from ``igs_tpu_torch/csrc``
     (one nvcc per source, started together);
  3. a synthetic N3DV-shaped stream made in memory from a seed: the scene
     recipe of ``igs_tpu/data/synthetic.py`` with the sparse ranges of
     ``configs/synthetic_fullshape.yaml`` (512² inputs, 1014×1352 outputs,
     120 000 Gaussians padded to 150 000); ground truth and frame-0 depth
     come from the port's own rasterizer. The config's log-scale range
     (-4.6, -3.4) was sized for 50 000 Gaussians: at 120 000 the eval view
     needs 2.18M tile pairs, past the pipeline's 2^21 cap, so the range
     shifts to (-5.0, -3.8), which keeps the eval view at ~1.2M pairs;
  4. kernel vs plain: the packed blend kernel against its plain PyTorch
     version on the same inputs, in color, color_depth and full mode, at
     the eval shape (64×85 tiles) and at the 128² depth-carry shape (four
     views in one launch); CUDA-event times, error per lane group;
  5. the main path: ``build_model`` on the ``system`` section of
     ``configs/synthetic_fullshape.yaml`` (random weights from a seeded
     generator) and two streaming windows of B=5 through the port's
     ``StreamingPipeline``, with the launch counters reset just before;
  6. the first window again with the blend routed to the plain version,
     images compared with the kernel run;
  7. one AGM-Net forward timed by top-level module (CUDA events), and one
     under ``torch.profiler`` (device time by kernel, idle share).
The line before the card line is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12  # outside the tensor cores
FLOPS_PER_PIXEL_PAIR = 30
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
IN_RES = 512
OUT_HW = (1014, 1352)
N_GAUSSIANS = 120_000
MAX_NUM = 150_000
N_CAMS = 14
EVAL_VIEW, INPUT_VIEWS = 0, (13, 1, 8, 4)  # the n3d view table
INTERVAL = 5
B = 5
ANCHORS = 8192
FOV = 0.8
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
    """collate()-layout items of a key→candidate stream, in memory."""

    def __init__(self, items, start_gs):
        self.items = items
        self.start_gs = start_gs

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
    frames = [Gaussians.create(*scene_gaussians(0.4 * f, N_GAUSSIANS),
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
    return Stream(items, frames[0].to("cpu")), frames[0], c2ws


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
    nbytes = 4 * (live * LANES_READ[mode] + kern.numel())
    ops = FLOPS_PER_PIXEL_PAIR * walked
    bound_ms = 1e3 * max(nbytes / H100_BYTES_PER_S, ops / H100_FP32_FLOPS)
    res = {
        "case": name, "mode": mode, "tiles": int(count.numel()),
        "pairs": live, "flips": int(flip.sum()), "pixels": pixels,
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


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from igs_tpu_torch.builders import (
            build_model, build_raster_settings)
        from igs_tpu_torch.core.camera import Camera
        from igs_tpu_torch.ops import blend, cuda_build
        from igs_tpu_torch.stream.pipeline import StreamConfig, StreamingPipeline
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: torch.backends.cuda.matmul.allow_tf32=False "
        "torch.backends.cudnn.allow_tf32=False (float32 throughout)")

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build(["blend_fwd.cu"])
    log(f"build: {time.perf_counter() - t0:.2f} s wall; per source "
        f"{json.dumps(cuda_build.BUILD_SECONDS)}")
    for line in cuda_build.BUILD_LOG.get("blend_fwd.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    # -- scene -------------------------------------------------------------
    t0 = time.perf_counter()
    n_items = 2 * B
    stream, g0, c2ws = build_stream(dev, n_items)
    log(f"scene: {n_items} items, {N_GAUSSIANS} Gaussians, inputs "
        f"{IN_RES}², outputs {OUT_HW[0]}x{OUT_HW[1]}, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- kernel vs plain ---------------------------------------------------
    start_gs = g0.pad_to(MAX_NUM)
    eval_cam = Camera.from_c2w(c2ws[EVAL_VIEW], (FOV, FOV), OUT_HW,
                               device=dev).batched()
    depth_cams = Camera.stack([Camera.from_c2w(c2ws[v], (FOV, FOV),
                                               (128, 128), device=dev)
                               for v in INPUT_VIEWS])
    eval_budget = build_raster_settings(*OUT_HW).max_pairs
    cases = []
    for mode in ("color", "color_depth", "full"):
        cases.append(compare_kernel(
            "eval 1014x1352", *packed_inputs(start_gs, eval_cam, OUT_HW, mode,
                                             eval_budget), mode))
        cases.append(compare_kernel(
            "depth-carry 4x128x128", *packed_inputs(
                start_gs, depth_cams, (128, 128), mode, 1 << 19), mode))
    bad = [f"{c['case']}/{c['mode']}" for c in cases if not c["ok"]]
    if bad:
        raise RuntimeError(
            f"blend kernel disagrees with its plain version in {bad} "
            f"(tolerance {TOL_ABS} off flip pixels, flips ≤ {TOL_FLIP_FRAC} "
            "of pixels)")

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
    cfg = StreamConfig(eval_batch_size=B, refine_gs=False, max_num=MAX_NUM,
                       anchor_size=ANCHORS, neighbor_k=8, depth_view_res=128,
                       save_images=False, workspace=workspace)
    settings = build_raster_settings(*OUT_HW)
    pipe = StreamingPipeline(model, stream, cfg, settings, device=dev)
    torch.cuda.reset_peak_memory_stats()
    blend.blend_raw_packed_cuda.launches = 0
    blend.blend_raw_packed_cuda.launches_by_mode = dict.fromkeys(blend.MODES, 0)
    t0 = time.perf_counter()
    results = pipe.run(max_batches=2)
    wall = time.perf_counter() - t0
    launches = blend.blend_raw_packed_cuda.launches
    by_mode = dict(blend.blend_raw_packed_cuda.launches_by_mode)
    log(f"stream: {wall:.2f} s wall for 2 windows; AGM forward ms (CUDA "
        f"events) {agm_ms}; AGM_times s (host clock) {results['AGM_times']}")
    log(f"stream: psnr {json.dumps(results['psnr'])} avg {results['avg']:.4f}")
    log(f"stream: fps(render) {results['fps']:.3f} points_num "
        f"{results['points_num']} mask_num {results['mask_num']} "
        f"overflow_events {results['overflow_events']}")
    log(f"stream: blend launches {launches} by mode {by_mode}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches == 0 or by_mode["color"] == 0 or by_mode["color_depth"] == 0:
        raise RuntimeError("the main path did not launch the blend kernel")
    psnr = list(results["psnr"].values())
    if len(psnr) != n_items or not all(math.isfinite(p) for p in psnr):
        raise RuntimeError(f"non-finite or missing PSNR: {psnr}")
    if results["overflow_events"]:
        raise RuntimeError(f"overflow events: {results['overflow_events']}")
    first = captured[0]
    if first.shape != (B, 1, 3) + OUT_HW or not torch.isfinite(first).all():
        raise RuntimeError(f"bad images_pred {tuple(first.shape)}")

    # -- first window with the plain blend ------------------------------------
    kernel_fn = blend.blend_raw_packed_cuda
    captured.clear()
    blend.blend_raw_packed_cuda = blend.blend_raw_packed_plain
    try:
        plain_pipe = StreamingPipeline(model, stream, cfg, settings,
                                       device=dev)
        plain_pipe.run(max_batches=1)
    finally:
        blend.blend_raw_packed_cuda = kernel_fn
    diff = float((captured[0] - first).abs().max())
    log(f"first window, plain blend vs kernel: max |images_pred diff| {diff:.3g}"
        f" (tolerance {TOL_IMAGE})")
    if diff > TOL_IMAGE:
        raise RuntimeError("plain-blend rerun disagrees with the kernel run")

    # -- profile one AGM forward --------------------------------------------
    profile_window(pipe, stream, torch)

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
            "launches": by_mode[mode],
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["mode"] == mode),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
