"""Time the windowed blend forward (B5a) and the contribution count (B4)
against an earlier commit's kernels on the same inputs, in one process on
one card, and the training step through each forward route.

    mkdir -p build/parent_csrc
    git show f8213fb:igs_tpu_torch/csrc/blend_win_fwd.cu \\
        > build/parent_csrc/blend_win_fwd.cu
    git show f8213fb:igs_tpu_torch/csrc/blend_count.cu \\
        > build/parent_csrc/blend_count.cu
    python -m igs_tpu_torch.tools.bench_blend_parent \\
        --parent build/parent_csrc [--train-steps 10]

Run from the checkout's root: the inputs are ``chip_smoke.py``'s. The
earlier kernels are built with ``cuda_build.NVCC_FLAGS`` into
``build/parent/`` and bound with ``ctypes``:
``igs_blend_fwd_windowed(windows, max_per_tile, counts, tiles, grid_x,
tiles_per_view, mode, out, stream)``, fed with ``gather_tile_windows``
of ``max_per_tile`` rows, and ``igs_count_contributions_packed`` without
the order scratch.

 - B5a, the stream's 512² view (the smoke's phase 5), three modes at
   windows 1024 and 8192: the earlier kernel alone and with its gather
   (the earlier ``_BlendRaw.forward``) against the new kernel (which
   gathers nothing); each reading two eager means of 20 calls (CUDA
   events, one warm input), in turns earlier, new, new, earlier; the
   kernels also on an L2-cold rotation of input copies
   (``chip_smoke.cold_ms``: the medians of ``devtime.rotation_ms``'s
   eager and CUDA-graph-replayed readings).
 - B4 at the eval view (partial tiles) and the frame-0 512² view, timed
   the same ways.
 - Training (the smoke's phase 11 at ``--train-steps`` steps a run, the
   last profiled): runs through the earlier forward route, the new, the
   new, the earlier; per run the mean ms by stage of the warm steps
   (from step 3, the profiled one left out), the peak memory, the
   profiled step's device busy time and its window gathers (count and
   ms, CUDA events around each call: ``chip_smoke.WindowGathers``).

Every line is JSON on stdout, with the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

MODES = {"color": 0, "color_depth": 1, "full": 2}


def build_parent(src_dir: Path) -> dict:
    """The earlier sources built and bound: {"fwd": fn, "count": fn}."""
    from igs_tpu_torch.ops import cuda_build

    out_dir = cuda_build.build_dir().parent / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("blend_win_fwd", "blend_count"):
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
             str(src_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log_text}")
        libs[name] = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    fwd = libs["blend_win_fwd"].igs_blend_fwd_windowed
    fwd.argtypes = [P, I, P] + [I] * 4 + [P] * 2
    count = libs["blend_count"].igs_count_contributions_packed
    count.argtypes = [P] * 4 + [I] * 5 + [P] * 2
    fwd.restype = count.restype = I
    return {"fwd": fwd, "count": count}


def _stream():
    return torch.cuda.current_stream().cuda_stream


def parent_fwd(lib, windows, counts, gx, gy, mode):
    out = torch.empty((counts.shape[0], 256, 24), device=windows.device)
    err = lib["fwd"](windows.data_ptr(), windows.shape[1], counts.data_ptr(),
                     counts.shape[0], gx, gx * gy, MODES[mode],
                     out.data_ptr(), _stream())
    if err:
        raise RuntimeError(f"earlier windowed forward failed: {err}")
    return out


def parent_count(lib, rows, gauss_id, tile_start, tile_count, gx, gy, width,
                 height):
    counts = torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
    err = lib["count"](rows.data_ptr(), gauss_id.data_ptr(),
                       tile_start.data_ptr(), tile_count.data_ptr(),
                       tile_count.shape[0], gx, gx * gy, width, height,
                       counts.data_ptr(), _stream())
    if err:
        raise RuntimeError(f"earlier count failed: {err}")
    return counts


def eager_turns(smoke, fns, reps=20):
    """Two eager readings of each callable, in turns a, b, ..., ..., b, a."""
    names = list(fns)
    out = {n: [] for n in names}
    for n in names + names[::-1]:
        out[n].append(smoke.cuda_ms(fns[n], reps=reps, warmup=3))
    return out


def bench_windowed(smoke, lib, g, dev):
    from igs_tpu_torch.core.camera import Camera
    from igs_tpu_torch.ops.blend_windowed import (
        blend_raw_cuda, gather_tile_windows)

    c2ws = smoke.make_cameras()
    cam = Camera.from_c2w(c2ws[smoke.EVAL_VIEW], (smoke.FOV, smoke.FOV),
                          (smoke.TRAIN_RES, smoke.TRAIN_RES),
                          device=dev).batched()
    feats_t, start, tile_count, gx, gy = smoke.window_inputs(
        g, cam, (smoke.TRAIN_RES, smoke.TRAIN_RES), 1 << 21)
    for mode in MODES:
        for maxpt in smoke.WIN_BUDGETS:
            counts = torch.clamp_max(tile_count, maxpt)
            win = gather_tile_windows(feats_t, start, maxpt)
            new = blend_raw_cuda(feats_t, start, counts, gx, gy, mode)
            old = parent_fwd(lib, win, counts, gx, gy, mode)
            torch.cuda.synchronize()
            eager = eager_turns(smoke, {
                "earlier_kernel": lambda: parent_fwd(lib, win, counts, gx, gy,
                                                     mode),
                "earlier_gather_and_kernel": lambda: parent_fwd(
                    lib, gather_tile_windows(feats_t, start, maxpt), counts,
                    gx, gy, mode),
                "new": lambda: blend_raw_cuda(feats_t, start, counts, gx, gy,
                                              mode)})
            live = 4 * int(counts.sum()) * smoke.LANES_READ[mode]
            replayed = {
                "earlier_kernel": smoke.cold_ms(lambda w: parent_fwd(
                    lib, w, counts, gx, gy, mode), win, live),
                "new": smoke.cold_ms(lambda x: blend_raw_cuda(
                    x, start, counts, gx, gy, mode), feats_t, live)}
            del win
            print(json.dumps({
                "kernel": "blend_fwd_win", "mode": mode, "max_per_tile": maxpt,
                "tiles": int(counts.numel()), "pairs": int(tile_count.sum()),
                "densest_tile": int(tile_count.max()),
                "bit_equal_earlier": bool(torch.equal(new, old)),
                "max_abs_diff": float((new - old).abs().max()),
                "eager_ms": eager, "l2_cold": replayed}), flush=True)


def bench_count(smoke, lib, cases):
    from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
    from igs_tpu_torch.ops.count import (
        count_contributions_packed_cuda, count_rows)
    from igs_tpu_torch.ops.projection import project

    for name, g, cam, hw, budget in cases:
        proj = project(g.get_xyz, g.get_scaling, g.get_rotation,
                       g.get_opacity, cam, shs=g.shs, valid=g.valid,
                       geometry=False)
        gx, gy = image_tile_grid(*hw)
        pairs = build_tile_pairs(proj, gx, gy, budget)
        rows = count_rows(proj)
        rest = (pairs.gauss_id, pairs.tile_start, pairs.tile_count, gx, gy,
                hw[1], hw[0])
        new = count_contributions_packed_cuda(rows, *rest)
        old = parent_count(lib, rows, *rest)
        torch.cuda.synchronize()
        eager = eager_turns(smoke, {
            "earlier": lambda: parent_count(lib, rows, *rest),
            "new": lambda: count_contributions_packed_cuda(rows, *rest)})
        live = smoke.COUNT_BYTES_PER_PAIR * int(pairs.tile_count.sum())
        replayed = {
            "earlier": smoke.cold_ms(lambda r: parent_count(lib, r, *rest),
                                     rows, live),
            "new": smoke.cold_ms(
                lambda r: count_contributions_packed_cuda(r, *rest), rows,
                live)}
        print(json.dumps({
            "kernel": "count_contributions_packed", "case": name,
            "tiles": int(pairs.tile_count.numel()),
            "pairs": int(pairs.tile_count.sum()),
            "densest_tile": int(pairs.tile_count.max()),
            "equal_earlier": bool(torch.equal(new, old)),
            "total": int(new.sum()), "eager_ms": eager,
            "l2_cold": replayed}), flush=True)


def bench_training(smoke, lib, dev, steps):
    from igs_tpu_torch.models import agm as agm_mod
    from igs_tpu_torch.ops import blend, count, segred
    from igs_tpu_torch.ops import blend_windowed as bw

    workspace = tempfile.mkdtemp(prefix="bench_blend_parent_")
    root = os.path.join(workspace, "train_data")
    smoke.write_train_scene(dev, root)
    _, maxpt, _, budget = smoke.densest_train_tile(
        smoke.train_config(root, ""), dev)
    counters = smoke.launch_counters(blend, bw, segred, count)
    new_fwd = bw.blend_raw_fwd

    def earlier_fwd(feats_t, tile_start, counts, gx, gy, mode, chunk=128):
        # the earlier _BlendRaw.forward: a window of max_per_tile rows
        return parent_fwd(lib, bw.gather_tile_windows(feats_t, tile_start,
                                                      maxpt),
                          counts, gx, gy, mode)

    for i, route in enumerate(("earlier", "new", "new", "earlier")):
        bw.blend_raw_fwd = earlier_fwd if route == "earlier" else new_fwd
        timer = smoke.StepTimer(torch, agm_mod)
        gathers = smoke.WindowGathers(bw)
        torch.cuda.reset_peak_memory_stats()
        try:
            cfg = smoke.train_config(
                root, os.path.join(workspace, f"run_{i}"), budget)
            _, recs = smoke.run_training(cfg, dev, counters, maxpt, steps,
                                         timer=timer, profile_step=steps,
                                         gathers=gathers)
        finally:
            timer.close()
            gathers.close()
            bw.blend_raw_fwd = new_fwd
        warm = [r["ms"] for r in recs[2:] if r["step"] != steps]
        last = recs[-1]
        print(json.dumps({
            "training": route, "run": i, "max_per_tile": maxpt,
            "max_pairs": budget,
            "mean_warm_ms": {k: float(np.mean([w[k] for w in warm]))
                             for k in warm[0]},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            **{k: last[k] for k in ("profiled_busy_ms", "profiled_wall_ms",
                                    "window_gathers", "window_gather_ms")},
            "losses": [r["loss"] for r in recs]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory with the earlier blend_win_fwd.cu and "
                         "blend_count.cu")
    ap.add_argument("--train-steps", type=int, default=10,
                    help="steps a training run (0: no training runs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_blend_parent: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    from igs_tpu_torch.builders import build_raster_settings
    from igs_tpu_torch.core.camera import Camera
    from igs_tpu_torch.core.gaussians import Gaussians

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"card": smoke.card_line()}), flush=True)
    lib = build_parent(args.parent)
    dev = torch.device("cuda")

    start_gs = Gaussians.create(*smoke.scene_gaussians(
        0.0, smoke.N_GAUSSIANS, static_frac=smoke.STATIC_FRAC),
        device=dev).pad_to(smoke.MAX_NUM)
    bench_windowed(smoke, lib, start_gs, dev)

    xyz, opacity, rot, scaling, shs = smoke.scene_gaussians(
        0.0, smoke.N_GAUSSIANS, seed=1, static_frac=smoke.STATIC_FRAC)
    g_f0 = Gaussians.create(xyz + smoke.F0_CENTER, opacity, rot, scaling, shs,
                            device=dev)
    c2ws_f0 = smoke.make_cameras(smoke.F0_VIEWS)
    c2ws_f0[:, :3, 3] += smoke.F0_CENTER
    fov = (smoke.FOV, smoke.FOV)
    eval_cam = Camera.from_c2w(smoke.make_cameras()[smoke.EVAL_VIEW], fov,
                               smoke.OUT_HW, device=dev).batched()
    f0_res = (smoke.F0_RES, smoke.F0_RES)
    f0_cam = Camera.from_c2w(c2ws_f0[0], fov, f0_res, device=dev).batched()
    bench_count(smoke, lib, (
        ("eval 1014x1352", start_gs, eval_cam, smoke.OUT_HW,
         build_raster_settings(*smoke.OUT_HW).max_pairs),
        (smoke.F0_CASE, g_f0, f0_cam, f0_res, smoke.F0_MAX_PAIRS)))
    del start_gs, g_f0
    torch.cuda.empty_cache()
    if args.train_steps:
        bench_training(smoke, lib, dev, args.train_steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
