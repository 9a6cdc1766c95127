"""The streaming driver: ``StreamingPipeline.run`` as a user runs it, one
clip a call, calls back to back until the measured window closes (the call
in flight is finished and counted).

Set-up makes the scene and its renders (``scene.py``), AGM-Net's weights
on the device (``weights.py``), the pipeline, and streams one clip to
build and warm every kernel. The benchmark wraps the pipeline's calls into
its layers (the anchors, AGM-Net, the refine) to name them in the trace
and to keep what the correctness check reads of two windows of the last
clip: window 0 and one drawn from the seed. It changes nothing they do.
A window is known by the frames of the batch that AGM-Net receives (the
benchmark's items carry their frame); a refine belongs to the window of
the forward before it.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from igs_bench import compare, flops, scene, trace as trace_mod
from igs_bench.drivers.common import (
    log, peak_bytes, program_model, reference_model, sync)
from igs_bench.weights import make_weights


class Recorder:
    """The benchmark's wrappers around the pipeline's calls into its
    layers. Each names its call in the trace (``bench:<layer>``); in the
    windows in ``sample`` of a clip (``b`` frames a window) it also keeps
    the call's inputs and outputs (references, no copies) for the check,
    and the refine's states before and after each of ``late`` steps."""

    def __init__(self, sample, b: int, late=()):
        self.sample = set(sample)
        self.b = b
        self.late = tuple(late)
        self.window: Optional[int] = None
        self.frozen = False
        self.forwards = 0
        self.records: Dict[int, Dict] = {}

    def _keep(self) -> Optional[Dict]:
        if self.frozen or self.window not in self.sample:
            return None
        return self.records.setdefault(self.window, {})

    def select_anchors(self, fn):
        def wrapped(*args, **kw):
            with torch.profiler.record_function("bench:anchors"):
                return fn(*args, **kw)
        return wrapped

    def model(self, model):
        def wrapped(batch, state, gaussians, *args, **kw):
            self.window = int(batch["frame"][0]) // self.b
            with torch.profiler.record_function("bench:agm"):
                out = model(batch, state, gaussians, *args, **kw)
            self.forwards += 1
            rec = self._keep()
            if rec is not None:
                rec.clear()
                rec["start"] = gaussians.map(lambda x: x[0])
                rec["depth"] = batch["depth"][:1]
                rec["out"] = {"anchors": state.anchor_idx[0],
                              "images": out["images_pred"][:, 0],
                              "xyz": out["3dgs"].xyz}
            return out
        return wrapped

    def refine_run(self, fn):
        def wrapped(state, *args, on_step=None, **kw):
            rec = self._keep()
            steps = None
            if rec is not None:
                steps = compare.refine_trace(late=self.late)
                rec["state0"] = state

            def chained(it, st, m):
                if on_step is not None:
                    on_step(it, st, m)
                if steps is not None:
                    steps.on_step(it, st, m)
            with torch.profiler.record_function("bench:refine"):
                out = fn(state, *args, on_step=chained, **kw)
            if rec is not None:
                rec["refine"] = steps.result(state)
            return out
        return wrapped


def count_work(cfg: Dict) -> Dict[str, float]:
    """AGM-Net's FLOPs and attention's least time for one window, on the
    meta device at the configuration's shapes and compute types."""
    from igs_bench.reference.ops.anchors import AnchorState

    v, s = cfg["views"], cfg["stream"]
    b, nv = int(s["eval_batch_size"]), len(v["input_views"])
    r, h8 = int(v["input_res"]), int(v["input_res"]) // 8 * 2
    n, a, k = int(s["max_num"]), int(s["anchor_size"]), int(s["neighbor_k"])
    model = reference_model(cfg, "meta", compute_types=True).eval()
    with torch.device("meta"):
        batch = {"cur_images_input": torch.empty(b, nv, 3, r, r),
                 "next_images_input": torch.empty(b, nv, 3, r, r),
                 "local_rays": torch.empty(b, h8, h8, 3),
                 "rays": torch.empty(b, nv, h8, h8, 6),
                 "depth": torch.empty(b, nv, h8, h8),
                 "FOV": torch.empty(b, 2),
                 "c2w_input": torch.empty(b, nv, 4, 4)}
        anchors = AnchorState(
            torch.empty(b, a, 3), torch.empty(b, a, dtype=torch.long),
            torch.empty(b, n, dtype=torch.bool), torch.empty(b, n, k),
            torch.zeros(b, n, k, dtype=torch.long))
        total, calls = flops.agm_forward_work(model, batch, anchors, True)
    return {"agm_flops": total,
            "attention_bound_s": flops.attention_bound_s(calls, "fwd")}


def build_pipeline(cfg: Dict, dataset, device, workspace: str):
    """The program: AGM-Net with the benchmark's weights, and the
    streaming pipeline over ``dataset``, as ``infer_stream`` builds them."""
    from igs_tpu_torch.builders import build_raster_settings
    from igs_tpu_torch.stream.pipeline import StreamConfig, StreamingPipeline
    from igs_tpu_torch.stream.refine import RefineConfig

    s = cfg["stream"]
    h, w = cfg["views"]["output_hw"]
    stream_cfg = StreamConfig(
        eval_batch_size=int(s["eval_batch_size"]), refine_gs=True,
        refine_iterations=int(s["refine_iterations"]),
        depth_view_res=int(s["depth_view_res"]), max_num=int(s["max_num"]),
        anchor_size=int(s["anchor_size"]), neighbor_k=int(s["neighbor_k"]),
        fps_buckets=int(s["fps_buckets"]), workspace=workspace,
        save_images=False)
    settings = build_raster_settings(int(h), int(w), clamp=True)
    model = program_model(cfg, device)
    return StreamingPipeline(model, dataset, stream_cfg,
                             RefineConfig(**cfg["refine"]), settings,
                             device=device)


def _overflowed_frames(res: Dict, b: int) -> int:
    bad = {e["batch"] for e in res["overflow_events"]
           if e["where"] in ("agm", "refine")}
    return sum(min(b, len(res["psnr"]) - i * b) for i in bad)


def run(job) -> Dict:
    """Set up, measure for ``job.seconds``, trace if asked, check; returns
    the observations, the check and the device readings."""
    import igs_tpu_torch.stream.pipeline as pipeline_mod
    from igs_tpu_torch.core.gaussians import Gaussians as ProgramGaussians

    cfg, traffic, dev = job.cfg, job.traffic, job.device
    s = cfg["stream"]
    b = int(s["eval_batch_size"])
    windows_per_clip = math.ceil(int(traffic["clip_frames"]) / b)
    rng = np.random.default_rng(job.seed)
    sample = (0, int(rng.integers(1, windows_per_clip))) \
        if windows_per_clip > 1 else (0,)

    log(job, "set-up: imports done")
    dataset = scene.build_stream(cfg, traffic, job.seed, dev)
    dataset.start_gs = ProgramGaussians(**dataset.start_gs)
    sync(dev)
    log(job, "set-up: scene and its renders made")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pipe = build_pipeline(cfg, dataset, dev, job.workspace)
    weights = make_weights({k: v.shape for k, v in
                            pipe.model.state_dict().items()},
                           job.seed, float(cfg["weights"]["head_scale"]), dev)
    pipe.model.load_state_dict(weights)
    late = compare.late_steps(cfg["refine"], int(s["refine_iterations"]))
    rec = Recorder(sample, b, late)
    # where the pipeline no longer calls these by name, nothing is
    # wrapped: the spans go unnamed and the check finds no refine to read
    saved = {k: getattr(pipeline_mod, k) for k in ("select_anchors",
                                                    "refine_run")
             if hasattr(pipeline_mod, k)}
    for k, fn in saved.items():
        setattr(pipeline_mod, k, getattr(rec, k)(fn))
    pipe.model = rec.model(pipe.model)
    log(job, "set-up: pipeline and weights made")
    try:
        obs = _measure(job, pipe, rec, b)
    finally:
        for k, fn in saved.items():
            setattr(pipeline_mod, k, fn)
    peak = peak_bytes(dev)
    obs.update(count_work(cfg))
    records = rec.records
    del pipe, rec
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(job, "window closed; checking")
    numbers = check(job, dataset, weights, records, late, sample)
    log(job, "checked")
    return {"obs": obs, "numbers": numbers, "memory_peak_bytes": peak}


def _measure(job, pipe, rec, b: int) -> Dict:
    dev = job.device
    # set-up ends with one clip: every kernel built and warm
    pipe.run()
    pipe.refine_log.clear()
    sync(dev)
    setup_s = time.perf_counter() - job.t_start
    log(job, "set-up: warm clip streamed; the window opens")
    frames = windows = failed = stale = 0
    agm_s, refine_ms, clip_s = [], [], []
    t0 = time.perf_counter()
    while True:
        t_clip = time.perf_counter()
        res = pipe.run()
        clip_s.append(time.perf_counter() - t_clip)
        stale += sum(e["where"] == "shared_pairs_stale"
                     for e in res["overflow_events"])
        frames += len(res["psnr"])
        windows += len(res["AGM_times"])
        failed += _overflowed_frames(res, b)
        agm_s += res["AGM_times"]
        refine_ms += [r["ms_per_step"] for r in pipe.refine_log]
        pipe.refine_log.clear()
        if time.perf_counter() - t0 >= job.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    rec.frozen = True
    obs = {"setup_s": setup_s, "window_s": window_s, "frames": frames,
           "windows": windows, "failed": failed, "agm_s": agm_s,
           "refine_ms_per_step": refine_ms}
    log(job, f"window: {frames} frames in {window_s:.3f} s; clips "
        f"{', '.join(f'{c:.3f}' for c in clip_s)} s; {stale} windows "
        "re-rendered for stale shared pairs")
    if job.trace:
        obs["trace"] = _trace_clip(pipe, rec, dev)
        log(job, "traced clip reduced")
    return obs


def _trace_clip(pipe, rec, dev) -> Dict:
    """One more clip under ``torch.profiler``: the device's busy time,
    time by operation and the idle gaps of whole windows."""
    from torch.profiler import ProfilerActivity, profile

    forwards = rec.forwards
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        pipe.run()
        sync(dev)
        span = time.perf_counter() - t0
    pipe.refine_log.clear()
    out = trace_mod.reduce_trace(prof, span)
    out["agm_forwards"] = rec.forwards - forwards
    return out


def check(job, dataset, weights, records: Dict[int, Dict], late,
          sample) -> Dict:
    """The program's numbers against the reference, for each window of
    ``sample`` (the worst over them), and, with ``job.control``, the
    control's. A window the program left no record of reads infinity."""
    from igs_bench.reference.core.gaussians import Gaussians

    cfg, dev = job.cfg, job.device
    s = cfg["stream"]
    b = int(s["eval_batch_size"])
    beta1 = float(cfg["refine"].get("beta1", 0.9))
    with compare.strict_fp32():
        model = reference_model(cfg, dev).eval()
        model.load_state_dict(weights)
        ref = compare.Reference(model, cfg, dev)
        if job.control:
            # the control knows the configuration's compute types: it
            # computes a step below each (lowp.round_input)
            typed = reference_model(cfg, dev, compute_types=True).eval()
            typed.load_state_dict(weights)
            low = compare.Reference(typed, cfg, dev)
        sides = {"program": {}}
        for w in sample:
            rec = records.get(w, {})
            if not {"out", "state0", "refine"} <= set(rec):
                for k in job.traffic["limits"]:
                    sides["program"][k] = math.inf
                continue
            if w == 0:
                start = Gaussians(**{k: torch.as_tensor(v, device=dev) for
                                     k, v in _start_fields(dataset).items()}
                                  ).pad_to(int(s["max_num"]))
                depth = torch.as_tensor(
                    np.asarray(dataset[0]["depth"]), device=dev)[None]
            else:
                start = compare.to_reference_gaussians(rec["start"])
                depth = rec["depth"]
            key = (w + 1) * b
            radius = float(dataset[w * b]["radius"])
            truth = ref.window(dataset, w, start, depth)
            before = rec["refine"]["before"]
            truth_refine = ref.refine(dataset, key, rec["state0"], radius,
                                      before)
            got = {"program": (rec["out"], rec["refine"])}
            if job.control:
                # faults planted in the program's own outputs: half of
                # the window's candidates left out (the first half's in
                # their place); AGM-Net's deform left out (each candidate
                # the start's positions and the window's mean image); one
                # image altered where it is produced (a block of 64x64
                # pixels moved by 0.5)
                out = rec["out"]
                images, xyz = out["images"], out["xyz"]
                b_ = images.shape[0]
                half = torch.arange(b_, device=images.device) % ((b_ + 1) // 2)
                altered = images.clone()
                altered[-1, :, :64, :64] += 0.5
                got["fault_half"] = (dict(out, images=images[half],
                                          xyz=xyz[half]), rec["refine"])
                got["fault_zero"] = (dict(
                    out, images=images.mean(0, keepdim=True).expand_as(
                        images),
                    xyz=rec["start"].xyz.expand_as(xyz)), rec["refine"])
                got["fault_altered"] = (dict(out, images=altered),
                                        rec["refine"])
                from igs_bench.reference import lowp

                with lowp.control():
                    got["control"] = (low.window(dataset, w, start, depth),
                                      low.refine(dataset, key, rec["state0"],
                                                 radius, before))
            for side, (win, refn) in got.items():
                nums = compare.compare_window(win, truth)
                nums.update(compare.compare_refine(refn, truth_refine, beta1,
                                                   late))
                if job.control:  # each window's own numbers, for the record
                    sides.setdefault(f"{side}_by_window", {})[str(w)] = nums
                for k, v in nums.items():
                    old = sides.setdefault(side, {}).get(k, -math.inf)
                    sides[side][k] = max(old, v) if not math.isnan(v) \
                        else math.nan
            del truth, truth_refine, got
    return sides


def _start_fields(dataset) -> Dict:
    g = dataset.start_gs
    return {k: getattr(g, k) for k in ("xyz", "opacity", "rotation",
                                       "scaling", "shs", "valid")}
