"""The training driver: AGM-Net's train step back to back, each through
``run_guarded_step(step_fn, …)`` as ``train_agm.run`` calls it, on items
prepared (anchors selected) once each, as its ``prep_cached`` does for a
small dataset.

Set-up makes the training pairs (``scene.build_pairs``), the weights on
the device, the model, the optimizer and the step, and drives the step
through its first ``CHECK_STEPS`` steps on items that all differ: they
build and warm every kernel, and the check follows them in the reference.
The same objects then train through the measured window. The step's
``on_stage`` hook records a CUDA event at each stage mark, for the
per-stage times.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from igs_bench import compare, flops, scene, trace as trace_mod
from igs_bench.drivers.common import (
    log, peak_bytes, program_model, reference_model, sync)
from igs_bench.weights import make_weights

CHECK_STEPS = 3
TRACED_STEPS = 3


class StageEvents:
    """``on_stage``: a CUDA event at every mark of a step, kept per step
    while ``on``."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.on = False
        self.steps: List[Dict[str, torch.cuda.Event]] = []

    def __call__(self, name: str) -> None:
        if not (self.on and self.cuda):
            return
        if name == "start":
            self.steps.append({})
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1][name] = ev

    def mean_ms(self, first: str, last: str):
        ms = [s[first].elapsed_time(s[last]) for s in self.steps
              if first in s and last in s]
        return sum(ms) / len(ms) if ms else None


class Order:
    """The items of each step: a permutation of the pairs an epoch, drawn
    from the seed, taken ``batch`` at a time (train_agm's loop)."""

    def __init__(self, n: int, batch: int, seed: int):
        self.n, self.batch = n, batch
        self.rng = np.random.RandomState(seed % (1 << 32))
        self.order, self.at = self.rng.permutation(n), 0

    def next(self) -> List[int]:
        if self.at + self.batch > self.n:
            self.order, self.at = self.rng.permutation(self.n), 0
        idxs = self.order[self.at:self.at + self.batch]
        self.at += self.batch
        return [int(i) for i in idxs]


def count_work(cfg: Dict) -> Dict[str, float]:
    """AGM-Net's FLOPs of a training step (forward and backward of the
    network, renders excluded) and attention's least time (forward and
    backward), on the meta device."""
    from igs_bench.reference.ops.anchors import AnchorState

    v, t = cfg["views"], cfg["train"]
    b, nv, r = int(t["batch_size"]), int(v["num_input_views"]), int(v["res"])
    h8 = r // 8 * 2
    n, a, k = int(t["capacity"]), int(t["anchor_size"]), int(t["neighbor_k"])
    model = reference_model(cfg, "meta", compute_types=True).train()
    with torch.device("meta"):
        batch = {"cur_images_input": torch.empty(b, nv, 3, r, r),
                 "next_images_input": torch.empty(b, nv, 3, r, r),
                 "local_rays": torch.empty(b, h8, h8, 3),
                 "rays": torch.empty(b, nv, h8, h8, 6),
                 "depth": torch.empty(b, nv, r, r),
                 "FOV": torch.empty(b, 2),
                 "c2w_input": torch.empty(b, nv, 4, 4)}
        anchors = AnchorState(
            torch.empty(b, a, 3), torch.empty(b, a, dtype=torch.long),
            torch.empty(b, n, dtype=torch.bool), torch.empty(b, n, k),
            torch.zeros(b, n, k, dtype=torch.long))
        total, calls = flops.agm_forward_work(model, batch, anchors, False,
                                              backward=True)
    return {"agm_flops": total,
            "attention_bound_s": flops.attention_bound_s(calls, "fwd")
            + flops.attention_bound_s(calls, "bwd")}


def run(job) -> Dict:
    from igs_tpu_torch.builders import build_raster_settings
    from igs_tpu_torch.core.gaussians import Gaussians as ProgramGaussians
    from igs_tpu_torch.train.driver import (
        OptConfig, make_optimizer, make_train_step, run_guarded_step)
    from igs_tpu_torch.train_agm import _concat, prep_batch

    cfg, traffic, dev = job.cfg, job.traffic, job.device
    t = cfg["train"]
    bs = int(t["batch_size"])
    log(job, "set-up: imports done")
    pairs = scene.build_pairs(cfg, traffic, job.seed, dev)
    pairs.gaussians = [ProgramGaussians(**g) for g in pairs.gaussians]
    sync(dev)
    log(job, "set-up: pairs and their renders made")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = program_model(cfg, dev)
    weights = make_weights({k: p.shape for k, p in
                            model.state_dict().items()},
                           job.seed, float(cfg["weights"]["head_scale"]), dev)
    model.load_state_dict(weights)
    model.train()
    ocfg = OptConfig(**cfg["opt"])
    total_steps = ocfg.num_epochs * max(len(pairs) // bs, 1)
    optimizer, _ = make_optimizer(model, ocfg, total_steps,
                                  train_backbone=model.train_backbone)
    h = w = int(cfg["views"]["res"])
    settings = build_raster_settings(h, w, clamp=True)
    stages = StageEvents(dev)
    step_fn = make_train_step(ocfg, settings, on_stage=stages)
    cap = int(t["capacity"])
    cache = {i: prep_batch(pairs, [pairs[i]], dev, int(t["anchor_size"]),
                           int(t["neighbor_k"]), cap)
             for i in range(len(pairs))}
    order = Order(len(pairs), bs, job.seed)
    log(job, "set-up: model, optimizer and items made")

    def step(n: int, idxs: List[int]):
        batch, state, gs = _concat([cache[i] for i in idxs])
        return run_guarded_step(step_fn, job.workspace, n, model, optimizer,
                                batch, state, gs)

    # the first steps: the kernels' builds and warm-up, and what the check
    # follows
    first, losses, g1 = [], [], None
    beta1 = float(cfg["opt"]["beta1"])
    for n in range(CHECK_STEPS):
        first.append(order.next())
        losses.append(step(n, first[-1])["loss"])
        if n == 0:
            g1 = {k: v / (1 - beta1) for k, v in optimizer.mu.items()}
    params = dict(model.named_parameters())
    record = {"losses": [float(x) for x in losses], "g1": g1,
              "delta": {k: params[k].detach() - weights[k] for k in g1}}
    sync(dev)
    setup_s = time.perf_counter() - job.t_start
    log(job, "set-up: first steps done; the window opens")

    stages.on = True
    steps, n = 0, CHECK_STEPS
    t0 = time.perf_counter()
    while True:
        step(n, order.next())
        steps, n = steps + 1, n + 1
        if time.perf_counter() - t0 >= job.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    stages.on = False
    log(job, f"window: {steps} steps in {window_s:.3f} s")
    obs = {"setup_s": setup_s, "window_s": window_s, "steps": steps,
           "frames": steps * bs, "failed": 0,
           "fwd_ms": stages.mean_ms("start", "forward"),
           "bwd_ms": stages.mean_ms("loss", "backward"),
           "opt_ms": stages.mean_ms("backward", "optimizer")}
    if job.trace:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(TRACED_STEPS):
                with torch.profiler.record_function("bench:train_step"):
                    step(n, order.next())
                n += 1
            sync(dev)
            span = time.perf_counter() - t1
        obs["trace"] = trace_mod.reduce_trace(prof, span)
        obs["trace"]["agm_forwards"] = TRACED_STEPS
        log(job, "traced steps reduced")
    peak = peak_bytes(dev)
    obs.update(count_work(cfg))
    del model, optimizer, step_fn, cache, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(job, "window closed; checking")
    numbers = check(job, pairs, weights, first, record, total_steps)
    log(job, "checked")
    return {"obs": obs, "numbers": numbers, "memory_peak_bytes": peak}


def reference_steps(job, pairs, weights, first, total_steps,
                    fault: str = "") -> Dict:
    """The reference's first steps on the same items from the same
    weights: losses, the first gradient as the optimizer got it, and each
    leaf's change. ``fault`` plants one of the faults the check must
    catch: "half" trains on the first half of each batch (the mean over
    the rest), "altered" moves a block of one rendered view."""
    from igs_bench.reference import lowp
    from igs_bench.reference.core.gaussians import Gaussians
    from igs_bench.reference.ops.anchors import AnchorState, select_anchors
    from igs_bench.reference.ops.rasterize import RasterSettings
    from igs_bench.reference.train import optim

    cfg, dev = job.cfg, job.device
    t, o = cfg["train"], cfg["opt"]
    model = reference_model(cfg, dev).train()
    init = {k: (lowp.bf16(v) if lowp.active() else v)
            for k, v in weights.items()}
    model.load_state_dict(init)
    params = dict(model.named_parameters())
    opt = optim.AdamW(params, o, optim.onecycle_schedule(
        float(o["lr"]), total_steps, int(o["warmup_steps"])))
    r = int(cfg["views"]["res"])
    settings = RasterSettings(image_height=r, image_width=r, outputs="color",
                              clamp_grads=True)
    losses, g1 = [], None
    for n, idxs in enumerate(first):
        if fault == "half":
            idxs = idxs[:max(1, len(idxs) // 2)]
        batch = compare.collate_tensors(pairs, idxs, dev)
        gs, states = [], []
        for i in idxs:
            g = Gaussians(**{k: getattr(pairs.gaussians[i], k) for k in
                             ("xyz", "opacity", "rotation", "scaling", "shs",
                              "valid")}).pad_to(int(t["capacity"]))
            gs.append(g)
            with torch.no_grad():
                states.append(select_anchors(
                    g.xyz, batch["bounding_box"][len(states)],
                    valid=g.valid, anchor_size=int(t["anchor_size"]),
                    k=int(t["neighbor_k"])))
        state = AnchorState(*(torch.stack(x) for x in zip(*states)))
        out = model(batch, state, Gaussians.stack(gs), settings)
        pred = out["images_pred"]
        if fault == "altered":
            pred = pred.clone()
            pred[0, 0, :, :16, :16] = pred[0, 0, :, :16, :16] + 0.5
        loss = optim.loss_fn(pred, batch["images_output"], o)
        loss.backward()
        losses.append(float(loss.detach()))
        opt.step()
        if n == 0:
            g1 = {k: v / (1 - float(o["beta1"])) for k, v in opt.mu.items()}
        del out, pred, loss
    return {"losses": losses, "g1": g1,
            "delta": {k: params[k].detach() - weights[k] for k in g1}}


def check(job, pairs, weights, first, record, total_steps) -> Dict:
    """The program's first steps against the reference's; with
    ``job.control`` also the control's and the planted faults'."""
    from igs_bench.reference import lowp

    with compare.strict_fp32():
        truth = reference_steps(job, pairs, weights, first, total_steps)
        sides = {"program": compare.compare_steps(record, truth)}
        if job.control:
            with lowp.control():
                got = reference_steps(job, pairs, weights, first,
                                      total_steps)
            sides["control"] = compare.compare_steps(got, truth)
            for fault in ("half", "altered"):
                got = reference_steps(job, pairs, weights, first,
                                      total_steps, fault)
                sides[f"fault_{fault}"] = compare.compare_steps(got, truth)
            sides["program_worst_leaves"] = {
                what: compare.worst_leaves(record[what], truth[what])
                for what in ("g1", "delta")}
    for nums in sides.values():
        for k, v in nums.items():
            if isinstance(v, float) and math.isnan(v):
                nums[k] = math.inf
    return sides
