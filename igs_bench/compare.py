"""What decides ``correct``: the plain reference
(``reference/``, float32 with TF32 off) worked out again from the inputs
the benchmark made, and the numbers that compare the program's outputs
with it.

A window is checked from its start. Window 0 starts from the benchmark's
own frame-0 Gaussians and depth, so the reference computes all of it from
the inputs. A later window starts from the state the program carried
(the Gaussians its last refine gave and the depth it rendered): the
reference takes that start from the program, and the comparison of
window 0 checks the stage that this skips. Each window's refine is
followed for its first ``REFINE_STEPS`` Adam steps from the program's
state at the refine's start (the AGM output the window comparison
checks), as a training step is, and then one step at a time at each
densify step and at the last step (``late_steps``), each from the
program's state after the step before it: a refine that skips a densify
or stops early shows no such state, or one that differs.

Numbers, each against a limit in the cell's traffic file:
  anchors      share of the 8192 anchor indices that differ;
  image        the largest RMS difference of a candidate's eval image,
               the render of its deformed Gaussians;
  cand_merge   the window's candidates kept apart: for each pair of
               candidates, the distance between their deformed Gaussian
               positions in the reference over that in the program, the
               largest pair's (a candidate copied from another, or a
               deform left out, reads infinity; sound runs, whose rounding
               only adds distance, read about 1 or less);
  refine_loss  the largest relative gap of the first steps' losses;
  refine_grad  the first gradient's norm (from Adam's first moment after
               one step), the worst leaf's gap;
  refine_step  the norm of each leaf's change after the steps, the worst
               leaf's gap;
  late_loss    the largest relative gap of a late step's loss;
  late_step    the norm of each leaf's change over a late step (its
               densify included), the worst leaf's gap over the steps.
A training cell's numbers (``compare_steps``) are those of the refine's,
over AGM-Net's first three training steps: train_loss, train_grad,
train_step.
A leaf's gap is |‖program‖ − ‖reference‖| over the larger of the
reference's norm of that leaf and of the median leaf. A leaf whose
reference gradient is under a thousandth of the median leaf's is left
out (none is, at these widths, but the rule is the contract's).
"""

from __future__ import annotations

import contextlib
import math
import statistics
from dataclasses import fields
from typing import Dict, List

import numpy as np
import torch

from igs_bench.reference import lowp
from igs_bench.reference.core.camera import Camera
from igs_bench.reference.core.gaussians import Gaussians
from igs_bench.reference.ops.anchors import select_anchors
from igs_bench.reference.ops.rasterize import RasterSettings
from igs_bench.reference.stream import refine as ref_refine

REFINE_STEPS = 3
NUMBERS = ("anchors", "image", "cand_merge", "refine_loss",
           "refine_grad", "refine_step", "late_loss", "late_step",
           "train_loss", "train_grad", "train_step")
LEAVES = ref_refine.TRAINABLE


@contextlib.contextmanager
def strict_fp32():
    """Float32 products everywhere: TF32 off for matmuls and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def late_steps(refine_cfg: Dict, iters: int) -> List[int]:
    """The refine steps followed one at a time: each densify step and the
    last step."""
    rc = ref_refine.RefineConfig(**refine_cfg)
    return sorted({it for it in range(iters)
                   if ref_refine._densify_now(rc, it)} | {iters - 1})


def to_reference_gaussians(g) -> Gaussians:
    """Any object with the Gaussians fields → the reference's."""
    return Gaussians(**{f.name: getattr(g, f.name) for f in fields(Gaussians)})


def collate_tensors(dataset, idxs, device) -> Dict:
    """The collate() batch of items ``idxs``, its arrays as tensors."""
    batch = dataset.collate([dataset[i] for i in idxs])
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def batch_tensors(dataset, first: int, b: int, device) -> Dict:
    """The collate() batch of items [first, first + b) as tensors."""
    return collate_tensors(dataset, range(first, first + b), device)


def _cams(c2ws, fov, hw, device) -> Camera:
    return Camera.stack([Camera.from_c2w(np.asarray(c, np.float32),
                                         (float(fov[0]), float(fov[1])), hw,
                                         device=device) for c in c2ws])


class Reference:
    """The reference model and settings of one streaming configuration."""

    def __init__(self, model, cfg: Dict, device):
        self.model = model.eval()
        self.cfg = cfg
        self.device = device
        v, s = cfg["views"], cfg["stream"]
        h, w = v["output_hw"]
        self.settings = RasterSettings(image_height=h, image_width=w,
                                       outputs="color", clamp_grads=True)
        r = min(int(s["depth_view_res"]), h, w)
        self.depth_settings = RasterSettings(
            image_height=r, image_width=r, outputs="color_depth",
            clamp_grads=True)
        self.refine_settings = RasterSettings(image_height=h, image_width=w,
                                              outputs="color")

    @torch.no_grad()
    def window(self, dataset, w: int, start: Gaussians, depth: torch.Tensor
               ) -> Dict:
        """Anchors and eval images of window ``w`` (its depth carry renders
        too, as the program's forward does)."""
        s = self.cfg["stream"]
        b = int(s["eval_batch_size"])
        batch = batch_tensors(dataset, w * b, b, self.device)
        batch["depth"] = depth.expand((b,) + tuple(depth.shape[1:]))
        xyz = lowp.bf16(start.xyz) if lowp.active() else start.xyz
        anchors = select_anchors(
            xyz, batch["bounding_box"][0], valid=start.valid,
            anchor_size=int(s["anchor_size"]), k=int(s["neighbor_k"]),
            fps_buckets=int(s["fps_buckets"]))
        state = type(anchors)(*(x.expand((b,) + x.shape) for x in anchors))
        gs = start.map(lambda x: x.expand((b,) + x.shape))
        out = self.model(batch, state, gs, self.settings,
                         depth_settings=self.depth_settings, shared_cur=True)
        return {"anchors": anchors.anchor_idx,
                "images": out["images_pred"][:, 0],
                "xyz": out["3dgs"].xyz}

    def refine(self, dataset, key: int, state0, radius: float,
               before: Dict[int, object]) -> Dict:
        """The first ``REFINE_STEPS`` steps of the key frame's refine from
        ``state0`` (a RefineState of either package): losses, the first
        moment after one step, the leaves after the last; and each late
        step ``s`` from ``before[s]``, the program's state after step
        ``s - 1``: its loss and leaves."""
        cfg = ref_refine.RefineConfig(**self.cfg["refine"])
        iters = int(self.cfg["stream"]["refine_iterations"])
        data = dataset.get_refine_data(key)
        images = data["images"]
        h, w = np.asarray(images[0]).shape[-2:]
        gts = torch.as_tensor(np.stack(images), device=self.device).float()
        cams = _cams(data["c2ws"], data["FOV"], (h, w), self.device)
        bg = torch.as_tensor(np.asarray(data["bg"]), device=self.device)
        g0 = to_reference_gaussians(state0.gaussians)
        state = ref_refine.RefineState(
            gaussians=g0,
            adam_m={k: torch.zeros_like(getattr(g0, k)) for k in LEAVES},
            adam_v={k: torch.zeros_like(getattr(g0, k)) for k in LEAVES},
            step=0, max_radii2d=torch.zeros_like(state0.max_radii2d),
            xyz_grad_accum=torch.zeros_like(state0.xyz_grad_accum),
            denom=torch.zeros_like(state0.denom),
            generator=torch.Generator(device=self.device).manual_seed(0),
            overflow=torch.zeros((), dtype=torch.int32, device=self.device),
            init_valid=g0.valid.clone())
        order = ref_refine.view_order(iters, len(images))
        trace = refine_trace()
        ref_refine.refine_run(
            state, cams, gts, order, bg, cfg, self.refine_settings,
            float(radius), REFINE_STEPS, on_step=trace.on_step)
        out = trace.result(state0)
        out["late"] = {}
        for s, st in sorted(before.items()):
            # the split draws of the densify steps before s, as the
            # program's generator (seeded 0 at the refine's start) gave them
            gen = torch.Generator(device=self.device).manual_seed(0)
            n = st.gaussians.xyz.shape[0]
            for it in range(s):
                if ref_refine._densify_now(cfg, it):
                    for _ in range(2):
                        torch.randn((n, 3), generator=gen, device=self.device)
            late = refine_trace(late=(s,))
            ref_refine.refine_run(
                _to_reference_state(st, gen), cams, gts, order, bg, cfg,
                self.refine_settings, float(radius), s + 1,
                on_step=late.on_step, first=s)
            out["late"][s] = late.late[s]
        out["before"] = dict(before)
        return out


def _to_reference_state(st, generator) -> ref_refine.RefineState:
    return ref_refine.RefineState(
        gaussians=to_reference_gaussians(st.gaussians),
        adam_m=dict(st.adam_m), adam_v=dict(st.adam_v), step=int(st.step),
        max_radii2d=st.max_radii2d, xyz_grad_accum=st.xyz_grad_accum,
        denom=st.denom, generator=generator, overflow=st.overflow,
        init_valid=st.init_valid)


class refine_trace:
    """An ``on_step`` that keeps what the refine comparison reads: the
    first steps' losses, Adam's first moment after step 1 and the leaves
    after step ``REFINE_STEPS``; for each step of ``late`` its loss and the
    leaves after it, and the state before it (``before``)."""

    def __init__(self, late=()):
        self.late_at = set(late)
        self.losses: List = []
        self.m1 = self.p_last = None
        self.before: Dict[int, object] = {}
        self.late: Dict[int, Dict] = {}

    def on_step(self, it, state, metrics):
        if it < REFINE_STEPS:
            self.losses.append(metrics["loss"])
        if it == 0:
            self.m1 = dict(state.adam_m)
        if it == REFINE_STEPS - 1:
            self.p_last = {k: getattr(state.gaussians, k) for k in LEAVES}
        if it + 1 in self.late_at:
            self.before[it + 1] = state
        if it in self.late_at:
            self.late[it] = {
                "loss": metrics["loss"],
                "leaves": {k: getattr(state.gaussians, k) for k in LEAVES},
                "valid": state.gaussians.valid}

    def result(self, state0) -> Dict:
        return {"losses": [float(x) for x in self.losses],
                "m1": self.m1,
                "delta": None if self.p_last is None else {
                    k: self.p_last[k] - getattr(state0.gaussians, k)
                    for k in LEAVES},
                "before": self.before,
                "late": self.late}


def _leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> float:
    norms = {k: float(torch.linalg.norm(ref[k].double())) for k in keep}
    med = statistics.median(norms.values())
    return max(abs(float(torch.linalg.norm(prog[k].double())) - norms[k])
               / max(norms[k], med, 1e-30) for k in keep)


def _merged(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest over pairs of candidates of the reference's distance
    between the two over the program's."""
    worst = 0.0
    for i in range(prog.shape[0]):
        for j in range(i + 1, prog.shape[0]):
            d_prog = float(torch.linalg.norm((prog[i] - prog[j]).double()))
            d_ref = float(torch.linalg.norm((ref[i] - ref[j]).double()))
            worst = max(worst, d_ref / d_prog if d_prog > 0 else math.inf)
    return worst


def compare_window(prog: Dict, ref: Dict) -> Dict[str, float]:
    images = max(float(torch.sqrt(torch.mean(
        (p.double() - r.double()) ** 2)))
        for p, r in zip(prog["images"], ref["images"]))
    return {
        "anchors": float((prog["anchors"] != ref["anchors"]).double().mean()),
        "image": images,
        "cand_merge": _merged(prog["xyz"], ref["xyz"]),
    }


def compare_refine(prog: Dict, ref: Dict, beta1: float,
                   late: List[int]) -> Dict[str, float]:
    if prog["m1"] is None or prog["delta"] is None:  # fewer steps than read
        return {**dict.fromkeys(("refine_loss", "refine_grad", "refine_step",
                                 "late_loss", "late_step"), math.inf),
                "densified_rows": 0.0}
    g_ref = {k: v / (1 - beta1) for k, v in ref["m1"].items()}
    g_prog = {k: v / (1 - beta1) for k, v in prog["m1"].items()}
    gnorm = {k: float(torch.linalg.norm(g_ref[k].double())) for k in LEAVES}
    med = statistics.median(gnorm.values())
    keep = [k for k in LEAVES if gnorm[k] >= 1e-3 * med]
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    late_loss = late_step = 0.0
    densified = 0
    for s in late:
        p, r, b = (prog["late"].get(s), ref["late"].get(s),
                   prog["before"].get(s))
        if p is None or r is None or b is None:
            # the program never reached step s
            late_loss = late_step = float("inf")
            continue
        late_loss = max(late_loss, abs(float(p["loss"]) - float(r["loss"]))
                        / max(abs(float(r["loss"])), 1e-30))
        before = {k: getattr(b.gaussians, k) for k in keep}
        late_step = max(late_step, _leaf_gap(
            {k: p["leaves"][k] - before[k] for k in keep},
            {k: r["leaves"][k] - before[k] for k in keep}, keep))
        densified = max(densified, int(r["valid"].sum())
                        - int(b.gaussians.valid.sum()))
    return {"refine_loss": loss,
            "refine_grad": _leaf_gap(g_prog, g_ref, keep),
            "refine_step": _leaf_gap(prog["delta"], ref["delta"], keep),
            "late_loss": late_loss, "late_step": late_step,
            # rows the reference's densify added, for the record
            "densified_rows": float(densified)}


def worst_leaves(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 n: int = 5) -> List:
    """The ``n`` leaves of the largest norm gap: (name, gap, the
    reference's norm, the median leaf's), for the record."""
    norms = {k: float(torch.linalg.norm(v.double())) for k, v in ref.items()}
    med = statistics.median(norms.values())
    gaps = [(k, abs(float(torch.linalg.norm(prog[k].double())) - norms[k])
             / max(norms[k], med, 1e-30), norms[k], med) for k in ref]
    return sorted(gaps, key=lambda g: -g[1])[:n]


def compare_steps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """A training cell's numbers from the first steps of both sides, each
    ``{"losses": [...], "g1": {leaf: first gradient as the optimizer got
    it}, "delta": {leaf: change after the steps}}``: the largest relative
    gap of a step's loss, and the worst leaf's gap of the first gradient's
    norm and of the change's norm. Leaves whose reference gradient is
    under a thousandth of the median leaf's are left out."""
    gnorm = {k: float(torch.linalg.norm(v.double()))
             for k, v in ref["g1"].items()}
    med = statistics.median(gnorm.values())
    keep = [k for k in gnorm if gnorm[k] >= 1e-3 * med]
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    return {"train_loss": loss,
            "train_grad": _leaf_gap(prog["g1"], ref["g1"], keep),
            "train_step": _leaf_gap(prog["delta"], ref["delta"], keep)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in limits)
