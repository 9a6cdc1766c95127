"""The work of AGM-Net's forward at a cell's shapes, counted once on the
meta device over the plain reference built with the configuration's
compute types: the model FLOPs (``torch.utils.flop_counter``, two a
multiply-add) and each attention call's least time on the card.

Attention's work is the port's own reckoning (``chip_smoke.
attention_bounds``): a forward reads q, k, v and writes o and the row
log-sum-exp, and does two products of 2·C operations a (query, key) pair,
the pairs being those its region ids let through. bf16 runs against the
tensor cores' bf16 rate; float32 against three TF32 products a product
(the least time at float32 accuracy).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from igs_bench import peaks
from igs_bench.reference.ops import attention as ref_attention


def attention_bounds(shape, pairs: int, esz: int) -> Dict[str, float]:
    """The least times (s) of the forward and the backward on (B, H, L, C)
    inputs of ``esz``-byte entries with ``pairs`` (query, key) pairs."""
    b, h, length, c = shape
    n = b * h * length * c
    rows = 4 * b * h * length
    work = {"fwd": (4 * esz * n + rows, 4 * c * pairs),
            "bwd": (8 * esz * n + rows, 10 * c * pairs)}
    out = {}
    for key, (nbytes, ops) in work.items():
        if esz == 2:
            out[key], out[key + "_by"] = peaks.bound_s(
                nbytes, ops, peaks.BF16_TC_FLOPS)
        else:
            out[key], out[key + "_by"] = peaks.bound_s(
                nbytes, 3 * ops, peaks.TF32_TC_FLOPS)
    return out


def agm_forward_work(model, batch: Dict[str, torch.Tensor], anchors,
                     shared_cur: bool, backward: bool = False
                     ) -> Tuple[float, List[tuple]]:
    """(FLOPs, attention calls) of the network part of one AGM-Net
    forward (CNN, transformers, condition, triplane encoder, decoder) on
    ``batch``, with ``backward`` its backward too; the renders are not
    model FLOPs. ``anchors``: an ``AnchorState`` with a leading batch
    axis."""
    from igs_bench.reference.models.renderer import interpolate_residuals

    b, v, c, hh, ww = batch["cur_images_input"].shape
    nxt = batch["next_images_input"].reshape(-1, c, hh, ww)
    calls: list = []
    with FlopCounterMode(display=False) as counter, \
            ref_attention.record(calls), torch.set_grad_enabled(backward):
        if shared_cur and b > 1:
            motion = model.motion_features(batch["cur_images_input"][0], nxt,
                                           cur_tile=b)
        else:
            motion = model.motion_features(
                batch["cur_images_input"].reshape(-1, c, hh, ww), nxt)
        ray_key = "local_rays" if model.local_ray else "rays"
        motion = model.condition3d(motion, batch[ray_key], batch["depth"])
        tri = model.triplane_encoder(motion, anchors.anchor_points,
                                     batch["FOV"], batch["c2w_input"])
        res = model.render(interpolate_residuals(tri, anchors))
        if backward:
            sum(r.float().sum() for r in res.values()).backward()
    return float(counter.get_total_flops()), calls


def attention_bound_s(calls: List[tuple], direction: str = "fwd") -> float:
    """The summed least time of the recorded calls, in seconds."""
    total = 0.0
    for shape, pairs, dtype in calls:
        esz = 2 if dtype == torch.bfloat16 else 4
        total += attention_bounds(shape, pairs, esz)[direction]
    return total
