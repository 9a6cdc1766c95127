"""Differential AGM-Net stage costs: the whole forward against truncated
forwards (motion and conditioning, then the triplane encoder, then the
residual decode).

    python -m igs_tpu_torch.tools.profile_agm_diff [--n 150000]
        [--anchors 8192] [--res 512] [--batch 5] [--K 4] [--iters 3]
        [--device cpu]

Counterpart of ``tools/tools_profile_agm_diff.py``: the scene, batch and
settings of ``bench_agm_bf16`` with the depth carry at 2^18 pairs, the
float32 network (seed 0), each function timed in inference mode with
``timeit_device(K=4, iters=3)``: ``motion+cond`` (the backbone on the
shared key frame, the motion transformer, the upsample, ModLN),
``..+triplane`` (the anchor Transformer1D: B7 on a card),
``..+interp_decode`` (the anchor interpolation and the residual MLPs)
and ``full fwd`` (the renders too). A stage's cost is the difference of
two neighbouring lines: the standalone stage timings do not add up to
the in-context whole.
"""

from __future__ import annotations

import sys

import torch

from igs_tpu_torch.models.renderer import interpolate_residuals
from igs_tpu_torch.tools.bench_agm_bf16 import (agm_args, agm_inputs,
                                                agm_model, settings_for)
from igs_tpu_torch.tools.probe import Probe, ms, parser


def main(argv=None) -> int:
    ap = parser(__doc__)
    agm_args(ap, K=4)
    args = ap.parse_args(argv)
    pr = Probe("profile_agm_diff", args)
    astate, gb, batch = agm_inputs(args, pr.dev)
    settings, depth = settings_for(args, 1 << 18)
    model = agm_model(args, pr.dev)

    def motion(bt):
        b, _, c, hh, ww = bt["cur_images_input"].shape
        nxt = bt["next_images_input"].reshape(-1, c, hh, ww)
        mo = model.motion_features(bt["cur_images_input"][0], nxt,
                                   cur_tile=b)
        return model.condition3d(mo, bt["local_rays"], bt["depth"])

    def triplane(bt):
        return model.triplane_encoder(motion(bt), astate.anchor_points,
                                      bt["FOV"], bt["c2w_input"])

    def decode(bt):
        return model.render(interpolate_residuals(triplane(bt), astate))

    def full(bt):
        return model(bt, astate, gb, settings, depth_settings=depth,
                     shared_cur=True)["images_pred"]

    for name, fn in (("motion+cond", motion), ("..+triplane", triplane),
                     ("..+interp_decode", decode), ("full fwd", full)):
        def run(bt, fn=fn):
            with torch.inference_mode():
                return fn(bt)

        pr.put(name, ms(run, batch, K=args.K, iters=args.iters))
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
