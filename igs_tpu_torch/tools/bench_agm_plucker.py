"""A/B the condition3D ray paths: ``local_ray`` True (4 channels) against
the shipped False (Plücker rays through two degree-3 real SH, 33
channels) on the AGM-Net forward at the production shape.

    python -m igs_tpu_torch.tools.bench_agm_plucker [--n 150000]
        [--anchors 8192] [--res 512] [--batch 5] [--K 8] [--iters 3]
        [--device cpu]

Counterpart of ``tools/tools_bench_agm_plucker.py``: its
``production_batch`` (150 000 Gaussians in [-1.5, 1.5]³ with DC-only
colour, 8192 anchors, B = 5 candidates of 4 views at 512² on the z axis
at -4, Plücker ``rays`` and ``local_rays``, all from ``RandomState(0)``
in its order), the packed route at 512² (2^19 pairs) with the 128² depth
settings, the three bf16 flags on, ``shared_cur`` and
``shared_window_pairs``; each model from the same seeded weights, timed
in inference mode with ``timeit_device(K=8, iters=3)``. The first call
of each is timed apart as the counterpart of the JAX probe's compile
time.

One repair (ROADMAP C43): the JAX probe's batch gives the eval view
alone as output (``c2w_output = c2w[:, :1]``), so the forward's
depth-carry render gets no view and fails in both packages (a zero-size
slice in JAX, an empty camera stack here). The outputs here are the
eval view and the 4 input views as the depth carry, as in the other AGM
probes' batch.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.ops.anchors import select_anchors
from igs_tpu_torch.tools.bench_agm_bf16 import (agm_args, agm_model,
                                                settings_for)
from igs_tpu_torch.tools.probe import Probe, ms, parser


def production_batch(args, dev, v=4, seed=0):
    """The JAX probe's batch, anchor state and Gaussians as B
    candidates."""
    from igs_tpu_torch.roofline import windowed

    b, hw, n = args.batch, args.res, args.n
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    opacity = rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    scaling = rng.uniform(-4.5, -3.0, (n, 3)).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1, 1, (n, 3))
    g = Gaussians.create(xyz, opacity, rot, scaling, shs, device=dev)
    bbox = torch.tensor([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], device=dev)
    state1 = select_anchors(g.xyz, bbox, valid=g.valid,
                            anchor_size=args.anchors, k=8)
    state, gaussians = windowed(state1, g, b)
    c2w = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    c2w[:, :, 2, 3] = -4.0
    h8 = hw // 8 * 2

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    batch = {
        "cur_images_input": t(rng.uniform(0, 1, (b, v, 3, hw, hw))),
        "next_images_input": t(rng.uniform(0, 1, (b, v, 3, hw, hw))),
        "depth": t(rng.uniform(2, 6, (b, v, hw, hw))),
        "local_rays": t(rng.normal(size=(b, h8, h8, 3))),
        "rays": t(rng.normal(size=(b, v, h8, h8, 6))),
        "FOV": t(np.full((b, 2), 0.8)),
        "c2w_input": t(c2w),
        "c2w_output": t(np.concatenate([c2w[:, :1], c2w], axis=1)),
        "background_color": t(np.zeros((b, 3))),
    }
    return batch, state, gaussians


def main(argv=None) -> int:
    ap = parser(__doc__)
    agm_args(ap, K=8)
    args = ap.parse_args(argv)
    pr = Probe("bench_agm_plucker", args)
    batch, state, gaussians = production_batch(args, pr.dev)
    settings, depth = settings_for(args, 1 << 16, max_per_tile=4096)
    for local_ray in (True, False):
        model = agm_model(args, pr.dev, local_ray=local_ray,
                          encoder_bf16=True, cnn_bf16=True, ft_bf16=True)

        def fwd(bt, model=model):
            with torch.inference_mode():
                return model(bt, state, gaussians, settings,
                             depth_settings=depth, shared_cur=True,
                             shared_window_pairs=True)["images_pred"]

        t0 = time.perf_counter()
        fwd(batch)
        if pr.dev.type == "cuda":
            torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        pr.put(f"local_ray={local_ray}", {
            "ms": ms(fwd, batch, K=args.K, iters=args.iters),
            "first_call_s": first_s})
        del model
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
