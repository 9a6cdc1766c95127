"""A/B the per-module bf16 flags on the full AGM-Net forward.

    python -m igs_tpu_torch.tools.bench_agm_bf16 [--n 150000]
        [--anchors 8192] [--res 512] [--batch 5] [--K 4] [--iters 3]
        [--device cpu]

Counterpart of ``tools/tools_bench_agm_bf16.py``: 150 000 Gaussians and
the AGM batch drawn from ``RandomState(0)`` in the JAX probe's order
(``roofline.scene``, ``roofline.agm_batch``: B = 5 candidates of 4
input views at 512², the eval view and 4 depth-carry views), 8192
anchors, the packed route at 512² (2^19 pairs, windows of 1024) and the
128² depth carry (2^16 pairs, colour and depth), ``shared_cur``. Five
flag sets (none, ``ft_bf16``, ``encoder_bf16``, ``cnn_bf16``, all
three), each model from the same seeded weights (``build_model``, seed
0), timed in inference mode with ``timeit_device(K=4, iters=3)``; each
line reports max|Δ images_pred| against the float32 one. The attention
of ``encoder_bf16`` and ``ft_bf16`` is B7 in bf16 on a card.
``--channels``, ``--heads`` and ``--head-dim`` narrow the network (the
tests' tiny shape); the defaults are the JAX probe's.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from igs_tpu_torch.builders import build_model
from igs_tpu_torch.ops.anchors import select_anchors
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.roofline import agm_batch, scene, windowed
from igs_tpu_torch.tools.probe import Probe, ms, parser

FLAG_SETS = (("f32 baseline", {}),
             ("ft_bf16", {"ft_bf16": True}),
             ("encoder_bf16", {"encoder_bf16": True}),
             ("cnn_bf16", {"cnn_bf16": True}),
             ("all three", {"ft_bf16": True, "encoder_bf16": True,
                            "cnn_bf16": True}))


def agm_args(ap: argparse.ArgumentParser, K: int) -> None:
    """The AGM probes' sizes: the JAX probes' scene, batch and network."""
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--anchors", type=int, default=8192)
    ap.add_argument("--res", type=int, default=512,
                    help="the input views' and the eval view's side")
    ap.add_argument("--depth-res", type=int, default=128)
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--K", type=int, default=K)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=64)


def agm_system(args, **flags) -> dict:
    """The system section of a network at the probe's widths."""
    return {"backbone": {"feature_channels": args.channels},
            "triplane_encoder": {"unet": {
                "num_attention_heads": args.heads,
                "attention_head_dim": args.head_dim}}, **flags}


def agm_model(args, dev, **flags):
    return build_model(agm_system(args, **flags), device=dev,
                       generator=torch.Generator().manual_seed(0))


def settings_for(args, depth_pairs: int, max_per_tile: int = 1024):
    """The eval view's packed settings and the depth carry's."""
    settings = RasterSettings(
        image_height=args.res, image_width=args.res, impl="pallas_packed",
        max_pairs=1 << 19, max_per_tile=max_per_tile, chunk=128,
        clamp_grads=True, outputs="color")
    depth = settings._replace(
        image_height=args.depth_res, image_width=args.depth_res,
        max_pairs=depth_pairs, max_per_tile=512, outputs="color_depth")
    return settings, depth


def agm_inputs(args, dev):
    """(anchor state, Gaussians) as B candidates, and the batch, drawn
    from ``RandomState(0)`` as the JAX probes draw them."""
    rng = np.random.RandomState(0)
    g = scene(args.n, rng, dev)
    bbox = torch.tensor([[-2.0, -2, -2], [2.0, 2, 2]], device=dev)
    state1 = select_anchors(g.xyz, bbox, valid=g.valid,
                            anchor_size=args.anchors, k=8)
    astate, gb = windowed(state1, g, args.batch)
    return astate, gb, agm_batch(args.batch, args.res, rng, dev)


def main(argv=None) -> int:
    ap = parser(__doc__)
    agm_args(ap, K=4)
    args = ap.parse_args(argv)
    pr = Probe("bench_agm_bf16", args)
    astate, gb, batch = agm_inputs(args, pr.dev)
    settings, depth = settings_for(args, 1 << 16)
    ref = None
    for name, flags in FLAG_SETS:
        model = agm_model(args, pr.dev, **flags)

        def fwd(bt, model=model):
            with torch.inference_mode():
                return model(bt, astate, gb, settings, depth_settings=depth,
                             shared_cur=True)["images_pred"]

        img = fwd(batch).float()
        if ref is None:
            ref = img
        pr.put(name, {"ms": ms(fwd, batch, K=args.K, iters=args.iters),
                      "max|dimg|": float((img - ref).abs().max())})
        del model
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
