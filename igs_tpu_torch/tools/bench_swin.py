"""The swin feature transformer through the attention kernel against the
same network through the plain attention, at the production shape.

    python -m igs_tpu_torch.tools.bench_swin [--shape 40 128 64 64]
        [--layers 6] [--K 1] [--iters 5] [--device cpu]

Counterpart of ``tools/tools_bench_swin.py``: ``FeatureTransformer`` of
6 layers at d_model 128 on two (40, 128, 64, 64) feature maps from
``RandomState(0)`` (40 images: 5 candidates × 4 views, the pair
concatenated both ways inside), 2×2 split windows of 1024 tokens, shift
on the odd layers; weights seeded (``init_weights``, seed 0). It times
the network with ``ops.attention.attention`` as the package calls it
(B7 on a card) and again with the plain version (``attention_plain``)
swapped in for this process only, by ``unittest.mock.patch`` of the name
``igs_tpu_torch.models.swin.attention``; the JAX probe's
``IGS_TPU_NO_FLASH`` has no counterpart in the port. Both in inference
mode; the median of ``iters`` rounds of K + 1 calls. It holds the two
outputs to the JAX probe's bound, max|d| / max|x| < 2e-3 on the first
map, and exits 1 if they are further apart.
"""

from __future__ import annotations

import sys
from unittest import mock

import numpy as np
import torch

from igs_tpu_torch.models import swin
from igs_tpu_torch.models.networks import init_weights
from igs_tpu_torch.ops.attention import attention_plain
from igs_tpu_torch.tools.probe import Probe, ms, parser

TOL_REL = 2e-3


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--shape", type=int, nargs=4, default=[40, 128, 64, 64],
                    metavar=("B", "C", "H", "W"))
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--K", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    pr = Probe("bench_swin", args)
    b, c, h, w = args.shape
    rng = np.random.RandomState(0)
    f0, f1 = (torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32))
              .to(pr.dev) for _ in range(2))
    ft = swin.FeatureTransformer(num_layers=args.layers, d_model=c)
    init_weights(ft, torch.Generator().manual_seed(0))
    ft = ft.to(pr.dev).eval()

    def apply(a, b_):
        with torch.inference_mode():
            return ft(a, b_, attn_num_splits=2)

    t = dict(K=args.K, iters=args.iters)
    o_kernel = apply(f0, f1)
    pr.put("kernel", ms(apply, f0, f1, **t))
    with mock.patch.object(swin, "attention", attention_plain):
        o_plain = apply(f0, f1)
        pr.put("plain", ms(apply, f0, f1, **t))
    d0 = float((o_kernel[0] - o_plain[0]).abs().max())
    s0 = float(o_plain[0].abs().max())
    pr.put("max|d|/max|x|", d0 / s0, unit="")
    pr.put("ok", d0 / s0 < TOL_REL)
    pr.write()
    return 0 if pr.results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
