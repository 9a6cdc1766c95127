"""The triplane attention's forward kernel at three tiles, float32 and
bf16, timed with K = 16 (the round-4 probe at the triplane shape).

    python -m igs_tpu_torch.tools.bench_attn2 [--shape 5 8 8192 64]
        [--K 16] [--iters 3] [--device cpu]

Counterpart of ``tools/tools_bench_attn2.py`` (inputs from
``RandomState(0)``, scale C^-½, ``timeit_device(K=16, iters=3)``, each
line's largest error against the first line's output). The JAX probe's
three ``BlockSizes`` become the port's three tile instantiations of B7
(``ops.attention.TILES``); its bf16 lines cast the inputs inside the
timed function, and so do these (the cast is timed with the kernel). On
``--device cpu`` every line runs the plain version.
"""

from __future__ import annotations

import sys

import torch

from igs_tpu_torch.ops.attention import TILES
from igs_tpu_torch.tools.bench_attn import forward, inputs
from igs_tpu_torch.tools.probe import Probe, ms, parser


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--shape", type=int, nargs=4, default=[5, 8, 8192, 64],
                    metavar=("B", "H", "L", "C"))
    ap.add_argument("--K", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    pr = Probe("bench_attn2", args)
    q, k, v = inputs(tuple(args.shape), 0, pr.dev)
    scale = args.shape[-1] ** -0.5
    ref = None
    for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for bq, bk in TILES:
            def fn(q_, k_, v_, block=(bq, bk), dtype=dtype):
                return forward(q_.to(dtype), k_.to(dtype), v_.to(dtype),
                               scale, block).float()

            out = fn(q, k, v)
            if ref is None:
                ref = out
            pr.put(f"{label} {bq}x{bk}", {
                "ms": ms(fn, q, k, v, K=args.K, iters=args.iters),
                "max_abs_err": float((out - ref).abs().max())})
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
