"""Cost model of the per-pair → per-Gaussian gradient reduction: the
scatter-add it replaces and the pieces of the segmented reduction the
port ships (a permutation gather, an argsort, a boundary gather, and the
segmented scan, kernel B3).

    python -m igs_tpu_torch.tools.bench_segred [--n 150000]
        [--max-pairs 524288] [--K 16] [--device cpu]

Counterpart of ``tools/tools_bench_segred.py`` (150 000 Gaussians,
2^19 pairs, 16 lanes, ``RandomState(0)``: normal grads, uniform ids, a
permutation, 150 000 sorted boundary rows). The port's layout is
(lanes, pairs). Lines: a scalar op (the timer's floor), ``index_add_``
(16, MP) → (16, N), a 16-lane permutation gather, an int64 argsort of
the ids, the boundary gather, and, beyond the TPU probe, the segmented
scan itself over the ids sorted (``segmented_scan``, the kernel on a
card). Each is ``timeit_device`` at ``K`` calls.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from igs_tpu_torch.ops.segred import segmented_scan
from igs_tpu_torch.tools.probe import Probe, ms, parser


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--max-pairs", type=int, default=1 << 19)
    ap.add_argument("--K", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    pr = Probe("bench_segred", args)
    dev = pr.dev
    n, mp, lanes = args.n, args.max_pairs, 16
    rng = np.random.RandomState(0)
    dpair = torch.from_numpy(rng.normal(size=(lanes, mp)).astype(
        np.float32)).to(dev)
    gid_np = rng.randint(0, n, size=(mp,))
    gid = torch.from_numpy(gid_np).to(dev)
    perm = torch.from_numpy(rng.permutation(mp)).to(dev)
    brow = torch.from_numpy(np.sort(rng.choice(mp, size=n, replace=False))
                            ).to(dev)
    ids_sorted = torch.from_numpy(np.sort(gid_np).astype(np.int32)).to(dev)
    k = dict(K=args.K, iters=args.iters)
    pr.put("noop-ish (scalar)", ms(lambda s: s * 2.0,
                                   torch.zeros((), device=dev), **k))
    pr.put("scatter-add (16,MP)->(16,N)", ms(
        lambda d: torch.zeros((lanes, n), device=dev).index_add_(1, gid, d),
        dpair, **k))
    pr.put("row gather (16,MP) perm", ms(
        lambda d: torch.index_select(d, 1, perm), dpair, **k))
    pr.put("argsort (MP,)", ms(
        lambda s: torch.argsort(gid + s.to(torch.int64)),
        torch.zeros((), device=dev), **k))
    pr.put("boundary gather (16, N of MP)", ms(
        lambda d: torch.index_select(d, 1, brow), dpair, **k))
    pr.put("segmented scan (16,MP)", ms(
        lambda d: segmented_scan(d, ids_sorted), dpair, **k))
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
