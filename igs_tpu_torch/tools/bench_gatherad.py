"""The pair gather and its autograd transpose (a scatter-add) at scale,
measured and superseded on the TPU (kept as the evidence trail).

    python -m igs_tpu_torch.tools.bench_gatherad [--n 150000]
        [--pairs 524288] [--lanes 32] [--K 10] [--device cpu]

Counterpart of ``tools/tools_bench_gatherad.py``: 150 000 seeded normal
(N, 32) feature rows, 2^19 seeded random ids and (2^19, 32) normal
weights; each line times a scalar by ``timeit_device`` (K=10, 5 rounds),
under the JAX probe's names:

* ``gather fwd``: sum(feats[ids] · w);
* ``gather fwd+AD``: the sum of its gradient with respect to the
  features, through autograd (``index_select``'s backward is an
  ``index_add_``), where the JAX probe takes ``jax.grad``;
* ``sorted segsum``: the sorted alternative for that transpose, the
  weights summed over the runs of the ids sorted. The JAX probe calls
  ``jax.ops.segment_sum``; the port's nearest library call is
  ``torch.segment_reduce(..., "sum", lengths=)`` (no kernel of the port
  runs: the JSON's ``launches`` is empty and ``kernel`` says so).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from igs_tpu_torch.tools.bench_scatter import (contiguous_runs,
                                               segment_sum_lengths)
from igs_tpu_torch.tools.probe import Probe, ms, parser


def gather_fwd(feats, ids, w):
    return torch.sum(feats[ids] * w)


def gather_grad(feats, ids, w):
    """d gather_fwd / d feats, through autograd."""
    with torch.enable_grad():
        f = feats.detach().requires_grad_(True)
        return torch.autograd.grad(gather_fwd(f, ids, w), f)[0]


def inputs(n: int, pairs: int, lanes: int):
    """The JAX probe's seeded features (n, lanes), ids (pairs,) and
    weights (pairs, lanes)."""
    rng = np.random.RandomState(0)
    feats = rng.randn(n, lanes).astype(np.float32)
    ids = rng.randint(0, n, pairs).astype(np.int32)
    w = rng.randn(pairs, lanes).astype(np.float32)
    return feats, ids, w


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--pairs", type=int, default=1 << 19)
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--K", type=int, default=10)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    pr = Probe("bench_gatherad", args)
    dev = pr.dev
    feats_np, ids_np, w_np = inputs(args.n, args.pairs, args.lanes)
    feats, w = (torch.from_numpy(a).to(dev) for a in (feats_np, w_np))
    ids = torch.from_numpy(ids_np.astype(np.int64)).to(dev)
    lengths = torch.from_numpy(contiguous_runs(ids_np, args.n)[0]).to(dev)
    k = dict(K=args.K, iters=args.iters)
    pr.put("gather fwd", ms(lambda f: gather_fwd(f, ids, w), feats, **k))
    pr.put("gather fwd+AD", ms(
        lambda f: torch.sum(gather_grad(f, ids, w)), feats, **k))
    pr.put("sorted segsum", ms(
        lambda f: torch.sum(segment_sum_lengths(w, lengths)) + f[0, 0],
        feats, **k))
    pr.put("kernel", "none of the port's: PyTorch calls only")
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
