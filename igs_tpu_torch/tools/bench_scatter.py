"""Scatter-add alternatives for the blend backward's pair → Gaussian
reduce, measured and rejected on the TPU (kept as the evidence trail).

    python -m igs_tpu_torch.tools.bench_scatter [--n 150000]
        [--pairs 655360] [--lanes 16] [--K 8] [--device cpu]

Counterpart of ``tools/tools_bench_scatter.py``: (2^19 + 131 072, 16)
seeded normal per-pair grads reduced into 150 000 rows by seeded random
ids, in five forms, each timed by ``timeit_device`` (K=8, 3 rounds), under
the JAX probe's names:

* ``at[].add (16)``: ``index_add_`` over the 16 lanes, the JAX probe's
  ``.at[gid].add``;
* ``at[].add 8+8``: two ``index_add_`` of 8 lanes each;
* ``at[].add pad→32``: the grads padded to 32 lanes, one ``index_add_``;
* ``segsum sorted ids``: the sorted segment sum over the ids sorted (the
  grads in their own order, as the JAX probe sums them: a cost probe of
  the contiguous layout). The JAX probe calls ``jax.ops.segment_sum``
  with ``indices_are_sorted``; the port's nearest library call is
  ``torch.segment_reduce(..., "sum", lengths=)`` over the runs' lengths.
  The port's own sorted reduction (``ops/segred.segment_sum_sorted``,
  the segmented scan B3) is timed by ``bench_binning3`` and
  ``bench_segred``; here no kernel of the port runs;
* ``cumsum+boundaries``: one ``cumsum`` over the pairs and the
  difference at each run's bounds (empty runs 0).

No form launches a kernel of the port (the JSON's ``launches`` is empty
and ``kernel`` says so). ``max_abs_vs_16`` holds each scatter form
against the first, ``cumsum_vs_segsum_max_abs`` the two sorted forms
against each other (the cumsum's f32 rounding grows with the run's
offset).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from igs_tpu_torch.tools.probe import Probe, ms, parser


def index_add_16(dfe, gid, n: int):
    return torch.zeros((n, dfe.shape[1]), device=dfe.device).index_add_(
        0, gid, dfe)


def index_add_8x2(dfe, gid, n: int):
    half = dfe.shape[1] // 2
    lo = torch.zeros((n, half), device=dfe.device).index_add_(
        0, gid, dfe[:, :half])
    hi = torch.zeros((n, dfe.shape[1] - half), device=dfe.device).index_add_(
        0, gid, dfe[:, half:])
    return torch.cat([lo, hi], dim=1)


def index_add_pad32(dfe, gid, n: int):
    lanes = dfe.shape[1]
    padded = torch.nn.functional.pad(dfe, (0, 32 - lanes))
    return torch.zeros((n, 32), device=dfe.device).index_add_(
        0, gid, padded)[:, :lanes]


def segment_sum_lengths(dfe, lengths):
    """Sums of the consecutive runs of ``dfe``'s rows, ``lengths[s]`` rows
    for run s (0 for an empty run)."""
    return torch.segment_reduce(dfe, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def cumsum_boundaries(dfe, base, ends, has):
    """The same sums as ``segment_sum_lengths`` from one cumsum: run s
    spans rows [base[s], ends[s]]."""
    c = torch.cumsum(dfe, dim=0)
    c = torch.cat([torch.zeros((1, dfe.shape[1]), device=dfe.device), c])
    return torch.where(has[:, None], c[ends + 1] - c[base],
                       torch.zeros((), device=dfe.device))


def contiguous_runs(gid: np.ndarray, n: int):
    """(lengths, base, ends, has) of the runs that ``np.sort(gid)`` makes,
    one a row of ``n``, as the JAX probe builds them."""
    lengths = np.zeros(n, np.int64)
    np.add.at(lengths, np.sort(gid), 1)
    ends_excl = np.cumsum(lengths)
    return lengths, ends_excl - lengths, ends_excl - 1, lengths > 0


def inputs(n: int, pairs: int, lanes: int):
    """The JAX probe's seeded grads (pairs, lanes) and ids (pairs,)."""
    rng = np.random.RandomState(0)
    dfe = rng.normal(size=(pairs, lanes)).astype(np.float32)
    gid = rng.randint(0, n, size=(pairs,)).astype(np.int32)
    return dfe, gid


SCATTER = {"at[].add (16)": index_add_16, "at[].add 8+8": index_add_8x2,
           "at[].add pad→32": index_add_pad32}


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--pairs", type=int, default=(1 << 19) + 131072)
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    pr = Probe("bench_scatter", args)
    dev, n = pr.dev, args.n
    dfe_np, gid_np = inputs(n, args.pairs, args.lanes)
    dfe = torch.from_numpy(dfe_np).to(dev)
    gid = torch.from_numpy(gid_np.astype(np.int64)).to(dev)
    lengths, base, ends, has = (torch.from_numpy(a).to(dev)
                                for a in contiguous_runs(gid_np, n))
    k = dict(K=args.K, iters=args.iters)
    print(f"pair→gaussian reduce, {args.pairs} pairs × {args.lanes} lanes "
          f"→ {n} rows:", flush=True)
    ref = index_add_16(dfe, gid, n)
    diffs = {}
    for name, fn in SCATTER.items():
        pr.put(name, ms(lambda d, f=fn: f(d, gid, n), dfe, **k))
        diffs[name] = float((fn(dfe, gid, n) - ref).abs().max())
    pr.put("segsum sorted ids", ms(
        lambda d: segment_sum_lengths(d, lengths), dfe, **k))
    pr.put("cumsum+boundaries", ms(
        lambda d: cumsum_boundaries(d, base, ends, has), dfe, **k))
    pr.put("max_abs_vs_16", diffs)
    pr.put("cumsum_vs_segsum_max_abs", float(
        (cumsum_boundaries(dfe, base, ends, has)
         - segment_sum_lengths(dfe, lengths)).abs().max()), "")
    pr.put("kernel", "none of the port's: PyTorch calls only")
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
