"""Pair expansion, 150 000 Gaussians into 2^19 slots, three ways:
``repeat_interleave``, a scatter of each row's first slot then a
running maximum, and a scatter-add of start flags then a running sum.

    python -m igs_tpu_torch.tools.bench_expand [--n 150000]
        [--max-pairs 524288] [--K 16] [--device cpu]

Counterpart of ``tools/tools_bench_expand.py``: tiles touched drawn
``poisson(2.85)`` clipped to 40 (about 428 000 pairs), five int32
payload columns a Gaussian, ``RandomState(0)``. Each construction gives
the payload row of every slot; the lines check each against the repeat
on the live slots, then time it with ``timeit_device`` (a float salt
carries the timer's salt into the int payload, as the JAX probe's).
``scatter`` with ``reduce="amax"`` stands for JAX's ``.at[].max`` and
``index_add_`` for ``.at[].add``. The running sum counts the non-empty
rows before a slot, not the row index, so where empty rows fall between
it reads another row's payload and its check says False, as the JAX
probe's does. No kernel runs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from igs_tpu_torch.tools.probe import Probe, ms, parser


def via_repeat(s, p, t, max_pairs):
    p = p + s.to(torch.int32)
    out = torch.repeat_interleave(p, t, dim=0)[:max_pairs]
    pad = max_pairs - out.shape[0]
    # jnp.repeat's total_repeat_length pads with the last row
    return torch.cat([out, p[-1:].expand(max(pad, 0), -1)]) if pad > 0 \
        else out


def _starts(t, max_pairs):
    off = torch.cumsum(t, 0)
    base = off - t
    return torch.clamp(base, 0, max_pairs - 1)


def via_scatter_cummax(s, p, t, max_pairs):
    p = p + s.to(torch.int32)
    n = t.shape[0]
    marks = torch.where(t > 0, torch.arange(n, device=t.device),
                        torch.full_like(t, -1))
    start = torch.full((max_pairs,), -1, dtype=torch.int64, device=t.device)
    start.scatter_reduce_(0, _starts(t, max_pairs), marks, reduce="amax")
    gid = torch.cummax(start, 0).values
    return p[torch.clamp(gid, 0, n - 1)]


def via_scatter_cumsum(s, p, t, max_pairs):
    p = p + s.to(torch.int32)
    n = t.shape[0]
    flags = torch.zeros(max_pairs, device=t.device).index_add_(
        0, _starts(t, max_pairs), (t > 0).float())
    gid = torch.cumsum(flags, 0).to(torch.int64) - 1
    return p[torch.clamp(gid, 0, n - 1)]


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--max-pairs", type=int, default=1 << 19)
    ap.add_argument("--K", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    pr = Probe("bench_expand", args)
    n, mp = args.n, args.max_pairs
    rng = np.random.RandomState(0)
    tt = np.clip(rng.poisson(2.85, n), 0, 40).astype(np.int64)
    packed = rng.randint(0, 1 << 20, (n, 5)).astype(np.int32)
    t = torch.from_numpy(tt).to(pr.dev)
    p = torch.from_numpy(packed).to(pr.dev)
    s0 = torch.zeros((), device=pr.dev)
    total = int(min(tt.sum(), mp))
    ref = via_repeat(s0, p, t, mp)
    pr.put("live_slots", total, "")
    for name, fn in (("repeat_interleave", via_repeat),
                     ("scatter+cummax", via_scatter_cummax),
                     ("index_add+cumsum", via_scatter_cumsum)):
        same = bool(torch.equal(fn(s0, p, t, mp)[:total], ref[:total]))
        pr.put(name, {"matches_repeat": same,
                      "ms": ms(lambda s, f=fn: f(s, p, t, mp), s0, K=args.K,
                               iters=args.iters)})
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
