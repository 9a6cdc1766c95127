"""Time the segmented scan (kernel B3), the whole segmented reduction and
the scatter-add it replaces, at 16 and 32 lanes.

    python -m igs_tpu_torch.tools.bench_segscan_kernel [--device cpu]

Counterpart of ``tools/tools_bench_segscan_kernel.py``, with its inputs:
150 000 Gaussians of 0-5 pairs each (``RandomState(0)``) expanded into
2^19 slots, a seeded permutation of the slots, and per lane count a
(2^19, lanes) normal x. The port's layout is (lanes, pairs), so x is
transposed once, outside the timing. Three lines per lane count, timed
with ``timeit_device`` at K=16: ``segmented_scan`` (the kernel on the
card, its plain version with ``--device cpu``), the full chain
``segment_sum_sorted(x[:, perm], ids, last_row)``, and the scatter-add
as ``index_add_``. The kernels' launch counts go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from igs_tpu_torch.ops.segred import segment_sum_sorted, segmented_scan
from igs_tpu_torch.utils.devtime import timeit_device
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.profiling import kernel_launches


def make_inputs(n: int = 150_000, mp: int = 1 << 19):
    """(exp ids (mp,) i32, last row (n,) i32, perm (mp,) i32, rng) as the
    JAX tool draws them; the rng goes on to draw each lane count's x."""
    rng = np.random.RandomState(0)
    counts = rng.randint(0, 6, size=n)
    total = min(int(counts.sum()), mp)
    exp_gauss = np.full(mp, -1, np.int32)
    exp_gauss[:total] = np.repeat(np.arange(n), counts).astype(
        np.int32)[:total]
    ends = np.cumsum(counts) - 1
    last_row = np.where(counts > 0, np.minimum(ends, mp - 1), -1)
    base = np.cumsum(counts) - counts
    last_row = np.where(base < mp, last_row, -1).astype(np.int32)
    perm = rng.permutation(mp).astype(np.int32)
    return exp_gauss, last_row, perm, rng


def run(device=None, n: int = 150_000, mp: int = 1 << 19,
        lanes=(16, 32), K: int = 16, iters: int = 3):
    """{line label: seconds per call}, each line printed as it is timed."""
    dev = resolve_device(device)
    exp_gauss, last_row, perm, rng = make_inputs(n, mp)
    ids = torch.from_numpy(exp_gauss).to(dev)
    lr = torch.from_numpy(last_row).long().to(dev)
    perm_t = torch.from_numpy(perm).long().to(dev)
    rows = ids.clamp_min(0).long()
    out = {}
    for nl in lanes:
        x = torch.from_numpy(rng.normal(size=(mp, nl)).astype(
            np.float32)).to(dev).t().contiguous()
        for label, fn in (
                (f"segscan kernel (MP,{nl})",
                 lambda a: segmented_scan(a, ids)),
                (f"full segred chain (MP,{nl})",
                 lambda a: segment_sum_sorted(a.index_select(1, perm_t), ids,
                                              lr)),
                (f"scatter-add (MP,{nl})",
                 lambda a: torch.zeros((a.shape[0], n), device=a.device
                                       ).index_add_(1, rows, a))):
            out[label] = timeit_device(fn, x, K=K, iters=iters)
            print(f"{label}: {out[label] * 1e3:.4f} ms", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    run(args.device)
    print(f"kernel launches {json.dumps(kernel_launches())}",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
