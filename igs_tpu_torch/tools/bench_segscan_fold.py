"""Time the segscan layout probes (kernel B6) and their library yardstick.

    python -m igs_tpu_torch.tools.bench_segscan_fold [--device cpu]

Counterpart of ``tools/tools_bench_segscan_fold.py:main``: the same x,
``np.random.RandomState(0).normal(size=(2**19, 16))`` as float32, the
same three lines (copy through the folded (·, 128) view, copy through
the (·, 16) rows, folded + unfold reshape), timed with ``timeit_device``
at K=16, and one more line: ``torch.mul(x, 2.0)``, the one PyTorch call
that computes the same function. On the card the variants are the
kernels of ``csrc/segscan_fold.cu``; with ``--device cpu`` their plain
versions. The kernels' launch counts go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from igs_tpu_torch.tools import segscan_fold
from igs_tpu_torch.utils.devtime import timeit_device
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.profiling import kernel_launches

LINES = (
    ("copy folded (DMA ceiling)", segscan_fold.copy_folded),
    ("copy padded (MP,16)", segscan_fold.copy_padded),
    ("folded + in-kernel unfold reshape", segscan_fold.reshape),
    ("torch.mul(x, 2.0)", segscan_fold.library_mul),
)


def make_input(mp: int = 1 << 19, lanes: int = 16) -> np.ndarray:
    return np.random.RandomState(0).normal(size=(mp, lanes)).astype(
        np.float32)


def run(device=None, mp: int = 1 << 19, K: int = 16, iters: int = 3):
    """{line label: seconds per call}, each line printed as it is timed."""
    dev = resolve_device(device)
    x = torch.from_numpy(make_input(mp)).to(dev)
    out = {}
    for label, fn in LINES:
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
