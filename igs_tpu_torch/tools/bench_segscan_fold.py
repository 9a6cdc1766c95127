"""Time the segscan layout probes (kernel B6) and their library yardstick.

    python -m igs_tpu_torch.tools.bench_segscan_fold [--device cpu]

Counterpart of ``tools/tools_bench_segscan_fold.py:main``: the same x,
``np.random.RandomState(0).normal(size=(2**19, 16))`` as float32, the
same three lines (copy through the folded (·, 128) view, copy through
the (·, 16) rows, folded + unfold reshape), timed with ``timeit_device``
at K=16, and one more line: ``torch.mul(x, 2.0)``, the one PyTorch call
that computes the same function. On the card the variants are the
kernels of ``csrc/segscan_fold.cu``; with ``--device cpu`` their plain
versions.

On the card four more lines follow, one per line above: the L2-cold,
graph-replayed reading (``cold_readings``): a rotation of ``ROTATION``
inputs made like x with seeds 1, 2, ... (128 MiB, past the 50 MB L2),
``devtime.rotation_ms`` in interleaved rounds, the median per call of the
CUDA-graph replays with their spread, the eager median and the share of
the bytes bound. The program fails if any reading, eager or replayed,
puts that share above ``MAX_BOUND_SHARE``: no chip moves the bytes faster
than its memory, so such a reading is a timing fault. The kernels' launch
counts go to stderr (the cold readings add one launch per captured call,
none per replay).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from igs_tpu_torch.tools import segscan_fold
from igs_tpu_torch.utils.devtime import rotation_ms, timeit_device
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.h100 import bound
from igs_tpu_torch.utils.profiling import kernel_launches

LINES = (
    ("copy folded (DMA ceiling)", segscan_fold.copy_folded),
    ("copy padded (MP,16)", segscan_fold.copy_padded),
    ("folded + in-kernel unfold reshape", segscan_fold.reshape),
    ("torch.mul(x, 2.0)", segscan_fold.library_mul),
)
MAX_BOUND_SHARE = 1.05  # a reading faster than this is a timing fault
ROTATION = 4  # distinct inputs the cold readings walk: 4 × 32 MiB
ROUNDS = 7  # interleaved rounds of the cold readings
CALLS = 64  # calls per cold reading


def make_input(mp: int = 1 << 19, lanes: int = 16, seed: int = 0
               ) -> np.ndarray:
    return np.random.RandomState(seed).normal(size=(mp, lanes)).astype(
        np.float32)


def bound_ms(x: torch.Tensor) -> float:
    """Least time for y = 2x on one H100: x read once, y written once."""
    return bound(2 * x.numel() * x.element_size())[0]


def check_bound(what: str, ms: float, bound: float) -> float:
    """The share of the bound a reading of ``ms`` reaches; raises above
    ``MAX_BOUND_SHARE``."""
    share = bound / ms
    if share > MAX_BOUND_SHARE:
        raise RuntimeError(
            f"{what}: {ms:.4f} ms is {share:.3f} of the {bound:.4f} ms bytes "
            f"bound (above {MAX_BOUND_SHARE}): the timing is wrong")
    return share


def summary(readings) -> dict:
    return {"median": float(np.median(readings)), "min": min(readings),
            "max": max(readings), "n": len(readings)}


def cold_inputs(dev, mp: int = 1 << 19, rotation: int = ROTATION):
    """The rotation on ``dev``: ``rotation`` inputs made like x, seeds 1,
    2, ..."""
    return [torch.from_numpy(make_input(mp, seed=s)).to(dev)
            for s in range(1, rotation + 1)]


def cold_readings(fns, inputs, rounds: int = ROUNDS,
                  calls: int = CALLS) -> dict:
    """{name: {"eager": summary, "graph": summary, "bound_ms": b,
    "graph_share": s, "host_ms": eager − graph medians}} for callables on
    the card, each walking the same rotation of inputs in turns; raises if
    any reading beats the bytes bound (``check_bound``)."""
    bound = bound_ms(inputs[0])
    out = {}
    for name, r in rotation_ms(fns, inputs, rounds=rounds, n=calls).items():
        for mode in ("eager", "graph"):
            for ms in r[mode]:
                check_bound(f"{name} ({mode}, L2-cold)", ms, bound)
        eager, graph = summary(r["eager"]), summary(r["graph"])
        out[name] = {"eager": eager, "graph": graph, "bound_ms": bound,
                     "graph_share": bound / graph["median"],
                     "host_ms": eager["median"] - graph["median"]}
    return out


def run(device=None, mp: int = 1 << 19, K: int = 16, iters: int = 3):
    """{line label: seconds per call}, each line printed as it is timed."""
    dev = resolve_device(device)
    x = torch.from_numpy(make_input(mp)).to(dev)
    out = {}
    for label, fn in LINES:
        out[label] = timeit_device(fn, x, K=K, iters=iters)
        if x.is_cuda:
            check_bound(label, out[label] * 1e3, bound_ms(x))
        print(f"{label}: {out[label] * 1e3:.4f} ms", flush=True)
    return out


def run_cold(dev, mp: int = 1 << 19) -> dict:
    """The L2-cold, graph-replayed line of each label, printed."""
    res = cold_readings(dict(LINES), cold_inputs(dev, mp))
    for label, r in res.items():
        g = r["graph"]
        print(f"{label} [L2-cold, CUDA graph]: {g['median']:.4f} ms median "
              f"of {g['n']} (min {g['min']:.4f}, max {g['max']:.4f}; eager "
              f"{r['eager']['median']:.4f}; {r['graph_share']:.3f} of the "
              f"{r['bound_ms']:.4f} ms bound)", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    run(args.device)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        run_cold(dev)
    print(f"kernel launches {json.dumps(kernel_launches())}",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
