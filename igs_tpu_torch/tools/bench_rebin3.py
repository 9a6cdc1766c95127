"""Where the rebin cache's machinery costs: three variants of a loop that
keeps every view's pair list in a stack and rebuilds a list when it is
K = 4 steps old (a probe of the cache the TPU rounds rejected, kept as
the evidence trail).

    python -m igs_tpu_torch.tools.bench_rebin3 [--n 150000] [--res 512]
        [--steps 50] [--views 18] [--device cpu]

Counterpart of ``tools/tools_bench_rebin3.py``: ``bench_rebin2``'s scene,
targets and densify-off steps. Every variant first builds the 18 lists
into a stack (each field of ``TilePairs`` stacked over the views) with
every age at K − 1; each step reads its view's list from the stack and
takes ``refine_step(..., pairs_override=)``. The JAX probe's machinery
has no PyTorch counterpart: it chooses with ``lax.cond`` inside a jitted
loop and carries the stack through ``fori_loop``. The port's nearest
choices are a Python branch on the view's age (a host integer: no device
read) and ``index_copy_`` of a rebuilt list into its slot of the stack.
What each variant isolates in the port, under the JAX probe's names:

* ``v1_mincond``: the branch rebuilds a view's list when its age is 0
  (``ops/rasterize.build_pairs_packed``, with the aux, as ``refine_run``
  rebuilds it) and writes it into the stack; else the step reads the
  stack. A list not rebuilt is already in its slot: PyTorch refuses to
  copy a tensor onto itself, so it is not written (the JAX probe writes
  the step's list back every step, an identical copy when not rebuilt);
* ``v2_nocond``: a rebuild every step, written into the stack, the ages
  kept: exact binning plus the stack's writes;
* ``v3_nostack``: the branch as v1, but nothing is written back: a
  rebuilt list serves its step only, and the stack keeps the prebuilt
  lists (the frozen loop plus the branch's rebuilds).

Each loop is timed by ``timeit_device`` (K=2, 3 rounds); view 0's PSNR
of its final state against its target is recorded (``psnr_v0``, dB),
with the rebuilds it made. The loops launch B1 (colour), B2 and B3.
"""

from __future__ import annotations

import sys

import torch

from igs_tpu_torch.ops.binning import TilePairs
from igs_tpu_torch.tools.bench_rebin import RebinSetup, timed_loop
from igs_tpu_torch.tools.bench_rebin2 import build_view, prebuild, step
from igs_tpu_torch.tools.probe import Probe, parser, refine_args

K_STALE = 4
MODES = ("v1_mincond", "v2_nocond", "v3_nostack")


def stacked(lists) -> TilePairs:
    return TilePairs(*(torch.stack(f) for f in zip(*lists)))


def slot(stack: TilePairs, v: int) -> TilePairs:
    return TilePairs(*(f[v] for f in stack))


def write_slot(stack: TilePairs, v: int, pairs: TilePairs) -> None:
    idx = torch.tensor([v], device=stack.gauss_id.device)
    for f, p in zip(stack, pairs):
        f.index_copy_(0, idx, p.unsqueeze(0))


def make_loop(rs: RebinSetup, mode: str, rebuilds: list):
    """The variant's loop; it appends its rebuild count to ``rebuilds``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; the variants are {MODES}")

    def run(state):
        views = rs.gts.shape[0]
        stack = stacked(prebuild(rs, state.gaussians))
        ages = [K_STALE - 1] * views
        built = 0
        for it in range(rs.steps):
            v = rs.order[it]
            need = mode == "v2_nocond" or ages[v] <= 0
            if need:
                pairs = build_view(rs, state.gaussians, v)
                built += 1
                if mode != "v3_nostack":
                    write_slot(stack, v, pairs)
            else:
                pairs = slot(stack, v)
            ages[v] = K_STALE - 1 if need else ages[v] - 1
            state = step(rs, state, it, pairs)
        rebuilds.append(built)
        return state
    return run


def main(argv=None) -> int:
    ap = parser(__doc__)
    refine_args(ap)
    args = ap.parse_args(argv)
    pr = Probe("bench_rebin3", args)
    rs = RebinSetup(args, pr.dev, y_shift=False)
    for mode in MODES:
        rebuilds: list = []
        timed_loop(pr, rs, mode, make_loop(rs, mode, rebuilds), args)
        pr.results[mode]["rebuilds"] = rebuilds[-1]
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
