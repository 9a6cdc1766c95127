"""The strip-sharded refine against the single-process loop, on 1, 2, 4
and 8 strips × {10, 50} Adam steps with densify firing: the largest
deviation of each parameter, both live-row counts, and a verdict.

    python -m igs_tpu_torch.tools.refine_parallel_sweep [--res 128]
        [--strips 1 2 4 8] [--steps 10 50] [--device cpu]

Counterpart of ``tools/tools_refine_parallel_sweep.py``, whose record of
the JAX package on an 8-device virtual CPU mesh is the repo-root
``REFINE_PARALLEL_SWEEP.json`` (refused as ``--out``). The same inputs:
384 Gaussians drawn with seed 5 padded to capacity 768, 4 views 4 units
down z moved 0.2·i along x, uniform random targets from seed 0 at 128²,
view i % 4 at step i, densify every 4 steps at a 1e-6 gradient threshold
(every live row selected, so the densify fires and the capacity binds),
colour outputs on the packed route at a 2^15 pair budget, extent 3.

Per step count the reference is ``stream/refine.refine_run`` in this
process. Per strip count n, ``refine_run_sharded`` runs on a (1, n) mesh
of n ranks that ``parallel/launch.spawn`` starts over gloo, each on the
one card (``share_card``; NCCL refuses two ranks on one device) or on the
CPU; 128 rows split into 16·n-row strips for n ≤ 8 (ROADMAP C30). Every
rank draws the densify's split samples from the same seeded generator as
the reference, so the loops see the same draws. The record of each run,
under the JAX probe's names: ``iters``, ``n_strips``, ``ref_valid``,
``shd_valid``, ``densify_fired``, ``max_abs_dev`` (per parameter, rank
0's result against the reference's) and ``equivalent`` (every deviation
under 5e-4 and the live counts equal), and, beyond the JAX record, the
rows (at most 8 a parameter) that break the bound (``rows_over_tol``;
rows from 384 on were made by a densify); then ``all_equivalent``. Timings
apart from the check: ``group_s`` (the spawn, the ranks' start and the
loop, host clock), ``loop_s`` (rank 0's loop, synchronised), and the
reference's ``ref_loop_s``; each rank's kernel launches under
``rank_launches`` (the reference's are the JSON's ``launches``: B1
colour, B2 and B3).

ROADMAP C33 (a strip scales the screen-offset gradient's y by its own
height) does not show here: at a 1e-6 threshold every live row is
selected whatever the scale. The program exits 0 whatever the verdict;
a run that is not equivalent is a finding of its JSON.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.parallel.launch import rank_plan, spawn
from igs_tpu_torch.stream.refine import (RefineConfig, init_refine_state,
                                         refine_run)
from igs_tpu_torch.tools.probe import Probe, parser

PARAMS = ("xyz", "opacity", "scaling", "rotation", "shs")
TOL = 5e-4  # the JAX probe's equivalence bound
JOIN_S = 1800.0  # seconds a group of ranks may take


def random_gaussians(n: int, seed: int) -> dict:
    """The JAX probe's ``random_gaussians`` as numpy arrays."""
    rng = np.random.RandomState(seed)
    return {"xyz": rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32),
            "opacity": rng.normal(size=(n, 1)).astype(np.float32),
            "rotation": rng.normal(size=(n, 4)).astype(np.float32),
            "scaling": rng.uniform(-4, -2, (n, 3)).astype(np.float32),
            "shs": 0.3 * rng.normal(size=(n, 16, 3)).astype(np.float32)}


def make_spec(res: int, iters: int, n: int = 384, cap: int = 768,
              views: int = 4, max_pairs: int = 1 << 15) -> dict:
    """The JAX probe's ``setup`` as picklable inputs."""
    rng = np.random.RandomState(0)
    w2cs = []
    for i in range(views):
        w2c = np.eye(4, dtype=np.float32)
        w2c[2, 3] = 4.0
        w2c[0, 3] = 0.2 * i
        w2cs.append(w2c)
    return {
        "gaussians": random_gaussians(n, seed=5), "capacity": cap,
        "w2c": w2cs, "res": res,
        "gts": rng.uniform(0, 1, (views, 3, res, res)).astype(np.float32),
        "order": [i % views for i in range(iters)], "iters": iters,
        "cfg": dict(use_densify=True, densification_interval=4,
                    densify_grad_threshold=1e-6),
        "settings": RasterSettings(
            image_height=res, image_width=res, impl="pallas_packed",
            max_pairs=max_pairs, outputs="color", clamp_grads=False),
    }


def loop_inputs(spec: dict, dev):
    """(state, cameras, targets, background) on ``dev``."""
    a = spec["gaussians"]
    g = Gaussians.create(a["xyz"], a["opacity"], a["rotation"],
                         a["scaling"], a["shs"], device=dev)
    res = spec["res"]
    cams = Camera.stack([Camera.from_w2c(w, 0.9, 0.9, height=res, width=res,
                                         device=dev) for w in spec["w2c"]])
    return (init_refine_state(g, capacity=spec["capacity"]), cams,
            torch.from_numpy(spec["gts"]).to(dev), torch.zeros(3, device=dev))


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def host(g: Gaussians) -> dict:
    out = {k: getattr(g, k).detach().cpu().numpy() for k in PARAMS}
    out["valid"] = int(g.valid.sum())
    return out


def strip_rank(rank: int, device, spec: dict) -> dict:
    """One rank of the sharded loop: its Gaussians, live rows, loop
    seconds and kernel launches."""
    from igs_tpu_torch.parallel import distributed as D
    from igs_tpu_torch.parallel.mesh import make_mesh
    from igs_tpu_torch.stream.refine import refine_run_sharded
    from igs_tpu_torch.utils.profiling import kernel_launches

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(data=1, tile=D.process_count())
    state, cams, gts, bg = loop_inputs(spec, dev)
    before = kernel_launches()
    _sync(dev)
    t0 = time.perf_counter()
    state = refine_run_sharded(state, cams, gts, spec["order"], bg,
                               RefineConfig(**spec["cfg"]), spec["settings"],
                               3.0, spec["iters"], mesh, axis="tile")
    _sync(dev)
    loop_s = time.perf_counter() - t0
    launches = {k: v - before.get(k, 0) for k, v in kernel_launches().items()
                if v - before.get(k, 0)}
    return {"gaussians": host(state.gaussians), "loop_s": loop_s,
            "launches": launches}


def sweep_record(spec: dict, ref: dict, shd: dict, n_strips: int) -> dict:
    """The JAX probe's record of one sharded run against the reference."""
    rows = {k: np.abs(ref[k] - shd[k]).reshape(len(ref[k]), -1).max(1)
            for k in PARAMS}
    dev = {k: float(r.max()) for k, r in rows.items()}
    n0 = len(spec["gaussians"]["xyz"])
    return {"iters": spec["iters"], "n_strips": n_strips,
            "ref_valid": ref["valid"], "shd_valid": shd["valid"],
            "densify_fired": ref["valid"] > n0, "max_abs_dev": dev,
            "equivalent": all(v < TOL for v in dev.values())
            and ref["valid"] == shd["valid"],
            # which rows break the bound (rows >= n0 were made by densify)
            "rows_over_tol": {k: np.nonzero(r >= TOL)[0][:8].tolist()
                              for k, r in rows.items() if r.max() >= TOL}}


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--strips", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--steps", type=int, nargs="+", default=[10, 50])
    args = ap.parse_args(argv)
    pr = Probe("refine_parallel_sweep", args)
    dev = pr.dev
    results = []
    for iters in args.steps:
        spec = make_spec(args.res, iters)
        state, cams, gts, bg = loop_inputs(spec, dev)
        _sync(dev)
        t0 = time.perf_counter()
        ref_state = refine_run(state, cams, gts, spec["order"], bg,
                               RefineConfig(**spec["cfg"]), spec["settings"],
                               3.0, iters)
        _sync(dev)
        ref_loop_s = time.perf_counter() - t0
        ref = host(ref_state.gaussians)
        for n in args.strips:
            backend, devices = rank_plan(n, str(dev), "gloo",
                                         share_card=dev.type == "cuda")
            t0 = time.perf_counter()
            ranks = spawn(strip_rank, n, (spec,), backend=backend,
                          devices=devices, timeout_s=JOIN_S)
            group_s = time.perf_counter() - t0
            rec = sweep_record(spec, ref, ranks[0]["gaussians"], n)
            rec.update(group_s=group_s, loop_s=ranks[0]["loop_s"],
                       ref_loop_s=ref_loop_s,
                       rank_launches=[r["launches"] for r in ranks])
            print(rec, flush=True)
            results.append(rec)
    pr.results["results"] = results  # each printed above
    pr.put("all_equivalent", all(r["equivalent"] for r in results))
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
