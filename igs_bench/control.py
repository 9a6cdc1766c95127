"""Readings for the limits of a cell's check: the program's numbers and the
control's on several seeds, at the cell's own size, in one process.

    python -m igs_bench.control --workload <cell> --seeds 11 12 13 ...

Each seed sets up as a run does, measures a window of one clip or one
step, and is checked: the program against the reference, the control (the
reference computed one precision step below the configuration,
``reference/lowp.py``) against the reference, and in a training cell the
planted faults (``drivers/train.py``) against it. One JSON line a seed on
standard output, and ``build/bench_work/control_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from igs_bench import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    bench = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    traffic = bench_run.load_json(bench_run.HERE / "workloads"
                                  / f"{args.workload}.json")
    cfg = bench_run.load_json(bench_run.HERE / "configs"
                              / f"{cell['config']}.json")
    if not torch.cuda.is_available():
        print("igs_bench.control: no CUDA device", file=sys.stderr)
        return 2
    bench_run.set_caches(bench_run.ROOT)
    device = torch.device("cuda", 0)
    out_path = (bench_run.ROOT / "build" / "bench_work"
                / f"control_{args.workload}.jsonl")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        job = bench_run.Job(
            name=args.workload, cfg=cfg, traffic=traffic, seed=seed,
            seconds=0.0, trace=False, device=device,
            t_start=time.perf_counter(),
            workspace=str(out_path.parent / args.workload), control=True)
        res = bench_run.execute(job, [], traffic["limits"])
        line = {"seed": seed, "correct": res["correct"],
                "program": {k: c["value"] for k, c in res["checks"].items()},
                **{k: v for k, v in res.items()
                   if k.startswith(("control", "fault_", "program_"))}}
        print(json.dumps(line), flush=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
