"""Run one cell of the benchmark and print its result as the last line.

    python -m igs_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is found by name: ``BENCHMARK.json`` lists it, its traffic file
is ``igs_bench/workloads/<cell>.json``, which names its configuration,
``igs_bench/configs/<config>.json``, which names its driver,
``igs_bench/drivers/<driver>.py``. Each metric is read by
``igs_bench/metrics/<metric>.py`` from what the driver observed: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics. A reader that finds nothing to read returns None and the
metric is left out of the line.

The last lines of standard error are each number the check compared,
beside its limit; the result's last key, ``checks``, holds them too.
Without a CUDA device, or with fewer than the cell asks for, the run exits
with an error and prints no result; so it does where the JAX package got
imported.
"""

import time

T_START = time.perf_counter()  # set-up is timed from the process's start

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "igs_tpu")


class BenchError(RuntimeError):
    pass


@dataclass
class Job:
    name: str
    cfg: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    workspace: str
    control: bool = False


def load_json(path: Path) -> Dict:
    if not path.is_file():
        raise BenchError(f"missing {path}")
    with open(path) as f:
        return json.load(f)


def load_metric(name: str):
    """The reader module of metric ``name`` (``metrics/<name>.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no reader for metric {name}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"igs_bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics that ``cell`` reports: the end-to-end ones that list it
    (or list no cells), or with ``trace`` the per-layer ones that list it,
    or that list no cells and move an end-to-end metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in reported)]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


def set_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed directory of the checkout."""
    build = root / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    from igs_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache(str(build))


def set_backends(cfg: Dict) -> None:
    """The TF32 switches as the configuration states them."""
    import torch

    tb = cfg["torch_backends"]
    torch.backends.cudnn.allow_tf32 = bool(tb["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(tb["matmul_allow_tf32"])


def execute(job: Job, metrics: List[Dict], limits: Dict[str, float]
            ) -> Dict:
    """Run the driver and assemble the result line (without ``device``'s
    name, which the caller adds)."""
    from igs_bench import compare

    driver = importlib.import_module(
        f"igs_bench.drivers.{job.cfg['driver']}")
    set_backends(job.cfg)
    out = driver.run(job)
    obs = out["obs"]
    obs.update(cfg=job.cfg, traffic=job.traffic)
    values = {}
    for m in metrics:
        v = load_metric(m["name"]).read(obs)
        if v is None:
            continue
        if not math.isfinite(v):
            raise BenchError(f"metric {m['name']} read {v}")
        values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    numbers = out["numbers"]["program"]
    # a number that is not finite is written as its name ("inf", "nan"),
    # which JSON can hold
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k])
                  else repr(numbers[k]), "limit": limits[k]} for k in limits}
    correct = compare.judge(numbers, limits)
    result = {
        "correct": bool(correct),
        "attempted": int(obs["frames"]),
        "failed": int(obs["failed"]),
        "metrics": values,
        "device": {"memory_peak_bytes": out["memory_peak_bytes"]},
    }
    tr = obs.get("trace")
    if job.trace and tr is not None:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tr["breakdown"]
    # the control's and the planted faults' numbers (igs_bench.control)
    result.update({side: nums for side, nums in out["numbers"].items()
                   if side != "program"})
    result["checks"] = checks
    return result


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """The command. ``device``, for the tests, skips the look for a CUDA
    device and runs the rest on the device given."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = load_json(ROOT / "BENCHMARK.json")
        cell = next((w for w in bench["workloads"]
                     if w["name"] == args.workload), None)
        if cell is None:
            raise BenchError(f"no cell {args.workload} in BENCHMARK.json")
        traffic = load_json(HERE / "workloads" / f"{args.workload}.json")
        cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
        import torch

        if device is None:
            if not torch.cuda.is_available():
                raise BenchError("no CUDA device: the benchmark measures "
                                 "the card only")
            if torch.cuda.device_count() < int(cell["chips"]):
                raise BenchError(f"{torch.cuda.device_count()} CUDA "
                                 f"devices, the cell asks for "
                                 f"{cell['chips']}")
            device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
        set_caches(ROOT)
        job = Job(name=args.workload, cfg=cfg, traffic=traffic,
                  seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device, t_start=T_START,
                  workspace=str(ROOT / "build" / "bench_work" /
                                args.workload))
        result = execute(job, cell_metrics(bench, args.workload,
                                           job.trace), traffic["limits"])
    except BenchError as e:
        print(f"igs_bench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"igs_bench: the run imported {', '.join(found)}",
              file=sys.stderr)
        return 3
    on_card = device.type == "cuda"
    result["device"] = {"platform": "gpu" if on_card else device.type,
                        "kind": (torch.cuda.get_device_name(device)
                                 if on_card else device.type),
                        "count": int(cell["chips"]),
                        **result["device"]}
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
