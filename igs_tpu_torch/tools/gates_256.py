"""The approximation ladder's quality gates on a trained checkpoint: the
256² synthetic stream once per rung, each rung's average PSNR and its
gap to the exact rung.

    python -m igs_tpu_torch.tools.gates_256 CHECKPOINT [a.b.c=value ...]
        [--config configs/synthetic_stream_256.yaml] [--max-batches N]
        [--only RUNG ...] [--workspace DIR] [--device cpu]

Counterpart of ``tools/tools_gates_256.py``. Each rung of ``CONFIGS`` (the
JAX probe's, in its order: ``exact_all`` first, the pole every gap is
measured against, then ``production`` and the single-knob ablations) is
one ``python -m igs_tpu_torch.infer_stream`` process on ``--config``
with ``opt.resume=CHECKPOINT`` (the port's ``train_agm`` checkpoint, a
reference ``.pth`` or the JAX package's ``.msgpack``), its workspace
under ``--workspace``, the overrides given on this command line (the
scene's ``data.data.root_dir=...`` and the like) and then the rung's.
From each rung's ``results.json`` the JSON keeps, under the JAX probe's
names, ``avg``, ``psnr``, ``overflow_events``, ``overrides`` and
``delta_vs_exact_all_db``; also the rung's ``sec/frame``, its wall
seconds (process start included) and the kernel launches its process
printed.

The port's KNN is always exact (ROADMAP C1): its builder does not read
``opt.exact_knn``, so the ``exact_knn`` rung runs production's
configuration and ``exact_all`` differs from production only by its
other knobs. The rung runs all the same, and the JSON says so
(``exact_knn_note``, and ``exact_knn_minus_production_db`` where both
ran).

Two repairs of the JAX program (ROADMAP C44): a failed rung is written
with its exit code and the end of its output (the JAX probe skipped the
write for it, so a failed last rung was lost), and the JSON is written
after every rung, the "wrote" line printed only by a write;
``--max-batches`` must be a positive integer and the checkpoint must
exist, both refused before any rung runs (the JAX probe passed either
on to eight failing runs). The program exits 1 when a rung failed. The
JSON goes to ``logs/igs_tpu_torch/tools/gates_256.json`` (``--out``),
never to the repo-root ``GATES_256.json``, the JAX package's record.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from igs_tpu_torch.tools.probe import _ROOT as ROOT, Probe, parser
from igs_tpu_torch.tools.sweep import launches_of

CONFIGS = {
    "exact_all": ["opt.exact_knn=true", "opt.fps_buckets=1",
                  "opt.shared_window_pairs=false",
                  "system.encoder_bf16=false", "system.cnn_bf16=false",
                  "system.ft_bf16=false", "opt.depth_view_res=256"],
    "production": [],
    "no_shared_pairs": ["opt.shared_window_pairs=false"],
    "f32": ["system.encoder_bf16=false", "system.cnn_bf16=false",
            "system.ft_bf16=false"],
    "carry64": ["opt.depth_view_res=64"],
    "carry256": ["opt.depth_view_res=256"],
    "exact_knn": ["opt.exact_knn=true"],
    "exact_fps": ["opt.fps_buckets=1"],
}
CONFIG = os.path.join(ROOT, "configs", "synthetic_stream_256.yaml")
TIMEOUT_S = 3600  # a rung's limit, as in the JAX probe
EXACT_KNN_NOTE = ("the port's KNN is always exact (ROADMAP C1): "
                  "opt.exact_knn is not read, so this rung runs "
                  "production's configuration")


def positive_int(text: str) -> int:
    try:
        value = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{text!r} is not an integer")
    if value < 1:
        raise argparse.ArgumentTypeError(f"{value} is not positive")
    return value


def table(results: dict) -> dict:
    """The rungs with their gap to ``exact_all`` where both have ``avg``."""
    base = results.get("exact_all", {}).get("avg")
    out = {}
    for name, r in results.items():
        r = dict(r)
        if "avg" in r and base is not None:
            r["delta_vs_exact_all_db"] = r["avg"] - base
        if name == "exact_knn":
            r["exact_knn_note"] = EXACT_KNN_NOTE
            prod = results.get("production", {}).get("avg")
            if "avg" in r and prod is not None:
                r["exact_knn_minus_production_db"] = r["avg"] - prod
        out[name] = r
    return out


def run_rung(name: str, cmd: list, ws: str, env: dict) -> dict:
    """One rung's process → its record (or its error)."""
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=TIMEOUT_S, env=env)
    except subprocess.TimeoutExpired as e:
        return {"error": f"timeout after {TIMEOUT_S} s",
                "output_tail": str(e.stdout or "")[-2000:]}
    wall = time.perf_counter() - t0
    out = (p.stdout or "") + (p.stderr or "")
    if p.returncode != 0:
        print(out[-4000:], flush=True)
        return {"error": p.returncode, "output_tail": out[-2000:],
                "wall_s": wall}
    with open(os.path.join(ws, "results.json")) as f:
        res = json.load(f)
    return {"avg": res["avg"], "psnr": res["psnr"],
            "overflow_events": res["overflow_events"],
            "sec/frame": res["sec/frame"], "wall_s": wall,
            "launches": launches_of(out)}


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("checkpoint")
    ap.add_argument("overrides", nargs="*",
                    help="dotted config overrides applied to every rung")
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--max-batches", type=positive_int, default=None,
                    help="stream batches a rung runs (PSNR averages over "
                         "what ran)")
    ap.add_argument("--only", nargs="+", choices=list(CONFIGS),
                    default=list(CONFIGS))
    ap.add_argument("--workspace", default=os.path.join(
        "logs", "igs_tpu_torch", "gates256"))
    args = ap.parse_intermixed_args(argv)
    if not os.path.exists(args.checkpoint):
        ap.error(f"no checkpoint at {args.checkpoint}")
    bad = [o for o in args.overrides if "=" not in o]
    if bad:
        ap.error(f"overrides must read a.b.c=value: {bad}")
    pr = Probe("gates_256", args)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    results = {}
    pr.results.update(what="256^2 trained-checkpoint approximation ladder",
                      checkpoint=args.checkpoint, results={})
    for name in [n for n in CONFIGS if n in args.only]:
        over = CONFIGS[name]
        ws = os.path.join(args.workspace, name)
        cmd = [sys.executable, "-m", "igs_tpu_torch.infer_stream",
               "--config", args.config, f"opt.resume={args.checkpoint}",
               f"opt.workspace={ws}"]
        if args.max_batches:
            cmd += ["--max-batches", str(args.max_batches)]
        if args.device:
            cmd += ["--device", args.device]
        cmd += [*args.overrides, *over]
        print("==>", name, " ".join(over), flush=True)
        rec = run_rung(name, cmd, ws, env)
        rec["overrides"] = over
        results[name] = rec
        if "avg" in rec:
            print(f"    avg PSNR {rec['avg']:.4f}", flush=True)
        # incremental: a partial ladder, a failed rung included, survives
        pr.results["results"] = table(results)
        pr.write()
    return 0 if all("avg" in r for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
