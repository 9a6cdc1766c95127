"""Scaling harness: the data-parallel AGM train step (and the strip-sharded
key-frame refine) at 1, 2, 4, … ranks.

    python -m igs_tpu_torch.bench_scaling [--what train|refine|all]
        [--hw 128] [--n-gaussians 8192] [--anchors 512] [--iters 5]
        [--max-ranks N] [--device cpu] [--backend nccl|gloo] [--share-card]
        [--out PATH]

Counterpart of the repo's ``bench_scaling.py``, with its inputs (drawn from
``RandomState(0)``), its model (AGM-Net at its default widths), its
settings (the windowed route at ``hw``², color, clamp, 2^16 pairs, 512
rows a tile) and its JSON schema: ``{"<ranks>": {sec_per_step,
scenes_per_sec, per_device, efficiency}}`` for the train step, with one
scene a rank (fixed work a rank), and ``{"refine_<ranks>": {sec_per_iter,
speedup, efficiency}}`` for ten refine steps of one fixed scene, its
renders split into tile-row strips (strong scaling). Each rank count runs
in its own group of spawned ranks (``parallel/launch.spawn``): one card a
rank under NCCL, so the counts go up to the cards present (or
``--max-ranks``); ``--backend gloo --share-card`` puts every rank on one
card, where the numbers time the path, not scaling. A step is timed on
the host clock after a warm-up, the card synchronised, the median of
``--iters``. Results print as JSON and go to ``--out`` (default
``logs/igs_tpu_torch/bench_scaling.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from igs_tpu_torch.builders import build_model
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.ops.anchors import AnchorState, select_anchors
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.parallel import distributed as D
from igs_tpu_torch.parallel.launch import rank_plan, spawn
from igs_tpu_torch.parallel.mesh import make_mesh, shard_batch
from igs_tpu_torch.stream.refine import (
    RefineConfig, init_refine_state, refine_run, refine_run_sharded)
from igs_tpu_torch.train.driver import (
    OptConfig, make_optimizer, make_train_step)
from igs_tpu_torch.utils.device import resolve_device

DEFAULT_OUT = os.path.join("logs", "igs_tpu_torch", "bench_scaling.json")
REFINE_ITERS = 10


def make_inputs(b: int, hw: int, n: int, anchors: int,
                rng: np.random.RandomState, dev):
    """The JAX script's inputs, drawn in its order: (batch, anchor states,
    Gaussians), each with a leading axis of ``b`` copies."""
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    g = Gaussians.create(
        xyz, rng.uniform(-1, 3, (n, 1)).astype(np.float32),
        (lambda q: q / np.linalg.norm(q, axis=1, keepdims=True))(
            rng.normal(size=(n, 4)).astype(np.float32)),
        rng.uniform(-4.5, -3.0, (n, 3)).astype(np.float32),
        np.concatenate([rng.uniform(-1, 2, (n, 1, 3)),
                        0.05 * rng.normal(size=(n, 15, 3))], 1).astype(
            np.float32), device=dev)
    bbox = torch.tensor([[-2.0, -2, -2], [2.0, 2, 2]], device=dev)
    st = select_anchors(g.xyz, bbox, valid=g.valid, anchor_size=anchors, k=8)
    c2w = np.tile(np.eye(4, dtype=np.float32), (b, 4, 1, 1))
    c2w[:, :, 2, 3] = -4.0
    h8 = hw // 8 * 2

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    batch = {
        "cur_images_input": t(rng.uniform(0, 1, (b, 4, 3, hw, hw))),
        "next_images_input": t(rng.uniform(0, 1, (b, 4, 3, hw, hw))),
        "depth": t(rng.uniform(2, 6, (b, 4, hw, hw))),
        "local_rays": t(rng.normal(size=(b, h8, h8, 3))),
        "FOV": t(np.full((b, 2), 0.9)),
        "c2w_input": t(c2w),
        "c2w_output": t(c2w[:, :2]),
        "background_color": t(np.zeros((b, 3))),
        "images_output": t(rng.uniform(0, 1, (b, 2, 3, hw, hw))),
    }
    state = AnchorState(*(x.expand((b,) + x.shape).contiguous()
                          for x in st))
    return batch, state, g.map(lambda x: x.expand((b,) + x.shape)
                               .contiguous())


def _timed(fn, iters: int, dev) -> float:
    """Median host seconds of ``fn()`` after one warm-up, the card
    synchronised around each call."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    fn()
    sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def train_rank(rank: int, device, args: dict) -> dict:
    """One rank of the data-parallel train step at the group's size: a
    scene a rank, this rank's slice of the batch."""
    dev = resolve_device(device)
    c = D.process_count()
    hw = args["hw"]
    batch, state, gb = make_inputs(c, hw, args["n_gaussians"],
                                   args["anchors"],
                                   np.random.RandomState(0), dev)
    settings = RasterSettings(
        image_height=hw, image_width=hw, impl="pallas", max_pairs=1 << 16,
        max_per_tile=512, chunk=128, clamp_grads=True, outputs="color")
    model = build_model({}, device=dev, train=True)
    cfg = OptConfig(warmup_steps=1)
    optimizer, _ = make_optimizer(model, cfg, total_steps=100)
    mesh = make_mesh(data=c, tile=1, device=dev)
    step = make_train_step(cfg, settings, mesh=mesh)
    local = [shard_batch(mesh, x) for x in (batch, state, gb)]
    sec = _timed(lambda: step(model, optimizer, *local), args["iters"], dev)
    return {"sec_per_step": sec}


def refine_rank(rank: int, device, args: dict) -> dict:
    """One rank of ten refine steps of one fixed scene, its renders split
    over the group's ranks in tile-row strips."""
    dev = resolve_device(device)
    c = D.process_count()
    res = max(args["hw"], 64)
    n = args["n_gaussians"]
    _, _, gb = make_inputs(1, args["hw"], n, args["anchors"],
                           np.random.RandomState(0), dev)
    g = gb.map(lambda x: x[0])
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 4.0
    cam = Camera.from_w2c(w2c, 0.9, 0.9, res, res, device=dev)
    cams = Camera.stack([cam, cam])
    gts = torch.as_tensor(np.random.RandomState(1).uniform(
        0, 1, (2, 3, res, res)).astype(np.float32), device=dev)
    order = [i % 2 for i in range(REFINE_ITERS)]
    settings = RasterSettings(image_height=res, image_width=res,
                              max_pairs=1 << 17, outputs="color",
                              clamp_grads=False)
    state0 = init_refine_state(g, capacity=n)
    bg = torch.zeros(3, device=dev)
    args_ = (cams, gts, order, bg, RefineConfig(), settings, 3.0,
             REFINE_ITERS)
    if c == 1:
        fn = lambda: refine_run(state0, *args_)
    else:
        mesh = make_mesh(data=1, tile=c, device=dev)
        fn = lambda: refine_run_sharded(state0, *args_, mesh)
    return {"sec_per_iter": _timed(fn, args["iters"], dev) / REFINE_ITERS}


def run(what: str = "train", hw: int = 128, n_gaussians: int = 8192,
        anchors: int = 512, iters: int = 5, max_ranks: int = 0, device=None,
        backend=None, share_card: bool = False, out: str = DEFAULT_OUT
        ) -> dict:
    """The measurements as the JSON dict (written to ``out``)."""
    dev = torch.device(device or "cuda")
    if not max_ranks:
        max_ranks = torch.cuda.device_count() if dev.type == "cuda" else 1
    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= max_ranks]
    args = dict(hw=hw, n_gaussians=n_gaussians, anchors=anchors, iters=iters)
    results = {}

    def ranks(fn, c):
        b, devices = rank_plan(c, device, backend, share_card)
        return spawn(fn, c, (args,), backend=b, devices=devices)[0]

    if what in ("refine", "all"):
        base = None
        for c in [c for c in counts if (max(hw, 64) // 16) % c == 0]:
            sec = ranks(refine_rank, c)["sec_per_iter"]
            base = sec if base is None else base
            results[f"refine_{c}"] = {"sec_per_iter": sec,
                                      "speedup": base / sec,
                                      "efficiency": base / sec / c}
            print(f"refine x{c}", results[f"refine_{c}"], flush=True)
    if what in ("train", "all"):
        base = None
        for c in counts:
            sec = ranks(train_rank, c)["sec_per_step"]
            per = c / sec / c
            base = per if base is None else base
            results[str(c)] = {"sec_per_step": sec, "scenes_per_sec": c / sec,
                               "per_device": per, "efficiency": per / base}
            print(c, results[str(c)], flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", type=int, default=128, help="input resolution")
    ap.add_argument("--n-gaussians", type=int, default=8192)
    ap.add_argument("--anchors", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--what", default="train",
                    choices=["train", "refine", "all"])
    ap.add_argument("--max-ranks", type=int, default=0,
                    help="largest rank count (default: the cards present)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--backend", default=None, choices=D.BACKENDS)
    ap.add_argument("--share-card", action="store_true",
                    help="every rank on the one card --device names "
                         "(needs --backend gloo)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.what, a.hw, a.n_gaussians, a.anchors, a.iters,
                         a.max_ranks, a.device, a.backend, a.share_card,
                         a.out)))


if __name__ == "__main__":
    main()
