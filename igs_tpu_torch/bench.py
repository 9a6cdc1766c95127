"""Benchmark: differentiable rasterizer fwd+bwd throughput at 512².

    python -m igs_tpu_torch.bench [--device cpu]

Counterpart of the repo's ``bench.py``: a synthetic N3DV-scale scene
(100 000 Gaussians from ``RandomState(0)`` in a 4-unit cube, small
anisotropic scales, mixed opacities) rendered through the packed route
with the full RaDe-GS outputs at a pair budget calibrated to the scene
(``calibrate_pair_budget``: measured pairs × 1.25), and the gradient of
``mean|color| + 0.1·mean(depth) + 0.01·mean(alpha)`` to all five
Gaussian parameters timed with ``timeit_device`` (K=32, iters=5).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"}; ``vs_baseline`` is against 1 streamed frame per second at
512² (0.262 Mpix/s), the BASELINE.md target; ``device`` names the card
(or "cpu"), which the JAX line leaves out. A watchdog prints an error
line and exits 3 if the run takes 900 s; it is cancelled however the run
ends. The kernels' launch counts go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

import numpy as np
import torch

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.ops.rasterize import (
    RasterSettings, calibrate_pair_budget, rasterize)
from igs_tpu_torch.utils.devtime import timeit_device
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.profiling import kernel_launches


def metric_name(hw: int) -> str:
    return f"rasterize_fwd_bwd_mpix_per_s_{hw}"


def _watchdog(seconds: float, hw: int) -> threading.Timer:
    """Emit an explicit error line if the run never finishes."""
    def fire():
        print(json.dumps({
            "metric": metric_name(hw), "value": 0.0, "unit": "Mpix/s",
            "vs_baseline": 0.0,
            "error": f"no result after {seconds:.0f} s"}), flush=True)
        os._exit(3)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


def scene(n: int, dev) -> Gaussians:
    """The bench scene, drawn in the JAX bench's order."""
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    opacity = rng.uniform(-2.0, 4.0, (n, 1)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    scaling = rng.uniform(-5.5, -3.5, (n, 3)).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1, 2, (n, 3))
    shs[:, 1:] = 0.05 * rng.normal(size=(n, 15, 3)).astype(np.float32)
    return Gaussians.create(xyz, opacity, rot, scaling, shs, device=dev)


def camera(hw: int, dev) -> Camera:
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 5.0
    return Camera.from_w2c(w2c, 0.9, 0.9, height=hw, width=hw, device=dev)


def run(device=None, n: int = 100_000, hw: int = 512, K: int = 32,
        iters: int = 5) -> dict:
    """The result line as a dict, plus the calibrated budget and the
    measured pairs."""
    dev = resolve_device(device)
    g = scene(n, dev)
    cam = camera(hw, dev)
    settings = RasterSettings(image_height=hw, image_width=hw,
                              impl="pallas_packed", max_pairs=1 << 19,
                              max_per_tile=1024, chunk=128)
    settings, measured = calibrate_pair_budget(
        g.get_xyz, g.get_opacity, g.get_scaling, g.get_rotation, cam,
        valid=g.valid, settings=settings)

    def grad_fn(*params):
        params = [p.detach().requires_grad_(True) for p in params]
        xyz, op_raw, scale_raw, rot_raw, shs = params
        out = rasterize(
            means3d=xyz, opacity=torch.sigmoid(op_raw),
            scaling=torch.exp(scale_raw),
            rotation=rot_raw / torch.linalg.norm(rot_raw, dim=-1,
                                                 keepdim=True),
            camera=cam, shs=shs, settings=settings)
        loss = (torch.mean(torch.abs(out["color"]))
                + 0.1 * torch.mean(out["depth"])
                + 0.01 * torch.mean(out["alpha"]))
        return torch.autograd.grad(loss, params)

    dt = timeit_device(grad_fn, g.xyz, g.opacity, g.scaling, g.rotation,
                       g.shs, K=K, iters=iters)
    mpix_s = hw * hw / dt / 1e6
    target_mpix_s = hw * hw * 1.0 / 1e6  # ≥ 1 streamed frame/sec
    return {
        "metric": metric_name(hw), "value": round(mpix_s, 3),
        "unit": "Mpix/s", "vs_baseline": round(mpix_s / target_mpix_s, 3),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "max_pairs": settings.max_pairs, "measured_pairs": measured,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    wd = _watchdog(900, 512)
    try:
        res = run(args.device)
    finally:
        wd.cancel()
    print(f"pair budget {res.pop('max_pairs')} for "
          f"{res.pop('measured_pairs')} measured pairs; kernel launches "
          f"{json.dumps(kernel_launches())}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
