"""Streaming-rate harness: per-stage timings of a streaming window.

    python -m igs_tpu_torch.roofline [--f32] [--device cpu] [--out PATH]

Counterpart of the repo's ``roofline.py``. On a synthetic N3DV-scale
scene (150 000 Gaussians from ``RandomState(0)``, one 512² camera) it
times, with ``timeit_device``: anchor selection (FPS 8192 + KNN-8), the
rasterizer forward and forward+backward (and Mpix/s), the 50-step
``refine_run`` on 18 views, and the AGM-Net forward at B=5 (4 input
views at 512², the eval view at ``res``, 4 depth-carry views at 128²)
with the window's shared pair list and without it; from these the
stream's seconds per frame and fps:
``window = anchors + AGM forward + refine loop`` for B frames. As in the
JAX script, the AGM-Net runs with the three bf16 compute flags on unless
``--f32`` is given; the rasterizer is float32 either way.

Two deviations from the JAX script:
  * anchor selection uses exact KNN where the JAX script asks for
    ``exact_knn=False`` (``approx_max_k`` has no counterpart; ROADMAP C1);
  * ``--out`` defaults to ``logs/igs_tpu_torch/roofline.json``: the
    repo-root ``roofline.json`` holds the TPU's numbers and is never
    written.
The AGM forward is timed under ``torch.inference_mode`` with the
salt on the batch's first floating tensor (JAX salts the first
parameter); the depth-carry budget is the JAX formula's (2^16 at 128²),
which a 150 000-Gaussian scene overflows, as in JAX (ROADMAP C6):
``agm_overflow_tiles`` reports it. Results print as JSON and go to
``--out``; the kernels' launch counts go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from igs_tpu_torch.builders import build_model
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.ops.anchors import AnchorState, select_anchors
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.stream.refine import (
    RefineConfig, init_refine_state, refine_run)
from igs_tpu_torch.utils.devtime import timeit_device
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.profiling import kernel_launches

DEFAULT_OUT = os.path.join("logs", "igs_tpu_torch", "roofline.json")
# the JAX script's output at the repo root
TPU_ROOFLINE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "roofline.json")


def timeit(fn, *args, iters=5, K=1):
    return timeit_device(fn, *args, K=max(K, 1), iters=iters)


def scene(n: int, rng: np.random.RandomState, dev) -> Gaussians:
    """The scene, drawn in the JAX script's order from ``rng``."""
    xyz = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    return Gaussians.create(
        xyz,
        rng.uniform(-2, 4, (n, 1)).astype(np.float32),
        (lambda q: q / np.linalg.norm(q, axis=1, keepdims=True))(
            rng.normal(size=(n, 4)).astype(np.float32)),
        rng.uniform(-5.5, -3.5, (n, 3)).astype(np.float32),
        np.concatenate([
            rng.uniform(-1, 2, (n, 1, 3)),
            0.05 * rng.normal(size=(n, 15, 3))], 1).astype(np.float32),
        device=dev)


def agm_batch(b: int, hw: int, rng: np.random.RandomState, dev) -> dict:
    """The AGM batch, drawn in the JAX script's order from ``rng``: B
    candidates of 4 input views on the z axis at -5, the eval view
    first among the outputs, then the 4 depth-carry views."""
    h8 = hw // 8 * 2
    c2w = np.tile(np.eye(4, dtype=np.float32), (b, 4, 1, 1))
    c2w[:, :, 2, 3] = -5.0

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return {
        "cur_images_input": t(rng.uniform(0, 1, (b, 4, 3, hw, hw))),
        "next_images_input": t(rng.uniform(0, 1, (b, 4, 3, hw, hw))),
        "depth": t(rng.uniform(2, 6, (b, 4, hw, hw))),
        "local_rays": t(rng.normal(size=(b, h8, h8, 3))),
        "FOV": t(np.full((b, 2), 0.9)),
        "c2w_input": t(c2w),
        "c2w_output": t(np.concatenate([c2w[:, :1], c2w], axis=1)),
        "background_color": t(np.zeros((b, 3))),
    }


def windowed(state1: AnchorState, g: Gaussians, b: int):
    """One frame's anchors and Gaussians as B candidates (views)."""
    return (AnchorState(*(x.expand((b,) + x.shape) for x in state1)),
            g.map(lambda x: x.expand((b,) + x.shape)))


def depth_settings_for(settings: RasterSettings, depth_res: int
                       ) -> RasterSettings:
    """The depth-carry views' settings with the JAX script's budget,
    ~4 contributions a pixel as ``stream/pipeline.py`` sized it."""
    return settings._replace(
        image_height=depth_res, image_width=depth_res,
        max_pairs=1 << min(18, max(14, (depth_res ** 2 * 4 - 1)
                                   .bit_length())),
        max_per_tile=512, outputs="color_depth")


def run(n_gaussians: int = 150_000, anchors: int = 8192, res: int = 512,
        batch: int = 5, refine_iters: int = 50, impl: str = "pallas_packed",
        depth_res: int = 128, f32: bool = False, rebin_every: int = 1,
        device=None, hw: int = 512, system=None) -> dict:
    """The JAX script's results dict; ``hw`` is the AGM input resolution
    (512 in the JAX script) and ``system`` the model's config section
    (AGMNet defaults when None), whose bf16 flags default to on unless
    ``f32``."""
    dev = resolve_device(device)
    n, a, b = n_gaussians, anchors, batch
    rng = np.random.RandomState(0)
    g = scene(n, rng, dev)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 5.0
    cam = Camera.from_w2c(w2c, 0.9, 0.9, height=res, width=res, device=dev)
    bbox = torch.tensor([[-2.0, -2, -2], [2.0, 2, 2]], device=dev)
    settings = RasterSettings(image_height=res, image_width=res, impl=impl,
                              max_pairs=1 << 19, max_per_tile=1024,
                              chunk=128)
    results = {}

    # 1. anchors
    def sel(x, v):
        return select_anchors(x, bbox, valid=v, anchor_size=a, k=8)

    results["anchors_s"] = timeit(sel, g.xyz, g.valid, K=8)

    # 2. rasterize fwd / fwd+bwd
    def fwd(x):
        return rasterize(means3d=x, opacity=g.get_opacity,
                         scaling=g.get_scaling, rotation=g.get_rotation,
                         camera=cam, shs=g.shs, settings=settings)["color"]

    results["raster_fwd_s"] = timeit(fwd, g.xyz, K=16)

    def fb(x):
        x = x.detach().requires_grad_(True)
        out = rasterize(means3d=x, opacity=g.get_opacity,
                        scaling=g.get_scaling, rotation=g.get_rotation,
                        camera=cam, shs=g.shs, settings=settings)
        return torch.autograd.grad(torch.mean(torch.abs(out["color"])), x)

    results["raster_fwd_bwd_s"] = timeit(fb, g.xyz, K=16)
    results["raster_fwd_bwd_mpix_s"] = res * res / results[
        "raster_fwd_bwd_s"] / 1e6

    # 3. refine: the whole refine_run of refine_iters steps
    state = init_refine_state(g, capacity=n)
    rcfg = RefineConfig(rebin_every=rebin_every)
    nviews = 18  # sear_steak training views
    gts = torch.zeros((nviews, 3, res, res), device=dev)
    cams = Camera.stack([cam] * nviews)
    order = [i % nviews for i in range(refine_iters)]
    refine_settings = settings._replace(clamp_grads=False, outputs="color")
    bg = torch.zeros(3, device=dev)

    def rloop(s):
        return refine_run(s, cams, gts, order, bg, rcfg, refine_settings,
                          3.0, refine_iters)

    results["refine_loop_s"] = timeit(rloop, state, iters=3)
    results["refine_step_s"] = results["refine_loop_s"] / refine_iters
    del state

    # 4. AGM forward at production dims
    model = build_model(system or {}, device=dev, bf16_default=not f32)
    astate, gb = windowed(sel(g.xyz, g.valid), g, b)
    bt = agm_batch(b, hw, rng, dev)
    agm_settings = settings._replace(clamp_grads=True, outputs="color")
    depth_settings = depth_settings_for(agm_settings, depth_res)

    def napply(bt_, shared_pairs):
        with torch.inference_mode():
            out = model(bt_, astate, gb, agm_settings,
                        depth_settings=depth_settings, shared_cur=True,
                        shared_window_pairs=shared_pairs)
        return out["images_pred"], out["overflow_tiles"]

    # headline: the production streaming path (shared_cur + the window's
    # shared pair list, both pipeline defaults); the exact per-candidate
    # binning alongside
    results["agm_forward_s"] = timeit(lambda x: napply(x, True), bt,
                                      iters=3, K=4)
    results["agm_forward_exact_pairs_s"] = timeit(
        lambda x: napply(x, False), bt, iters=3, K=4)
    results["agm_overflow_tiles"] = int(napply(bt, True)[1].max())

    # derived: streaming sec/frame for a B-frame key window
    window = (results["anchors_s"] + results["agm_forward_s"]
              + results["refine_loop_s"])
    results["stream_s_per_frame"] = window / b
    results["stream_fps"] = b / window
    results["device"] = (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else dev.type)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-gaussians", type=int, default=150_000)
    ap.add_argument("--anchors", type=int, default=8192)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--refine-iters", type=int, default=50)
    ap.add_argument("--impl", default="pallas_packed")
    ap.add_argument("--depth-res", type=int, default=128)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--f32", action="store_true",
                    help="disable the per-module bf16 compute flags")
    ap.add_argument("--rebin-every", type=int, default=1,
                    help="refine-loop tile-pair rebuild interval "
                         "(RefineConfig.rebin_every; pallas_packed only)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    config = vars(args)
    out = config.pop("out")
    if os.path.realpath(out) == os.path.realpath(TPU_ROOFLINE):
        raise SystemExit(f"{out} holds the TPU's numbers; choose another "
                         "--out")
    results = run(**config)
    results["config"] = dict(config, out=out)
    print(json.dumps(results, indent=2), flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"kernel launches {json.dumps(kernel_launches())}",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
