"""Pieces the rasterizer and refine probes of this package share: the JAX
probes' scene (``bench.scene``: uniform positions in [-2, 2]³, opacity
logits in [-2, 4], log-scales in [-5.5, -3.5], degree-3 SHs) and their
cameras (a 0.9 rad field of view 5 units down the z axis, and the
refine probes' views shifted 0.25 along x by ``i % 5 - 2``), the command
line every probe takes (``--device``, ``--out``), and the JSON each
writes under ``logs/igs_tpu_torch/tools/`` with the kernels' launches
of its run (also printed on stderr).

The probes never write the repo-root artifacts that hold the TPU's
numbers (``tpu_sweep.json``, ``roofline.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from igs_tpu_torch.bench import camera, scene
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.utils.devtime import timeit_device
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.profiling import kernel_launches

OUT_DIR = os.path.join("logs", "igs_tpu_torch", "tools")
# the JAX package's repo-root results, which hold the TPU's numbers
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TPU_FILES = tuple(os.path.join(_ROOT, f) for f in ("tpu_sweep.json",
                                                   "roofline.json"))
__all__ = ["OUT_DIR", "camera", "scene", "shifted_cameras", "parser",
           "Probe", "ms", "packed_inputs", "render_grads", "RefineSetup",
           "refine_args"]


def shifted_cameras(res: int, views: int, dev) -> Camera:
    """The refine probes' ``views`` cameras, stacked: the bench camera
    moved 0.25 along x by ``i % 5 - 2``."""
    cams = []
    for i in range(views):
        w2c = np.eye(4, dtype=np.float32)
        w2c[2, 3] = 5.0
        w2c[0, 3] = 0.25 * (i % 5 - 2)
        cams.append(Camera.from_w2c(w2c, 0.9, 0.9, height=res, width=res,
                                    device=dev))
    return Camera.stack(cams)


def packed_inputs(g, cam, mode: str, max_pairs: int,
                  segred_aux: bool = True):
    """What the packed route hands its kernels for one render of ``g``
    through ``cam``, as ``rasterize`` builds it: (the projection, the
    pairs, the (lanes, pairs) pair features, grid_x, grid_y)."""
    from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
    from igs_tpu_torch.ops.blend import pack_features
    from igs_tpu_torch.ops.projection import project

    proj = project(g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                   cam, shs=g.shs, valid=g.valid, geometry=mode != "color")
    gx, gy = image_tile_grid(cam.height, cam.width)
    pairs = build_tile_pairs(proj, gx, gy, max_pairs, segred_aux=segred_aux)
    feats = pack_features(proj)
    if mode == "color":
        feats = feats[..., :16]
    rows = feats.reshape(-1, feats.shape[-1]).t().contiguous()
    feats_t = torch.index_select(rows, 1, pairs.gauss_id.clamp_min(0).long())
    return proj, pairs, feats_t, gx, gy


def render_grads(g, cam, settings, depth_term: bool = False):
    """A function of the five raw parameter tensors that renders through
    ``rasterize`` and returns the gradients of mean |colour| (plus 0.1 ×
    mean depth with ``depth_term``) with respect to them, as the JAX
    probes' ``jax.grad(loss, argnums=(0, 1, 2, 3, 4))``."""
    from igs_tpu_torch.ops.rasterize import rasterize

    def grads(xyz, opacity, scaling, rotation, shs):
        params = [t.detach().requires_grad_(True)
                  for t in (xyz, opacity, scaling, rotation, shs)]
        with torch.enable_grad():
            out = rasterize(
                means3d=params[0], opacity=torch.sigmoid(params[1]),
                scaling=torch.exp(params[2]),
                rotation=torch.nn.functional.normalize(params[3], dim=-1),
                camera=cam, shs=params[4], valid=g.valid, settings=settings)
            loss = torch.mean(torch.abs(out["color"]))
            if depth_term:
                loss = loss + 0.1 * torch.mean(out["depth"])
            return torch.autograd.grad(loss, params)
    return grads


def refine_args(ap: argparse.ArgumentParser) -> None:
    """The refine probes' sizes: the JAX probes' 150 000 Gaussians at
    512², 50 steps over 18 views, timed ``timeit_device(K=2, iters=3)``,
    a 2^19 pair budget."""
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--views", type=int, default=18)
    ap.add_argument("--K", type=int, default=2)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--max-pairs", type=int, default=1 << 19)


class RefineSetup:
    """The refine probes' loop inputs: the scene padded to itself
    (capacity n), ``views`` cameras (the bench camera repeated, or
    shifted), zero ground truths, the view of each step (``i % views``),
    and the colour settings of the packed route at ``args.max_pairs``."""

    def __init__(self, args, dev, shifted: bool = True):
        from igs_tpu_torch.ops.rasterize import RasterSettings
        from igs_tpu_torch.stream.refine import init_refine_state

        self.g = scene(args.n, dev)
        self.cams = (shifted_cameras(args.res, args.views, dev) if shifted
                     else Camera.stack([camera(args.res, dev)] * args.views))
        self.gts = torch.zeros((args.views, 3, args.res, args.res),
                               device=dev)
        self.order = [i % args.views for i in range(args.steps)]
        self.bg = torch.zeros(3, device=dev)
        self.settings = RasterSettings(
            image_height=args.res, image_width=args.res,
            impl="pallas_packed", max_pairs=args.max_pairs, outputs="color",
            clamp_grads=False)
        self.state = init_refine_state(self.g, capacity=args.n)
        self.steps = args.steps

    def run(self, cfg):
        """A function of a refine state: ``refine_run`` over the steps."""
        from igs_tpu_torch.stream.refine import refine_run

        def loop(state):
            return refine_run(state, self.cams, self.gts, self.order,
                              self.bg, cfg, self.settings, 3.0, self.steps)
        return loop


def parser(doc: str) -> argparse.ArgumentParser:
    """A probe's command line: its docstring's first paragraph, and
    ``--device`` and ``--out``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--out", default=None,
                    help=f"the JSON written (default {OUT_DIR}/<probe>.json)")
    return ap


def ms(fn, *args, K: int = 8, iters: int = 3) -> float:
    """``timeit_device`` in milliseconds."""
    return 1e3 * timeit_device(fn, *args, K=K, iters=iters)


class Probe:
    """One probe's run: its device, its results, its kernels' launches
    from the start of the run, and the JSON it writes."""

    def __init__(self, name: str, args: argparse.Namespace):
        if args.out and os.path.abspath(args.out) in TPU_FILES:
            raise ValueError(f"{args.out} holds the TPU's numbers; write "
                             f"under {OUT_DIR}")
        self.name = name
        self.args = args
        self.dev = resolve_device(args.device)
        self.results: Dict = {}
        self._start = kernel_launches()
        self._t0 = time.perf_counter()

    def put(self, key: str, value, unit: str = "ms") -> None:
        """Record a result and print it as a line."""
        self.results[key] = value
        if isinstance(value, float):
            print(f"{self.name}: {key} {value:.4f} {unit}", flush=True)
        else:
            print(f"{self.name}: {key} {value}", flush=True)

    def launches(self) -> Dict[str, int]:
        now = kernel_launches()
        return {k: v - self._start.get(k, 0) for k, v in now.items()
                if v - self._start.get(k, 0)}

    def write(self) -> str:
        """Write the JSON; the launches go to stderr. Returns its path."""
        path = self.args.out or os.path.join(OUT_DIR, f"{self.name}.json")
        launches = self.launches()
        card = (torch.cuda.get_device_name(self.dev)
                if self.dev.type == "cuda" else "cpu")
        doc = {"probe": self.name, "device": card,
               "args": {k: v for k, v in vars(self.args).items()
                        if k != "out"},
               "wall_s": time.perf_counter() - self._t0,
               "launches": launches, "results": self.results}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=float)
        print(f"kernel launches {json.dumps(launches)}", file=sys.stderr,
              flush=True)
        print(f"{self.name}: wrote {path}", flush=True)
        return path
