"""The refine loop at ``rebin_every`` 1, 2, 4 and 8 against real targets,
a probe whose cache machinery the TPU rounds rejected (kept as the
evidence trail).

    python -m igs_tpu_torch.tools.bench_rebin [--n 150000] [--res 512]
        [--steps 50] [--views 18] [--device cpu]

Counterpart of ``tools/tools_bench_rebin.py``: 150 000 Gaussians at 512²
(the bench scene's draws), 18 views shifted 0.25 along x by ``i % 5 -
2`` and along y by ``i // 5 - 1.5``, colour outputs on the packed route
at a 2^19 pair budget, capacity 150 000, the loop's default densify,
extent 3. The targets are real: each view rendered from a copy of the
scene whose means moved by 0.01·N(0, 1) (the seeded stream's next
draws), so the loss means something (``RebinSetup``; ``probe.
RefineSetup``'s targets are zeros). Per ``rebin_every`` k, ``refine_run``
with ``RefineConfig(rebin_every=k)`` (each view's pair list rebuilt when
k Adam steps old, or after a densify) timed by ``timeit_device`` (K=2,
3 rounds, each call the whole loop from the same state), then run once
more for the quality guard: view 0 rendered from the final state
against its target. Recorded under the JAX probe's names: ``loop_s``,
``step_ms``, ``psnr_v0`` (dB) and ``n_valid``. The loop launches B1
(colour), B2 and B3.
"""

from __future__ import annotations

import sys
from dataclasses import replace

import numpy as np
import torch

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.stream.refine import (RefineConfig, init_refine_state,
                                         refine_run)
from igs_tpu_torch.tools.probe import Probe, parser, refine_args
from igs_tpu_torch.utils.devtime import timeit_device


def render(g: Gaussians, cam: Camera, settings: RasterSettings
           ) -> torch.Tensor:
    """The (3, H, W) colour of ``g`` through ``cam``, without autograd."""
    with torch.no_grad():
        return rasterize(g.get_xyz, g.get_opacity, g.get_scaling,
                         g.get_rotation, cam, shs=g.shs, valid=g.valid,
                         settings=settings)["color"]


class RebinSetup:
    """The rebin probes' scene, cameras, real targets and loop inputs.

    The JAX probes draw the scene from ``RandomState(0)`` in the bench
    scene's order (means, opacities, rotations, log-scales, the DC then
    the rest of the SHs) and then the targets' 0.01·N(0, 1) offsets from
    the same stream. ``y_shift``: the views also move along y (the first
    probe's cameras; the other two move along x only)."""

    def __init__(self, args, dev, y_shift: bool):
        n, res = args.n, args.res
        rng = np.random.RandomState(0)
        xyz = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        opacity = rng.uniform(-2, 4, (n, 1)).astype(np.float32)
        rot = rng.normal(size=(n, 4)).astype(np.float32)
        rot /= np.linalg.norm(rot, axis=1, keepdims=True)
        scaling = rng.uniform(-5.5, -3.5, (n, 3)).astype(np.float32)
        shs = np.concatenate([
            rng.uniform(-1, 2, (n, 1, 3)),
            0.05 * rng.normal(size=(n, 15, 3))], 1).astype(np.float32)
        self.g = Gaussians.create(xyz, opacity, rot, scaling, shs,
                                  device=dev)
        offset = 0.01 * rng.normal(size=(n, 3)).astype(np.float32)
        g_t = replace(self.g, xyz=self.g.xyz + torch.from_numpy(offset).to(
            dev))
        cams = []
        for i in range(args.views):
            w2c = np.eye(4, dtype=np.float32)
            w2c[2, 3] = 5.0
            w2c[0, 3] = 0.25 * (i % 5 - 2)
            if y_shift:
                w2c[1, 3] = 0.25 * (i // 5 - 1.5)
            cams.append(Camera.from_w2c(w2c, 0.9, 0.9, height=res, width=res,
                                        device=dev))
        self.cam_list = cams
        self.cams = Camera.stack(cams)
        self.settings = RasterSettings(
            image_height=res, image_width=res, impl="pallas_packed",
            max_pairs=args.max_pairs, outputs="color", clamp_grads=False)
        self.gts = torch.stack([render(g_t, c, self.settings) for c in cams])
        self.order = [i % args.views for i in range(args.steps)]
        self.bg = torch.zeros(3, device=dev)
        self.state = init_refine_state(self.g, capacity=n)
        self.steps = args.steps

    def run(self, cfg: RefineConfig):
        """A function of a refine state: ``refine_run`` over the steps."""
        def loop(state):
            return refine_run(state, self.cams, self.gts, self.order,
                              self.bg, cfg, self.settings, 3.0, self.steps)
        return loop

    def psnr_v0(self, g: Gaussians) -> float:
        """View 0 of ``g`` against its target, in dB."""
        img = render(g, self.cam_list[0], self.settings)
        return float(-10 * torch.log10(torch.mean((img - self.gts[0]) ** 2)))


def timed_loop(pr: Probe, rs: RebinSetup, name: str, loop, args,
               quality: bool = True) -> None:
    """Time ``loop`` on the setup's state; with ``quality`` also run it
    once and record view 0's PSNR and the live rows (``n_valid``)."""
    t = timeit_device(loop, rs.state, K=args.K, iters=args.iters)
    rec = {"loop_s": t, "step_ms": t / rs.steps * 1e3}
    if quality:
        out = loop(rs.state)
        rec.update(psnr_v0=rs.psnr_v0(out.gaussians),
                   n_valid=int(out.gaussians.valid.sum()))
    pr.put(name, rec)


def main(argv=None) -> int:
    ap = parser(__doc__)
    refine_args(ap)
    args = ap.parse_args(argv)
    pr = Probe("bench_rebin", args)
    rs = RebinSetup(args, pr.dev, y_shift=True)
    for k in (1, 2, 4, 8):
        timed_loop(pr, rs, f"rebin_every={k}",
                   rs.run(RefineConfig(rebin_every=k)), args)
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
