"""Driver entry points: a one-card forward check and a multi-rank dry run.

Counterpart of the repo-root ``__graft_entry__.py``. ``entry()`` returns
the flagship model's forward step (AGM-Net: GMFlow backbone → motion
transformer → anchor encoder → residual decode → Gaussian rasterization)
at the JAX entry's tiny shapes, with its example arguments.

``dryrun_multichip(n)`` runs the JAX dry run's four phases over ``n``
ranks with the port's ``parallel/`` package:

1. one data-parallel train step (forward, backward, clip, AdamW,
   OneCycle) on a (data, tile) mesh, the gradients averaged over
   ``data`` (``train/driver.make_train_step(mesh=)``);
2. the streaming AGM forward with the candidates sharded over ``data``
   (``parallel/spmd.sharded_agm_apply``) on the packed kernels, color
   outputs then color_depth depth renders;
3. the key-frame refine with each render split in tile-row strips over
   ``tile`` (``stream/refine.refine_run_sharded``), densify every step;
4. the frame-0 sweep over ``n`` frames, the frames split over the ranks
   (``build_frame0.train_frames_spmd``).

Each phase prints the JAX dry run's line and asserts finite results. The
ranks are torchrun's group, or else ``n`` spawned ones
(``parallel/launch``): NCCL with one card a rank by default, gloo on the
CPU or, with ``share_card``, on one card.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.models.convert import load_flax_params
from igs_tpu_torch.models.networks import init_weights
from igs_tpu_torch.ops.anchors import AnchorState, select_anchors
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.parallel import distributed as D
from igs_tpu_torch.parallel.launch import run_ranked
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.profiling import kernel_launches

TINY_MODEL = dict(feature_channels=32, backbone_layers=1, encoder_layers=1,
                  encoder_heads=2, encoder_head_dim=16,
                  local_ray=False)  # the shipped train.yaml conditioning


def tiny_inputs(b: int = 1, v: int = 2, vout: int = 1, hw: int = 32,
                n: int = 128, a: int = 32, seed: int = 0, device=None):
    """(batch, anchor state, Gaussians), each with a leading batch axis of
    ``b``: the JAX entry's ``_tiny_inputs``, the same numpy draws in the
    same order."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    opacity = rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    scaling = rng.uniform(-3.0, -2.0, (n, 3)).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1, 1, (n, 3))
    g = Gaussians.create(xyz, opacity, rot, scaling, shs, device=dev)
    bbox = torch.tensor([[-2.0, -2, -2], [2.0, 2, 2]], device=dev)
    state1 = select_anchors(g.xyz, bbox, valid=g.valid, anchor_size=a, k=4)
    state = AnchorState(*(torch.stack([x] * b) for x in state1))
    gaussians = g.map(lambda x: torch.stack([x] * b))

    c2w = np.tile(np.eye(4, dtype=np.float32), (b, max(v, vout), 1, 1))
    c2w[:, :, 2, 3] = -4.0
    h8 = hw // 8 * 2
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    batch = {
        "cur_images_input": f32(rng.uniform(0, 1, (b, v, 3, hw, hw))),
        "next_images_input": f32(rng.uniform(0, 1, (b, v, 3, hw, hw))),
        "depth": f32(rng.uniform(2, 6, (b, v, hw, hw))),
        "local_rays": f32(rng.normal(size=(b, h8, h8, 3))),
        "rays": f32(rng.normal(size=(b, v, h8, h8, 6))),
        "FOV": f32(np.full((b, 2), 0.8)),
        "c2w_input": f32(c2w[:, :v]),
        "c2w_output": f32(c2w[:, :vout]),
        "background_color": f32(np.zeros((b, 3))),
        "images_output": f32(rng.uniform(0, 1, (b, vout, 3, hw, hw))),
    }
    return batch, state, gaussians


def tiny_model_and_settings(hw: int = 32, device=None,
                            flax_params: Optional[Mapping] = None
                            ) -> Tuple[AGMNet, RasterSettings]:
    """The entry's AGM-Net (eval mode) and its render settings. Weights:
    the JAX package's flax params when given (``models/convert``), else
    random from a generator seeded with 0 (the same on every rank)."""
    model = AGMNet(**TINY_MODEL)
    if flax_params is not None:
        load_flax_params(model, flax_params)
    else:
        init_weights(model, torch.Generator().manual_seed(0))
    settings = RasterSettings(
        image_height=hw, image_width=hw, impl="tiles", max_pairs=1 << 13,
        max_per_tile=128, chunk=64, clamp_grads=True)
    return model.to(resolve_device(device)).eval(), settings


def entry(device=None, flax_params: Optional[Mapping] = None
          ) -> Tuple[Callable, tuple]:
    """(fn, example_args): ``fn(model, batch, state, gaussians)`` is the
    AGM-Net forward step, returning (images_pred, depth_pred); the
    arguments are the model and the tiny inputs on ``device`` (the card
    unless told)."""
    batch, state, gaussians = tiny_inputs(device=device)
    model, settings = tiny_model_and_settings(device=device,
                                              flax_params=flax_params)

    def fn(model, batch, state, gaussians):
        with torch.no_grad():
            out = model(batch, state, gaussians, settings)
        return out["images_pred"], out["depth_pred"]

    return fn, (model, batch, state, gaussians)


def _random_gaussians(n: int, seed: int, device) -> Gaussians:
    """The JAX dry run's refine Gaussians (``tests/conftest.
    random_gaussians``): the same draws, in the cube [-1, 1]³."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    opacity = rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    scaling = rng.uniform(-3.2, -1.8, (n, 3)).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1.5, 1.5, (n, 3))
    shs[:, 1:] = 0.12 * rng.normal(size=(n, 15, 3))
    return Gaussians.create(xyz, opacity, rot, scaling, shs, device=device)


def _write_frames(root: str, frames: int, res: int, w2c: np.ndarray,
                  fov: float, seed: int) -> List[str]:
    """``frames`` frame directories as ``build_frame0`` reads them: two
    views of one camera at ``res``², random images, 48 seeded points."""
    from igs_tpu_torch.data.images import write_png

    rng = np.random.RandomState(seed)
    c2w = np.linalg.inv(w2c)
    focal = res / (2 * np.tan(fov / 2))
    dirs = []
    for f in range(frames):
        d = os.path.join(root, f"colmap_{f}")
        os.makedirs(os.path.join(d, "images_512"), exist_ok=True)
        cams = []
        for v in range(2):
            name = f"cam{v:02d}"
            cams.append({"id": v, "img_name": name, "width": res,
                         "height": res, "position": c2w[:3, 3].tolist(),
                         "rotation": c2w[:3, :3].tolist(), "fx": focal,
                         "fy": focal})
            write_png(os.path.join(d, "images_512", name + ".png"),
                      rng.randint(0, 256, (res, res, 3)).astype(np.uint8))
        with open(os.path.join(d, "cameras.json"), "w") as fh:
            json.dump(cams, fh)
        np.savez(os.path.join(d, "points3D.npz"),
                 xyz=rng.uniform(-1, 1, (48, 3)).astype(np.float32),
                 rgb=rng.randint(0, 256, (48, 3)).astype(np.uint8))
        dirs.append(d)
    return dirs


def _dryrun_rank(rank: int, device, n: int, workdir: str,
                 share_card: bool) -> dict:
    """The four phases on this rank: the lines rank 0 prints, and every
    rank's kernel launches (``utils/profiling.kernel_launches``) in rank
    order. ``share_card``: every rank on ``device``, as the sweep must
    know."""
    from igs_tpu_torch import build_frame0
    from igs_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from igs_tpu_torch.parallel.spmd import sharded_agm_apply
    from igs_tpu_torch.stream.refine import (
        RefineConfig, init_refine_state, refine_run_sharded)
    from igs_tpu_torch.train.driver import (
        OptConfig, make_optimizer, make_train_step)
    from igs_tpu_torch.train.frame0 import Frame0Config

    dev = resolve_device(device)
    lines = []

    # phase 1: one data-parallel train step on a (data, tile) mesh
    tile = 2 if n % 2 == 0 and n > 1 else 1
    data = n // tile
    mesh = make_mesh(data=data, tile=tile, device=dev)
    batch, state, gaussians = tiny_inputs(b=data, device=dev)
    model, settings = tiny_model_and_settings(device=dev)
    model.train()
    cfg = OptConfig(warmup_steps=1)
    optimizer, _ = make_optimizer(model, cfg, total_steps=10)
    step = make_train_step(cfg, settings, mesh=mesh)
    metrics = step(model, optimizer, shard_batch(mesh, batch),
                   shard_batch(mesh, state), shard_batch(mesh, gaussians))
    loss, psnr = float(metrics["loss"]), float(metrics["psnr"])
    if not np.isfinite(loss):
        raise AssertionError("non-finite loss in dryrun")
    lines.append(f"dryrun_multichip OK: mesh={mesh.shape} loss={loss:.4f} "
                 f"psnr={psnr:.2f}")

    # phase 2: the streaming AGM forward on the packed kernels, the
    # candidates sharded over the data axis
    mesh2 = make_mesh(data=n, tile=1, device=dev)
    batch2, state2, gaussians2 = tiny_inputs(b=n, vout=2, device=dev)
    p_settings = settings._replace(impl="pallas_packed", outputs="color",
                                   chunk=64)
    d_settings = p_settings._replace(image_height=16, image_width=16,
                                     outputs="color_depth")
    model2, _ = tiny_model_and_settings(device=dev)
    fn = sharded_agm_apply(model2, p_settings, d_settings, mesh2)
    with torch.no_grad():
        out = fn(batch2, state2, gaussians2)
    if not bool(torch.isfinite(out["images_pred"]).all()):
        raise AssertionError("non-finite images in the sharded forward")
    lines.append("dryrun_multichip pallas-sharded OK: images "
                 f"{tuple(out['images_pred'].shape)}")

    # phase 3: the strip-sharded key-frame refine, densify every step
    res = 32
    tile_n = min(n, res // 16)
    mesh3 = make_mesh(data=n // tile_n, tile=tile_n, device=dev)
    rng = np.random.RandomState(0)
    g3 = _random_gaussians(64, seed=2, device=dev)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 4.0
    cam3 = Camera.from_w2c(w2c, 0.9, 0.9, height=res, width=res, device=dev)
    cams3 = Camera.stack([cam3, cam3])
    gts3 = torch.tensor(rng.uniform(0, 1, (2, 3, res, res)),
                        dtype=torch.float32, device=dev)
    rset = p_settings._replace(image_height=res, image_width=res,
                               max_pairs=1 << 12, clamp_grads=False)
    st3 = refine_run_sharded(
        init_refine_state(g3, capacity=128), cams3, gts3, [0, 0],
        torch.zeros(3, device=dev),
        RefineConfig(use_densify=True, densification_interval=1), rset,
        3.0, 2, mesh3, axis="tile")
    if not bool(torch.isfinite(st3.gaussians.xyz).all()):
        raise AssertionError("non-finite Gaussians after the sharded refine")
    lines.append(f"dryrun_multichip sharded-refine OK: mesh={mesh3.shape}")

    # phase 4: the frame-0 sweep, n frames over the ranks. Rank 0 writes
    # the frames, then sends its directory (the send orders the reads
    # after the writes)
    frame_dirs = [None] * n
    if D.process_index() == 0:
        frame_dirs = _write_frames(workdir, n, res, w2c, 0.9, seed=4)
    if D.process_count() > 1:
        torch.distributed.broadcast_object_list(frame_dirs, src=0)
    f0 = Frame0Config(iterations=2, densification_interval=1,
                      densify_grad_threshold=1e-6, densify_from_iter=0,
                      z_cull_min=None)
    records = build_frame0.train_frames_spmd(
        frame_dirs, "images_512", "sweep", 2, 0.45, 64, n_devices=n,
        finetune_iters=2, device=str(dev), max_pairs=1 << 12,
        share_card=share_card, cfg=f0)
    for rec in records:
        if not np.isfinite(rec["losses"] + rec["finetune_losses"]).all():
            raise AssertionError("non-finite loss in the frame-0 sweep")
    mesh4 = make_mesh(data=n, tile=1, device=dev)
    lines.append(f"dryrun_multichip frame0-sweep OK: {n} frames over "
                 f"mesh={mesh4.shape}")
    launches = [kernel_launches()]
    if D.process_count() > 1:
        launches = [None] * D.process_count()
        torch.distributed.all_gather_object(launches, kernel_launches())
    return {"lines": lines, "launches": launches}


def run_dryrun(n_devices: int, device=None, backend: Optional[str] = None,
               share_card: bool = False, timeout_s: float = 600.0) -> dict:
    """The four phases over ``n_devices`` ranks: {"lines": rank 0's lines,
    "launches": each rank's kernel launches}. ``device`` "cpu" runs gloo
    ranks on the CPU; ``backend`` "gloo" with ``share_card`` puts every
    rank on one card."""
    if device is not None and torch.device(device).type == "cpu":
        backend = backend or "gloo"
    with tempfile.TemporaryDirectory(prefix="igs_dryrun_") as work:
        return run_ranked(_dryrun_rank, n_devices,
                          (n_devices, work, share_card),
                          device=None if device is None else str(device),
                          backend=backend, share_card=share_card,
                          timeout_s=timeout_s)


def dryrun_multichip(n_devices: int, device=None,
                     backend: Optional[str] = None, share_card: bool = False,
                     timeout_s: float = 600.0) -> List[str]:
    """``run_dryrun``, printing (and returning) rank 0's lines."""
    lines = run_dryrun(n_devices, device, backend, share_card,
                       timeout_s)["lines"]
    if D.process_index() == 0:
        for line in lines:
            print(line, flush=True)
    return lines

