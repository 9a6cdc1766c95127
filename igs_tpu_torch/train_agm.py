"""Train AGM-Net: the port's counterpart of ``train_agm.py`` (the
reference's main.py).

    python -m igs_tpu_torch.train_agm --config <yaml> [--max-steps N]
        [--capacity C] [--resume P] [--device cpu] [--impl pallas]
        [--max-per-tile M] [--ranks N] [--backend nccl|gloo] [--share-card]
        [a.b.c=value ...]

Data-parallel over the ranks, as the JAX CLI over its local devices: the
batch splits over the first gcd(batch_size, ranks) ranks, each taking its
slice of every step's items, and the gradients are averaged before the
clip (``train/driver.make_train_step(mesh=)``); only rank 0 writes the
checkpoints, the log and the eval images. The ranks are torchrun's group,
or else ``--ranks`` spawned ones (default: one per card present, one on
the CPU; ``parallel/launch.py``). Per step: the
whole AGM-Net forward with gradients, every output view of every batch
item rendered through the clamp rasterizer (±15 on the Gaussian
parameters' gradients, per view), L1 + λ·(1−SSIM), the backward, clip by
global norm, AdamW and OneCycle; with ``opt.lambda_lpips`` > 0 the LPIPS
term too, its VGG weights from ``opt.lpips_weights`` (a torch LPIPS
``state_dict``: lpipsPyTorch's or richzhang's names), else a seeded
random VGG with a warning. Checkpoints are torch files of the
``state_dict`` under the reference's parameter names (``<epoch>/
params.pth``, the optimizer state in ``params.pth.opt``). ``--resume``
takes those, a reference torch ``.bin``/``.pth``/``.pt``, or, by any
other suffix, the JAX package's flax ``params.msgpack``, whose
``params.msgpack.opt`` (optax's state) restores the optimizer; losses go to
``<workspace>/log.jsonl``, and an eval over the val items runs every
``eval_every`` epochs. ``run`` takes the config sections as plain dicts
and needs no PyYAML; the CLI reads the YAML and calls it.
``--impl pallas`` renders through the windowed route with
``--max-per-tile`` rows a tile; the default is the packed route.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from igs_tpu_torch.builders import (
    build_dataset, build_model, build_opt_config, build_raster_settings)
from igs_tpu_torch.config import ExperimentConfig, config_from_dict
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.ops.anchors import AnchorState, select_anchors
from igs_tpu_torch.parallel import distributed as D
from igs_tpu_torch.parallel.launch import run_ranked
from igs_tpu_torch.parallel.mesh import make_mesh
from igs_tpu_torch.train.driver import (
    host_snapshot, load_checkpoint, load_flax_checkpoint, make_optimizer,
    make_train_step, read_optimizer_state, run_guarded_step, save_checkpoint)
from igs_tpu_torch.train.losses import psnr as psnr_fn
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.resume import (
    is_port_checkpoint, merge_shape_checked, torch_weights)
from igs_tpu_torch.utils.cache import enable_persistent_cache
from igs_tpu_torch.utils.saving import save_image, save_runtime_code

CAPACITY_QUANTUM = 8192


def prep_batch(dataset, items, device, anchor_size: int, neighbor_k: int,
               cap: Optional[int] = None):
    """Collated items → (tensor batch, anchor states, Gaussians) on
    ``device``, the Gaussians padded to ``cap`` rows (default: the largest
    item's rows rounded up to a multiple of 8192) and the anchors selected
    per item."""
    batch = dataset.collate(items)
    caps = [g.num_capacity for g in batch["gs"]]
    cap = cap or (max(caps) + CAPACITY_QUANTUM - 1) // CAPACITY_QUANTUM \
        * CAPACITY_QUANTUM
    gs = [g.pad_to(cap).to(device) for g in batch["gs"]]
    states = [select_anchors(g.xyz, torch.as_tensor(b, device=device),
                             valid=g.valid, anchor_size=anchor_size,
                             k=neighbor_k)
              for g, b in zip(gs, batch["bounding_box"])]
    tbatch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
              if isinstance(v, np.ndarray)}
    return (tbatch, AnchorState(*(torch.stack(x) for x in zip(*states))),
            Gaussians.stack(gs))


def _concat(parts):
    """Concatenate prepared single-item batches along the batch axis."""
    batch = {k: torch.cat([p[0][k] for p in parts]) for k in parts[0][0]}
    state = AnchorState(*(torch.cat(x) for x in zip(*[p[1] for p in parts])))
    gs = Gaussians.stack([p[2] for p in parts]).map(
        lambda x: x.reshape((-1,) + x.shape[2:]))
    return batch, state, gs


def run(cfg: Union[ExperimentConfig, Dict[str, Any]],
        max_steps: Optional[int] = None, capacity: Optional[int] = None,
        resume: Optional[str] = None, device=None, impl: str = "auto",
        max_per_tile: int = 4096, generator: Optional[torch.Generator] = None,
        on_step: Optional[Callable[[int, Dict], None]] = None,
        on_stage: Optional[Callable[[str], None]] = None,
        ranks: int = 1, backend: Optional[str] = None,
        share_card: bool = False) -> Dict[str, Any]:
    """Train per the config's ``system``, ``data`` and ``opt`` sections.

    ``cfg``: an ExperimentConfig or a dict of the sections. Weights are
    random from ``generator`` (seed 0 when None) unless the backbone path
    or ``resume`` name weights. ``on_step(step, metrics)`` sees every
    step's metrics; ``on_stage`` is the train step's timing hook. Returns
    the model, the optimizer, the steps taken, the logged records, the
    eval PSNRs and the trained ``state_dict`` on the CPU; over more than
    one rank, rank 0's, its model and optimizer None (they stay in the
    ranks). ``ranks`` (default 1) is spawned when no group is up
    (``backend`` and ``share_card`` lay them out,
    ``parallel/launch.rank_plan``); spawned ranks take their arguments by
    pickling, so they take no ``on_step``/``on_stage``."""
    if not isinstance(cfg, ExperimentConfig):
        cfg = config_from_dict(dict(cfg))
    if ranks > 1 and (on_step is not None or on_stage is not None):
        raise ValueError("train_agm.run: on_step/on_stage need one rank "
                         f"(ranks={ranks}); spawned ranks cannot take "
                         "callbacks")
    return run_ranked(
        _train_rank, ranks,
        (cfg, max_steps, capacity, resume, impl, max_per_tile, generator,
         on_step, on_stage), device=None if device is None else str(device),
        backend=backend, share_card=share_card)


def _train_rank(rank: int, device, cfg: ExperimentConfig,
                max_steps: Optional[int], capacity: Optional[int],
                resume: Optional[str], impl: str, max_per_tile: int,
                generator: Optional[torch.Generator],
                on_step: Optional[Callable[[int, Dict], None]],
                on_stage: Optional[Callable[[str], None]]) -> Dict[str, Any]:
    """``run`` on this rank (or alone)."""
    dev = resolve_device(device)
    opt = cfg.opt
    world = D.process_count()
    writer = D.process_index() == 0
    workspace = opt.get("workspace", "logs/igs_tpu_torch/train")
    os.makedirs(workspace, exist_ok=True)
    if writer:
        with open(os.path.join(workspace, "experiment_config.json"),
                  "w") as f:
            json.dump({"opt": cfg.opt, "data": cfg.data,
                       "system": cfg.system}, f, indent=1)
        # source snapshot for reproducibility (train_agm.py:60-62)
        save_runtime_code(workspace)

    train_ds = build_dataset(cfg.data, training=True)
    model = build_model(cfg.system, device=dev, generator=generator,
                        train=True)
    ocfg = build_opt_config(opt)
    out_h = int(cfg.data["data"].get("output_height", 1014))
    out_w = int(cfg.data["data"].get("output_width", 1352))
    # opt.max_pairs: the pair budget per view (default ~2 per pixel)
    settings = build_raster_settings(out_h, out_w, clamp=True,
                                     max_pairs=int(opt.get("max_pairs", 0)),
                                     max_per_tile=max_per_tile, impl=impl)
    anchor_size = int(opt.get("anchor_size", 8192))
    neighbor_k = int(opt.get("neighbor_k", 8))
    batch_size = int(opt.get("batch_size", 4))
    # the data axis must divide the batch: the largest such rank count
    n_data = math.gcd(batch_size, world)
    mesh = (make_mesh(data=n_data, tile=1, ranks=range(n_data), device=dev)
            if world > 1 else None)
    per = batch_size // n_data
    lo = mesh.index("data") * per if mesh is not None and mesh.member else 0

    def prep(items, cap=None):
        return prep_batch(train_ds, items, dev, anchor_size, neighbor_k,
                          cap or capacity)

    # per-item prep cache for small datasets: PNG decode, PLY load and the
    # anchor selection of an item run once (the reference's DataLoader
    # workers amortise the same cost)
    cache: Dict[int, Any] = {}
    cache_items = len(train_ds) <= int(opt.get("prep_cache_max_items", 64))

    def prep_cached(idxs, cap):
        if not cache_items:
            return prep([train_ds[int(i)] for i in idxs], cap)
        for i in idxs:
            if int(i) not in cache:
                # one capacity across the cache so items concatenate; an
                # item needing more raises in pad_to (set --capacity)
                cache[int(i)] = prep([train_ds[int(i)]], cap)
        return _concat([cache[int(i)] for i in idxs])

    first = prep([train_ds[i] for i in range(batch_size)])
    train_cap = int(first[2].xyz.shape[1])
    del first

    gmflow = cfg.system.get("backbone", {}).get(
        "pretrained_model_name_or_path", "")
    if gmflow and os.path.exists(gmflow):
        n = merge_shape_checked(model, torch_weights(gmflow),
                                prefix="backbone.")
        print(f"loaded {n} GMFlow tensors from {gmflow}")

    start_epoch = int(opt.get("start_epoch", 0))
    resume = resume or opt.get("resume", "")
    if resume and os.path.exists(resume):
        # the format by suffix, as the JAX CLI: torch files, else flax's
        blob = (torch.load(resume, map_location="cpu", weights_only=False)
                if resume.endswith((".bin", ".pth", ".pt")) else None)
        if blob is None or is_port_checkpoint(blob):
            sd, step = (load_checkpoint(resume) if blob is not None else
                        load_flax_checkpoint(resume, model.state_dict()))
            model.load_state_dict(sd)
            print(f"resumed params from {resume} (step {step}, {len(sd)} "
                  "tensors)")
        else:
            sd = torch_weights(resume)
            ignore = list(cfg.system.get("weights_ignore_modules", []) or [])
            if ignore:
                sd = {k: v for k, v in sd.items()
                      if not any(k.startswith(m) for m in ignore)}
                print(f"ignoring modules on resume: {ignore}")
            n = merge_shape_checked(model, sd)
            print(f"resumed {n} tensors from torch ckpt {resume}")

    steps_per_epoch = max(len(train_ds) // batch_size, 1)
    total_steps = ocfg.num_epochs * steps_per_epoch
    optimizer, sched = make_optimizer(
        model, ocfg, total_steps,
        grad_accum=int(opt.get("gradient_accumulation_steps", 1)),
        train_backbone=model.train_backbone)
    resume_opt = opt.get("resume_opt", "")
    if resume and os.path.exists(resume + ".opt"):
        resume_opt = resume + ".opt"
    if resume_opt and os.path.exists(resume_opt):
        optimizer.load_state_dict(read_optimizer_state(resume_opt, optimizer))
        print(f"restored optimizer state from {resume_opt}")
    # the LPIPS term (the reference's main.py:216-219): converted VGG
    # weights from opt.lpips_weights, frozen, outside the model
    lpips = None
    if ocfg.lambda_lpips > 0:
        from igs_tpu_torch.train.lpips import load_lpips

        lp_path = opt.get("lpips_weights", "")
        lpips, n_lp = load_lpips(lp_path)
        if lp_path and os.path.exists(lp_path):
            print(f"loaded {n_lp} LPIPS tensors from {lp_path}")
        else:
            print("[WARN] lambda_lpips > 0 but no opt.lpips_weights — "
                  "LPIPS uses a random VGG")
        lpips = lpips.to(dev)
    step_fn = make_train_step(ocfg, settings, on_stage=on_stage, lpips=lpips,
                              mesh=mesh)

    log_path = os.path.join(workspace, "log.jsonl")
    records, eval_psnr = [], []
    global_step = start_epoch * steps_per_epoch
    snapshot_every = int(opt.get("crash_snapshot_every", 100))
    shadow = None
    rng = np.random.RandomState(0)
    done = False
    for epoch in range(start_epoch, ocfg.num_epochs):
        order = rng.permutation(len(train_ds))
        for it in range(steps_per_epoch):
            idxs = order[it * batch_size:(it + 1) * batch_size]
            if len(idxs) < batch_size:
                break
            if mesh is None or mesh.member:
                batch, anchor_state, gaussians = prep_cached(
                    idxs[lo:lo + per], train_cap)
            else:  # outside the data mesh: receives the update
                batch = anchor_state = gaussians = None
            t0 = time.time()
            if snapshot_every and global_step % snapshot_every == 0:
                shadow = host_snapshot(model, optimizer, global_step)
            metrics = run_guarded_step(step_fn, workspace, global_step, model,
                                       optimizer, batch, anchor_state,
                                       gaussians, shadow=shadow)
            global_step += 1
            if on_step is not None:
                on_step(global_step, metrics)
            if writer and (global_step % 10 == 0 or global_step == 1):
                rec = {"step": global_step, "epoch": epoch,
                       "loss": float(metrics["loss"]),
                       "psnr": float(metrics["psnr"]),
                       "lr": sched(global_step),
                       "sec/step": time.time() - t0}
                if "loss_lpips" in metrics:
                    rec["loss_lpips"] = float(metrics["loss_lpips"])
                print(rec)
                records.append(rec)
                with open(log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if max_steps and global_step >= max_steps:
                done = True
                break
        # opt.save_every (epochs) thins the checkpoints; the last epoch
        # and the step limit always save
        save_every = int(opt.get("save_every", 1))
        if writer and ((epoch % save_every) == 0
                       or epoch == ocfg.num_epochs - 1 or done):
            save_checkpoint(
                os.path.join(workspace, str(epoch), "params.pth"),
                model.state_dict(), optimizer.state_dict(), step=global_step)
        eval_every = int(opt.get("eval_every", 1))
        if writer and ((epoch % eval_every) == 0
                       or epoch == ocfg.num_epochs - 1):
            try:
                psnr = evaluate(model, cfg, settings, dev, batch_size,
                                anchor_size, neighbor_k,
                                os.path.join(workspace, str(epoch)))
            except Exception as e:  # eval must not kill training
                print(f"eval skipped: {e}")
            else:
                if psnr is not None:
                    rec = {"epoch": epoch, "eval_psnr": psnr}
                    print(rec)
                    eval_psnr.append(rec)
                    with open(log_path, "a") as f:
                        f.write(json.dumps({"step": global_step, **rec})
                                + "\n")
        if done:
            break
    if writer:
        print("training done:", global_step, "steps")
    out = {"steps": global_step, "records": records, "eval": eval_psnr,
           "settings": settings, "workspace": workspace,
           "state_dict": {k: v.detach().cpu()
                          for k, v in model.state_dict().items()}}
    out.update(model=model if world == 1 else None,
               optimizer=optimizer if world == 1 else None)
    return out


def evaluate(model, cfg: ExperimentConfig, settings, device, batch_size: int,
             anchor_size: int, neighbor_k: int, out_dir: str):
    """Mean PSNR over the whole val split (a ragged last batch padded with
    its last item); the first item's first view saved to ``out_dir``."""
    eval_cfg = dict(cfg.data)
    eval_cfg["data"] = dict(cfg.data["data"], load_gs_per_item=True)
    test_ds = build_dataset(eval_cfg, training=False)
    psnrs = []
    for i0 in range(0, len(test_ds), batch_size):
        n_real = min(i0 + batch_size, len(test_ds)) - i0
        items = [test_ds[i] for i in range(i0, i0 + n_real)]
        items += [items[-1]] * (batch_size - n_real)
        batch, state, gs = prep_batch(test_ds, items, device, anchor_size,
                                      neighbor_k)
        with torch.no_grad():
            pred = torch.clamp(model(batch, state, gs, settings)[
                "images_pred"], 0, 1)
        gt = batch["images_output"]
        for b in range(n_real):
            psnrs.append(float(psnr_fn(pred[b], gt[b])))
        if i0 == 0:
            save_image(os.path.join(out_dir, "eval_pred.png"),
                       pred[0, 0].cpu().numpy())
            save_image(os.path.join(out_dir, "eval_gt.png"),
                       gt[0, 0].cpu().numpy())
    return float(np.mean(psnrs)) if psnrs else None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--capacity", type=int, default=None,
                    help="static Gaussian capacity (default: round up max N)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint to resume from: this port's params.pth, "
                         "a reference torch .bin/.pth (shape-checked partial "
                         "load) or the JAX package's params.msgpack")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--impl", default="auto",
                    choices=("auto", "pallas_packed", "pallas"),
                    help="rasterizer route (auto: the packed one)")
    ap.add_argument("--max-per-tile", type=int, default=4096,
                    help="window rows per tile of the pallas route")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to spawn when no group is up (default: one "
                         "per card; 1 on the CPU)")
    ap.add_argument("--backend", default=None, choices=D.BACKENDS,
                    help="process-group backend (default: nccl)")
    ap.add_argument("--share-card", action="store_true",
                    help="run every rank on the one card --device names "
                         "(needs --backend gloo)")
    args, extras = ap.parse_known_args(argv)
    enable_persistent_cache()

    from igs_tpu_torch.config import dump_config, load_config

    cfg = load_config(args.config, cli_args=extras)
    workspace = cfg.opt.get("workspace", "logs/igs_tpu_torch/train")
    os.makedirs(workspace, exist_ok=True)
    dump_config(os.path.join(workspace, "experiment_config.yaml"), cfg)
    ranks = args.ranks
    if ranks is None:  # one per card, as the JAX CLI takes its devices
        on_card = torch.device(args.device or "cuda").type == "cuda"
        ranks = max(torch.cuda.device_count() if on_card else 0, 1)
    run(cfg, max_steps=args.max_steps, capacity=args.capacity,
        resume=args.resume, device=args.device, impl=args.impl,
        max_per_tile=args.max_per_tile, ranks=ranks,
        backend=args.backend, share_card=args.share_card)


if __name__ == "__main__":
    main()
