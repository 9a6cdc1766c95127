"""AGM-Net training driver: loss, clip by global norm, AdamW, OneCycle.

Counterpart of ``igs_tpu/train/driver.py``, on one device or data-parallel
over the ``data`` axis of a mesh of ranks:
  * loss = λ_rgb·L1 + λ_ssim·(1−SSIM) + λ_lpips·LPIPS over every rendered
    output view, the L1 logged under ``loss_mse`` as the reference does;
    the LPIPS term compares the GT and the render ×2−1, resized to 256²
    with an antialiased bilinear filter, as ``jax.image.resize`` resizes
    them (ROADMAP C22), through a frozen float32 ``train/lpips.LPIPS``
    outside the model;
  * the gradient clipped by its global norm, then AdamW (b1 0.9, b2 0.95,
    eps 1e-8, decoupled weight decay 0.05) with the OneCycle learning
    rate, over the trainable parameters only: the GMFlow backbone stays
    frozen unless the model trains it;
  * ``gradient_accumulation_steps`` > 1 averages that many gradients
    before one update (optax ``MultiSteps``);
  * data-parallel (``make_train_step(mesh=)``): each rank of the axis runs
    its slice of the batch; the gradients are averaged over the axis
    before the clip, so the clip sees the whole batch's gradient, as the
    JAX step's compiler-placed psum; the losses are averaged and
    ``overflow_tiles`` takes the largest. Ranks outside the mesh receive
    the averaged gradient and take the same update;
  * ``mixed_precision`` "bf16" (or "fp16", which runs as bf16): the
    forward runs on bf16 copies of the float32 parameters with the two
    image inputs cast, as the JAX step casts its parameter tree; the
    gradients flow back through the cast into float32 and the optimizer
    state stays float32. Each layer then computes in the promotion of its
    input's and its parameters' types (``models/networks.py``), so the
    CNN encoder runs in bf16 and the layers after its float32 output run
    in float32 on the rounded weights, as in the JAX package; the
    residuals reach the rasterizer in float32. ``torch.autocast`` is not
    used: its per-op lists are not the JAX package's numerics.

Checkpoints are torch files (``save_checkpoint``); the JAX package's flax
files load too: ``load_flax_checkpoint`` reads a ``params.msgpack`` and
``optimizer_state_from_flax`` maps its ``.opt`` (optax's state) onto
``Optimizer``; ``flax_optimizer_state`` writes that layout back.

The optimizer is written out after optax's operation order rather than
taken from ``torch.optim``: optax clips with ``(g / ‖g‖) · max`` (torch's
``clip_grad_norm_`` adds 1e-6 to the norm), reads the schedule at the
count of updates already applied, and adds ``wd · p`` to the Adam
direction before the learning rate scales it. The parity tests hold the
schedule and one update to optax.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from igs_tpu_torch.models.convert import (
    flax_from_state_dict, state_dict_from_flax)
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.parallel import distributed as D
from igs_tpu_torch.train.losses import l1_loss, psnr as psnr_fn, ssim
from igs_tpu_torch.train.lpips import LPIPS
from igs_tpu_torch.utils import flax_msgpack
from igs_tpu_torch.utils.profiling import span

LPIPS_RES = 256  # the LPIPS term's square input size


@dataclass
class OptConfig:
    """The reference's main.py OptConfig defaults."""

    lr: float = 4e-4
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    num_epochs: int = 30
    warmup_steps: int = 3000
    gradient_clip: float = 1.0
    lambda_rgb: float = 1.0
    lambda_ssim: float = 0.2
    lambda_lpips: float = 0.0
    mixed_precision: str = "no"


def onecycle_schedule(max_lr: float, total_steps: int,
                      warmup_steps: int = 3000) -> Callable[[int], float]:
    """optax ``cosine_onecycle_schedule`` (torch OneCycleLR's cosine
    anneal): from max_lr/25 up to max_lr over the warm-up, then down to
    max_lr/25e4 at ``total_steps``, constant after."""
    warmup_steps = min(warmup_steps, max(total_steps - 1, 1))
    pct_start = warmup_steps / total_steps
    div, final_div = 25.0, 1e4
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    # optax's cumulative product of (init, div, 1 / (div · final_div))
    v0 = max_lr / div
    v1 = v0 * div
    values = (v0, v1, v1 * (1.0 / (div * final_div)))

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct)
                                                    + 1)
        return values[2] if count >= bounds[2] else 0.0

    return schedule


def trainable_parameters(model: torch.nn.Module,
                         train_backbone: bool = False
                         ) -> Dict[str, torch.nn.Parameter]:
    """Name → parameter of what the optimizer updates: everything but the
    GMFlow backbone, unless ``train_backbone``."""
    return {name: p for name, p in model.named_parameters()
            if train_backbone or "backbone" not in name}


class Optimizer:
    """``optax.chain(clip_by_global_norm(clip), adamw(schedule, ...))`` over
    a name → parameter dict, in optax's operation order; with
    ``grad_accum`` > 1, ``optax.MultiSteps`` around it. ``step()`` reads
    the parameters' ``.grad`` (None counts as zero)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: OptConfig,
                 schedule: Callable[[int], float], grad_accum: int = 1):
        self.params = dict(params)
        self.cfg = cfg
        self.schedule = schedule
        self.grad_accum = grad_accum
        self.count = 0  # updates applied
        self.mini_step = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.acc = ({k: torch.zeros_like(p) for k, p in self.params.items()}
                    if grad_accum > 1 else None)

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> Dict[str, float]:
        """One optimizer call: returns the global norm of the gradient it
        applied (before clipping), the learning rate, and whether the
        parameters moved (MultiSteps moves them every ``grad_accum``-th
        call)."""
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        if self.acc is not None:
            n = self.mini_step
            for k, g in grads.items():
                self.acc[k] = (g + n * self.acc[k]) / (n + 1)
            if n < self.grad_accum - 1:
                self.mini_step += 1
                return {"grad_norm": float("nan"),
                        "lr": self.schedule(self.count), "updated": False}
            grads = self.acc
            self.acc = {k: torch.zeros_like(g) for k, g in grads.items()}
            self.mini_step = 0
        cfg = self.cfg
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if not bool(norm < cfg.gradient_clip):
            grads = {k: (g / norm) * cfg.gradient_clip
                     for k, g in grads.items()}
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - cfg.beta1 ** self.count
        bc2 = 1.0 - cfg.beta2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            mu = (1 - cfg.beta1) * g + cfg.beta1 * self.mu[k]
            nu = (1 - cfg.beta2) * (g * g) + cfg.beta2 * self.nu[k]
            self.mu[k], self.nu[k] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)
            u = u + cfg.weight_decay * p
            p.add_(-lr * u)
        return {"grad_norm": float(norm), "lr": lr, "updated": True}

    def state_dict(self) -> Dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    def load_state_dict(self, state: Dict) -> None:
        dev = next(iter(self.params.values())).device

        def on(d):
            return None if d is None else {k: v.to(dev) for k, v in d.items()}

        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.mu, self.nu, self.acc = on(state["mu"]), on(state["nu"]), on(
            state["acc"])


def make_optimizer(model: torch.nn.Module, cfg: OptConfig, total_steps: int,
                   grad_accum: int = 1, train_backbone: bool = False):
    """(Optimizer over the trainable parameters, the schedule)."""
    sched = onecycle_schedule(cfg.lr, total_steps, cfg.warmup_steps)
    return Optimizer(trainable_parameters(model, train_backbone), cfg, sched,
                     grad_accum), sched


def lpips_prep(img: torch.Tensor) -> torch.Tensor:
    """(B, V, 3, H, W) in [0, 1] → (B·V, 3, 256, 256) in [-1, 1]: the JAX
    term's ``jax.image.resize(method="bilinear")``, which antialiases a
    downsample (ROADMAP C22)."""
    flat = img.reshape(-1, *img.shape[2:]) * 2.0 - 1.0
    return F.interpolate(flat, size=(LPIPS_RES, LPIPS_RES), mode="bilinear",
                         align_corners=False, antialias=True)


def compute_loss(out: Dict, gt_images: torch.Tensor, cfg: OptConfig,
                 lpips_fn: Optional[LPIPS] = None,
                 on_stage: Optional[Callable[[str], None]] = None):
    """The reference's main.py loss over (B, V, 3, H, W) renders →
    (loss, metrics). The LPIPS term runs when ``lambda_lpips`` > 0 and
    ``lpips_fn`` is given: ``lpips_fn(prep(gt), prep(pred))``, its mean
    under ``loss_lpips``. ``on_stage`` (a timing hook) is called with
    "loss" after the other terms, then with "lpips" after the LPIPS
    forward and "lpips_backward" when the backward has passed through
    it."""
    mark = on_stage or (lambda name: None)
    pred = out["images_pred"]
    loss = 0.0
    metrics = {}
    if cfg.lambda_rgb > 0:
        # the reference logs the L1 under "loss_mse"; kept so the logs line
        # up — it is not an MSE
        lm = l1_loss(pred, gt_images)
        metrics["loss_mse"] = lm
        loss = loss + cfg.lambda_rgb * lm
    if cfg.lambda_ssim > 0:
        s, _ = ssim(pred.reshape(-1, *pred.shape[2:]),
                    gt_images.reshape(-1, *gt_images.shape[2:]))
        metrics["loss_ssim"] = 1.0 - s
        loss = loss + cfg.lambda_ssim * (1.0 - s)
    mark("loss")
    if cfg.lambda_lpips > 0 and lpips_fn is not None:
        lpips_fn = lpips_fn.to(pred.device)
        y = lpips_prep(pred)
        if on_stage is not None and y.requires_grad:
            y.register_hook(lambda g: mark("lpips_backward"))
        # the GT side needs no gradient: with the frozen module autograd
        # records only the render's side
        ll = torch.mean(lpips_fn(lpips_prep(gt_images), y))
        metrics["loss_lpips"] = ll
        loss = loss + cfg.lambda_lpips * ll
        mark("lpips")
    metrics["psnr"] = psnr_fn(pred.detach(), gt_images)
    metrics["loss"] = loss
    return loss, metrics


def _average_over_mesh(mesh, optimizer, metrics):
    """The gradients (``.grad`` of the optimizer's parameters, None as
    zero) and the loss metrics averaged over ``mesh``'s data axis, the
    overflow its largest; ranks outside the mesh receive them. One
    collective for all the gradients."""
    params = optimizer.params
    out = None
    if mesh.member:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params.values()]
        flat = mesh.mean(torch.cat([g.reshape(-1) for g in grads]), "data")
        losses = {k: v for k, v in metrics.items()
                  if torch.is_tensor(v) and k != "overflow_tiles"}
        vals = mesh.mean(torch.stack([losses[k].float() for k in losses]),
                         "data")
        out = (flat, dict(zip(losses, vals.unbind(0))),
               mesh.max(metrics["overflow_tiles"].reshape(1), "data")[0])
    flat, losses, overflow = mesh.give_to_all(out)
    for p, g in zip(params.values(), flat.split(
            [p.numel() for p in params.values()])):
        p.grad = g.reshape(p.shape).to(p.dtype)
    return dict(losses, overflow_tiles=overflow)


def make_train_step(cfg: OptConfig, settings: RasterSettings,
                    on_stage: Optional[Callable[[str], None]] = None,
                    lpips: Optional[LPIPS] = None, mesh=None):
    """The train step ``(model, optimizer, batch, anchor_state, gaussians)
    → metrics``: forward with gradients, loss, backward, one optimizer
    call. ``metrics`` holds detached tensors (loss, loss_mse, loss_ssim,
    loss_lpips, psnr, the largest ``overflow_tiles``) and the optimizer's
    grad_norm, lr and updated. ``on_stage(name)`` is called with "start"
    and after each of "forward", "loss", ("lpips", "lpips_backward",)
    "backward" and "optimizer" (a timing hook). Under a profiler the
    stages between those marks are the spans ``igs:train.forward``,
    ``igs:train.loss``, ``igs:train.backward`` and ``igs:optim``.

    ``lpips``: the frozen LPIPS of the term when ``lambda_lpips`` > 0; a
    seeded random one, with a warning, when it is not given (the JAX
    package's ``make_train_step``). It runs in float32 under
    ``mixed_precision`` too, as the JAX step closes over its float32
    parameters outside the bf16 cast.

    ``mesh``: data-parallel over its ``data`` axis (``parallel/mesh.py``).
    Each member passes its slice of the batch; the gradients and metrics
    are averaged over the axis before the optimizer (the ``all-reduce``
    mark), and ranks outside the mesh pass None for the batch."""
    mark = on_stage or (lambda name: None)
    half = (torch.bfloat16 if cfg.mixed_precision in ("fp16", "bf16")
            else None)
    if cfg.lambda_lpips > 0 and lpips is None:
        import warnings

        warnings.warn(
            "lambda_lpips > 0 without LPIPS weights: using a randomly "
            "initialized VGG — pass converted weights for a real LPIPS")
        lpips = LPIPS(generator=torch.Generator().manual_seed(0))

    def forward(model, batch, anchor_state, gaussians):
        if half is None:
            return model(batch, anchor_state, gaussians, settings)
        params = {k: p.to(half) if p.dtype == torch.float32 else p
                  for k, p in model.named_parameters()}
        batch = dict(batch)
        for k in ("cur_images_input", "next_images_input"):
            batch[k] = batch[k].to(half)
        return functional_call(model, params,
                               (batch, anchor_state, gaussians, settings))

    def step(model, optimizer, batch, anchor_state, gaussians):
        mark("start")
        optimizer.zero_grad()
        metrics = {}
        if mesh is None or mesh.member:
            with span("train.forward"):
                out = forward(model, batch, anchor_state, gaussians)
            mark("forward")
            with span("train.loss"):
                loss, metrics = compute_loss(out, batch["images_output"],
                                             cfg, lpips_fn=lpips,
                                             on_stage=mark)
            with span("train.backward"):
                loss.backward()
            mark("backward")
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["overflow_tiles"] = out["overflow_tiles"].max().detach()
        if mesh is not None and D.process_count() > 1:
            metrics = _average_over_mesh(mesh, optimizer, metrics)
            mark("all-reduce")
        with span("optim"):
            metrics.update(optimizer.step())
        mark("optimizer")
        return metrics

    return step


def run_guarded_step(step_fn, workspace: str, global_step: int, model,
                     optimizer, *step_args, shadow=None):
    """One train step; on failure save the state to
    ``<workspace>/crash/params.pth`` (or the ``shadow`` snapshot when the
    live save fails too) and re-raise — the reference's save-on-error
    (main.py:278-287). ``--resume`` restores it. Over several ranks only
    rank 0 saves."""
    try:
        return step_fn(model, optimizer, *step_args)
    except Exception:
        if D.process_index() != 0:
            raise
        path = os.path.join(workspace, "crash", "params.pth")
        print(f"train step failed at step {global_step}; saving state to "
              f"{os.path.dirname(path)}")
        try:
            save_checkpoint(path, model.state_dict(), optimizer.state_dict(),
                            step=global_step)
        except Exception as e:
            print(f"live crash-save failed ({e})")
            if shadow is not None:
                save_checkpoint(path, *shadow)
                print(f"saved shadow snapshot from step {shadow[2]}")
        raise


def host_snapshot(model, optimizer, step: int):
    """(state_dict, optimizer state, step) copied to the host: the
    fallback of ``run_guarded_step`` when the live state cannot be saved."""
    def host(x):
        if torch.is_tensor(x):
            return x.detach().cpu().clone()
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        return x

    return host(model.state_dict()), host(optimizer.state_dict()), step


def save_checkpoint(path: str, state_dict, opt_state=None, step: int = 0):
    """A torch file ``{"params": state_dict, "step": step}`` under the
    reference's parameter names, and the optimizer state beside it in
    ``<path>.opt``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"params": {k: v.detach().cpu() for k, v in
                           state_dict.items()}, "step": step}, path)
    if opt_state is not None:
        torch.save(opt_state, path + ".opt")


def load_checkpoint(path: str):
    """(state_dict, step) of a ``save_checkpoint`` file."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob["params"], int(blob["step"])


def _check_against(sd: Mapping[str, torch.Tensor],
                   template: Mapping[str, torch.Tensor], what: str) -> None:
    """Raise on a missing or an extra name, or a shape that differs (what
    flax's ``from_bytes`` with a template refuses)."""
    missing = sorted(set(template) - set(sd))
    extra = sorted(set(sd) - set(template))
    if missing or extra:
        raise KeyError(f"{what}: missing {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}, extra "
                       f"{extra[:8]}{' ...' if len(extra) > 8 else ''}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(template[k].shape):
            raise ValueError(f"{what}: {k} has shape {tuple(v.shape)}, the "
                             f"model {tuple(template[k].shape)}")


def load_flax_checkpoint(path: str, template: Optional[Mapping] = None):
    """(state_dict, step) of the JAX package's ``params.msgpack``
    (``igs_tpu/train/driver.py`` ``save_checkpoint``: ``{"params": params,
    "step": step}`` in flax's format), through ``state_dict_from_flax``.
    With ``template`` (a model's ``state_dict``) every name and shape must
    match it."""
    blob = flax_msgpack.load(path)
    if not isinstance(blob, dict) or set(blob) != {"params", "step"}:
        raise ValueError(f"{path}: not a flax checkpoint of the JAX "
                         "package's layout {params, step}")
    sd = state_dict_from_flax(blob["params"])
    if template is not None:
        _check_against(sd, template, path)
    return sd, int(blob["step"])


def _adam_state(tree: Mapping, grad_accum: int):
    """optax's state of ``igs_tpu/train/driver.make_optimizer``: MultiSteps
    (when accumulating) around masked (when the backbone is frozen) around
    chain(clip_by_global_norm, chain(scale_by_adam, add_decayed_weights,
    scale_by_schedule)) → (adam state, schedule count, MultiSteps' state
    or None)."""
    multi = None
    if "mini_step" in tree:
        multi, tree = tree, tree["inner_opt_state"]
    if (multi is None) != (grad_accum == 1):
        raise ValueError(f"optimizer state {'with' if multi else 'without'}"
                         f" MultiSteps, but gradient_accumulation_steps is "
                         f"{grad_accum}")
    if "inner_state" in tree:  # optax.masked
        tree = tree["inner_state"]
    try:
        adam = {k: tree["1"]["0"][k] for k in ("count", "mu", "nu")}
        sched_count = int(tree["1"]["2"]["count"])
    except (KeyError, TypeError) as e:
        raise ValueError("not the optax state of clip_by_global_norm → "
                         f"adamw(schedule): no {e}") from None
    return adam, sched_count, multi


def optimizer_state_from_flax(tree: Mapping, optimizer: "Optimizer") -> Dict:
    """The JAX package's optimizer state (``<checkpoint>.opt``, as
    ``flax_msgpack.load`` returns it) → ``optimizer.load_state_dict``'s
    layout: Adam's ``mu``, ``nu`` and ``count``, MultiSteps' ``mini_step``
    and ``acc_grads``, each through the parameters' key map and
    transposes. Frozen (masked-out) parameters are skipped; the trainable
    ones must all be there, with their shapes."""
    adam, sched_count, multi = _adam_state(tree, optimizer.grad_accum)
    count = int(adam["count"])
    if sched_count != count:
        raise ValueError(f"the schedule's count {sched_count} is not Adam's "
                         f"{count}")
    own = optimizer.params

    def port(sub, what, keep_frozen=False):
        sd = state_dict_from_flax(sub)
        if keep_frozen:  # acc_grads covers every parameter
            sd = {k: v for k, v in sd.items() if k in own}
        _check_against(sd, own, what)
        return sd

    state = {"count": count, "mini_step": 0, "mu": port(adam["mu"], "mu"),
             "nu": port(adam["nu"], "nu"), "acc": None}
    if multi is not None:
        state["mini_step"] = int(multi["mini_step"])
        state["acc"] = port(multi["acc_grads"], "acc_grads", keep_frozen=True)
    return state


def flax_optimizer_state(optimizer: "Optimizer",
                         model_state: Mapping[str, torch.Tensor]) -> Dict:
    """``optimizer``'s state in the JAX package's optax layout (the inverse
    of ``optimizer_state_from_flax``), ready for ``flax_msgpack.dumps``.
    ``model_state``: the model's ``state_dict``, which sets the tree; a
    parameter outside the optimizer is masked (frozen)."""
    frozen = [k for k in model_state if k not in optimizer.params]
    i32 = lambda n: np.asarray(n, np.int32)

    def tree(values, empty=()):
        sd = {k: values[k] if k in values else v
              for k, v in model_state.items()}
        return flax_from_state_dict(sd, empty=empty)

    adamw = {"0": {"count": i32(optimizer.count),
                   "mu": tree(optimizer.mu, frozen),
                   "nu": tree(optimizer.nu, frozen)},
             "1": {}, "2": {"count": i32(optimizer.count)}}
    state: Dict[str, Any] = {"0": {}, "1": adamw}
    if frozen:
        state = {"inner_state": state}
    if optimizer.grad_accum > 1:
        # a frozen parameter's gradient is zero: its sum stays zero
        acc = {k: torch.zeros_like(v) for k, v in model_state.items()}
        acc.update(optimizer.acc)
        state = {"mini_step": i32(optimizer.mini_step),
                 "gradient_step": i32(optimizer.count),
                 "inner_opt_state": state, "acc_grads": tree(acc),
                 "skip_state": {}}
    return state


def read_optimizer_state(path: str, optimizer: "Optimizer") -> Dict:
    """The optimizer state in ``path`` for ``optimizer.load_state_dict``:
    a flax file (the JAX package's ``.opt``) or a torch file (this port's),
    told apart by their first bytes."""
    with open(path, "rb") as f:
        head = f.read(1)
    if flax_msgpack.is_flax_msgpack(head):
        return optimizer_state_from_flax(flax_msgpack.load(path), optimizer)
    return torch.load(path, map_location="cpu", weights_only=False)
