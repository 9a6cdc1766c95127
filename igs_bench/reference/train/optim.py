"""AGM-Net's training step in plain PyTorch: the loss (λ_rgb·L1 +
λ_ssim·(1−SSIM) over every rendered view), the gradient clipped by its
global norm, AdamW with decoupled weight decay and the OneCycle learning
rate, in optax's order of operations (a frozen copy of the port's
``train/driver.py`` pieces, without LPIPS, accumulation or ranks).
Under ``lowp.control()`` the parameters are stored in bfloat16."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from igs_bench.reference import lowp
from igs_bench.reference.train.losses import l1_loss, ssim


def onecycle_schedule(max_lr: float, total_steps: int,
                      warmup_steps: int) -> Callable[[int], float]:
    """optax ``cosine_onecycle_schedule``: max_lr/25 up to max_lr over the
    warm-up, then down to max_lr/25e4 at ``total_steps``."""
    warmup_steps = min(warmup_steps, max(total_steps - 1, 1))
    pct_start = warmup_steps / total_steps
    div, final_div = 25.0, 1e4
    bounds = (0, int(pct_start * total_steps), int(total_steps))
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


class AdamW:
    """clip_by_global_norm(clip) → adamw(schedule, b1, b2, eps 1e-8, wd)
    over a name → parameter dict; ``step()`` reads ``.grad``."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: Dict,
                 schedule: Callable[[int], float]):
        self.params = dict(params)
        self.opt = opt
        self.schedule = schedule
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self) -> None:
        o = self.opt
        b1, b2 = float(o["beta1"]), float(o["beta2"])
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        clip = float(o["gradient_clip"])
        if not bool(norm < clip):
            grads = {k: (g / norm) * clip for k, g in grads.items()}
        lr = self.schedule(self.count)
        self.count += 1
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1 - b2) * (g * g) + b2 * self.nu[k]
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-8)
            u = u + float(o["weight_decay"]) * p
            p.add_(-lr * u)
            if lowp.active():
                p.copy_(lowp.bf16(p))
            p.grad = None


def loss_fn(pred: torch.Tensor, gt: torch.Tensor, opt: Dict) -> torch.Tensor:
    """(B, V, 3, H, W) renders against the ground truth."""
    loss = float(opt["lambda_rgb"]) * l1_loss(pred, gt)
    s, _ = ssim(pred.reshape(-1, *pred.shape[2:]),
                gt.reshape(-1, *gt.shape[2:]))
    return loss + float(opt["lambda_ssim"]) * (1.0 - s)
