"""Training losses: L1, L2, PSNR, SSIM (3DGS flavour), quaternion loss.

Counterpart of ``igs_tpu/train/losses.py``. SSIM uses an 11×11 Gaussian
window (σ=1.5) run separably (11×1 then 1×11), SAME zero padding, and
C1=0.01², C2=0.03² on [0, 1] images.

SSIM runs in true float32 on the card: σ² = blur(x²) − μ² cancels, and
with cuDNN's default TF32 convolutions (about three decimal digits) its
error swamps C2 = 9e-4, the map leaves [−1, 1] and 1 − SSIM goes
negative. The gradient of σ² cancels the same way. ``ssim`` turns TF32
off for its convolutions, forward and backward, whatever the global
setting: autograd would run a convolution's backward under the setting
in force when the loss is differentiated, so the blur is a
``torch.autograd.Function`` that turns it off in its backward too.
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred, gt):
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred, gt):
    return torch.mean((pred - gt) ** 2)


def psnr(pred, gt):
    return -10.0 * torch.log10(torch.mean((pred - gt) ** 2))


@lru_cache(maxsize=4)
def _gaussian_1d(window_size: int, sigma: float) -> np.ndarray:
    g = np.array([math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2))
                  for x in range(window_size)], np.float32)
    g /= g.sum()
    # the reference's 2-D window is the outer product; its middle column,
    # renormalised, is the 1-D factor (igs_tpu/train/losses.py:47-51)
    col = np.outer(g, g)[:, window_size // 2]
    return (col / col.sum()).astype(np.float32)


@contextlib.contextmanager
def _fp32_convs():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _blur_fp32(x, g):
    """The separable window over the last two axes, SAME zero padding, with
    TF32 off."""
    k = g.shape[0]
    h, w = x.shape[-2:]
    with _fp32_convs():
        y = F.conv2d(x.reshape(-1, 1, h, w), g.reshape(1, 1, k, 1),
                     padding=(k // 2, 0))
        y = F.conv2d(y, g.reshape(1, 1, 1, k), padding=(0, k // 2))
    return y.reshape(x.shape)


class _Blur(torch.autograd.Function):
    """``_blur_fp32`` whose backward, the two convolutions' input
    gradients, also runs with TF32 off."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.save_for_backward(g)
        ctx.shape = x.shape
        return _blur_fp32(x, g)

    @staticmethod
    def backward(ctx, grad):
        (g,) = ctx.saved_tensors
        k = g.shape[0]
        h, w = ctx.shape[-2:]
        gy = grad.reshape(-1, 1, h, w)
        with _fp32_convs():
            gy = torch.nn.grad.conv2d_input(
                gy.shape, g.reshape(1, 1, 1, k), gy, padding=(0, k // 2))
            gx = torch.nn.grad.conv2d_input(
                gy.shape, g.reshape(1, 1, k, 1), gy, padding=(k // 2, 0))
        return gx.reshape(ctx.shape), None


def ssim(img1, img2, window_size: int = 11, size_average: bool = True):
    """img1/img2: (..., C, H, W). Returns (mean, map) like the reference,
    or the per-image mean over (C, H, W) when ``size_average`` is False."""
    g = torch.as_tensor(_gaussian_1d(window_size, 1.5), device=img1.device,
                        dtype=img1.dtype)

    def blur(x):
        return _Blur.apply(x, g)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return torch.mean(ssim_map), ssim_map
    return torch.mean(ssim_map, dim=(-3, -2, -1))


def quaternion_loss(q1, q2):
    """1 − mean cos² between quaternion rows (loss_utils.py:65-73)."""
    num = torch.sum(q1 * q2, dim=1)
    den = torch.linalg.norm(q1, dim=1) * torch.linalg.norm(q2, dim=1)
    cos = torch.where(den > 0, num / torch.clamp_min(den, 1e-20),
                      torch.zeros_like(num))
    cos = torch.clamp(cos, -1 + 1e-7, 1 - 1e-7)
    return 1 - torch.mean(cos**2)


def rgb_ssim_loss(pred, gt, lambda_l1: float = 0.8):
    """The key-frame refine loss: λ·L1 + (1−λ)·(1−SSIM)."""
    s, _ = ssim(pred, gt)
    return lambda_l1 * l1_loss(pred, gt) + (1 - lambda_l1) * (1.0 - s)
