"""NaN-safe norms (forward values as ``igs_tpu.utils.safe_math``)."""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim=-1, keepdim: bool = False,
              eps: float = 0.0) -> torch.Tensor:
    """L2 norm that returns ``eps`` where the norm is 0."""
    n2 = torch.sum(x * x, dim=dim, keepdim=keepdim)
    ok = n2 > 0
    n = torch.sqrt(torch.where(ok, n2, torch.ones_like(n2)))
    return torch.where(ok, n, torch.full_like(n, eps))


def safe_normalize(x: torch.Tensor, dim=-1, eps: float = 1e-30) -> torch.Tensor:
    """x/‖x‖, zero where ‖x‖ ≤ eps."""
    n2 = torch.sum(x * x, dim=dim, keepdim=True)
    ok = n2 > eps * eps
    inv = 1.0 / torch.sqrt(torch.where(ok, n2, torch.ones_like(n2)))
    return torch.where(ok, x * inv, torch.zeros_like(x))
