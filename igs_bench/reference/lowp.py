"""The control's precision: the reference one step below what the
configuration states.

Inside ``control()`` a layer that the configuration runs in bfloat16 takes
its inputs and weights rounded to fp8 (e4m3, scaled per tensor to its
largest entry) and computes in bfloat16; a float32 layer takes them
rounded to bfloat16; the rasterizer's projected features and the refine's
parameters are stored in bfloat16. Outside it every call is the identity.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_ACTIVE = contextvars.ContextVar("igs_bench_lowp", default=False)
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def active() -> bool:
    return _ACTIVE.get()


@contextlib.contextmanager
def control():
    token = _ACTIVE.set(True)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 at a per-tensor scale, back in x's type."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def round_input(x: torch.Tensor, stated: torch.dtype) -> torch.Tensor:
    """A layer's input or weight under the control, for a layer whose
    configuration computes in ``stated``."""
    if not active() or not x.is_floating_point():
        return x
    if stated == torch.bfloat16:
        return fp8(x).to(torch.bfloat16)
    return bf16(x)
