"""Small generic networks, the layers they are built from, and the weight
initializer.

Counterpart of ``igs_tpu/models/networks.py``: MLP, ModLN. Parameter names
follow the reference torch modules (``layers.N``, ``mlp.0``, ``norm``), so
``igs_tpu.models.torch_convert`` reads a port ``state_dict`` directly.

``Dense``, ``Conv``, ``LayerNorm`` and ``GroupNorm`` are the torch layers
with flax's rule for the compute type: a layer given a ``dtype`` casts its
input and parameters to it (the parameters themselves stay float32); a
layer without one computes in the promotion of its input's and its
parameters' types. So the bf16 compute flags cast inside the layers they
name, and a mixed-precision step that hands every layer bf16 copies of its
parameters computes in bf16 only where the activations are bf16 too, as
``flax.linen`` does. With float32 inputs and parameters every cast is a
no-op.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor,
                  *params: Optional[torch.Tensor]) -> torch.dtype:
    """``dtype`` when set, else the promotion of ``x``'s and the
    parameters' types (flax's ``promote_dtype``)."""
    if dtype is not None:
        return dtype
    out = x.dtype
    for p in params:
        if p is not None:
            out = torch.promote_types(out, p.dtype)
    return out


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype):
    return None if p is None else p.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax ``nn.Dense(dtype=…)``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = compute_dtype(self.compute_dtype, x, self.weight, self.bias)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (flax ``nn.Conv(dtype=…)``)."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = compute_dtype(self.compute_dtype, x, self.weight, self.bias)
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in the promoted type of input and parameters."""

    def forward(self, x):
        dt = compute_dtype(None, x, self.weight, self.bias)
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            _cast(self.weight, dt), _cast(self.bias, dt),
                            self.eps)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` in the promoted type of input and parameters."""

    def forward(self, x):
        dt = compute_dtype(None, x, self.weight, self.bias)
        return F.group_norm(x.to(dt), self.num_groups,
                            _cast(self.weight, dt), _cast(self.bias, dt),
                            self.eps)


class MLP(nn.Module):
    """dim_in → n_neurons ×(n_hidden_layers) → dim_out with SiLU (the
    reference renderer's activation); torch Sequential layout, linear at
    even indices."""

    def __init__(self, dim_in: int, dim_out: int, n_neurons: int,
                 n_hidden_layers: int):
        super().__init__()
        layers = [Dense(dim_in, n_neurons), nn.SiLU()]
        for _ in range(n_hidden_layers - 1):
            layers += [Dense(n_neurons, n_neurons), nn.SiLU()]
        layers += [Dense(n_neurons, dim_out)]
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class ModLN(nn.Module):
    """Modulation with adaLN: x (..., D) tokens, cond (..., mod_dim)."""

    def __init__(self, inner_dim: int, mod_dim: int, hidden_dim: int = 128,
                 eps: float = 1e-6):
        super().__init__()
        self.mlp = nn.Sequential(Dense(mod_dim, hidden_dim), nn.SiLU(),
                                 Dense(hidden_dim, inner_dim * 2))
        self.norm = LayerNorm(inner_dim, eps=eps)

    def forward(self, x, cond):
        shift, scale = self.mlp(cond).chunk(2, dim=-1)
        return self.norm(x) * (1 + scale) + shift


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: fan-in scaled normal for linear
    and conv weights, zero biases, unit norm scales. Modules with a
    ``reset_from`` method (zero-init output heads) finish their own."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in module.modules():
        if hasattr(m, "reset_from"):
            m.reset_from(generator)
