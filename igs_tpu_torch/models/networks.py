"""Small generic networks and the weight initializer.

Counterpart of ``igs_tpu/models/networks.py``: MLP, ModLN. Parameter names
follow the reference torch modules (``layers.N``, ``mlp.0``, ``norm``), so
``igs_tpu.models.torch_convert`` reads a port ``state_dict`` directly.
"""

from __future__ import annotations

import math
import torch
from torch import nn


class MLP(nn.Module):
    """dim_in → n_neurons ×(n_hidden_layers) → dim_out with SiLU (the
    reference renderer's activation); torch Sequential layout, linear at
    even indices."""

    def __init__(self, dim_in: int, dim_out: int, n_neurons: int,
                 n_hidden_layers: int):
        super().__init__()
        layers = [nn.Linear(dim_in, n_neurons), nn.SiLU()]
        for _ in range(n_hidden_layers - 1):
            layers += [nn.Linear(n_neurons, n_neurons), nn.SiLU()]
        layers += [nn.Linear(n_neurons, dim_out)]
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class ModLN(nn.Module):
    """Modulation with adaLN: x (..., D) tokens, cond (..., mod_dim)."""

    def __init__(self, inner_dim: int, mod_dim: int, hidden_dim: int = 128,
                 eps: float = 1e-6):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(mod_dim, hidden_dim), nn.SiLU(),
                                 nn.Linear(hidden_dim, inner_dim * 2))
        self.norm = nn.LayerNorm(inner_dim, eps=eps)

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
