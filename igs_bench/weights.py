"""AGM-Net's weights from the seed, made on the device in one draw.

Every matrix and convolution kernel is normal with a fan-in scale, biases
are zero and norm scales one, as the port's ``init_weights``; the two
output heads of the residual decoder, which the port zero-inits (an
identity deform), are drawn ``head_scale`` times smaller instead, so the
deform moves the Gaussians and the check's eval images read the network. The
rotation head's bias is the identity quaternion. Program and reference
load the same tensors by name.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

HEADS = "render.out_layers."


def make_weights(shapes: Dict[str, torch.Size], seed: int, head_scale: float,
                 device) -> Dict[str, torch.Tensor]:
    """``shapes``: the model's parameter names and shapes (a state dict's
    keys in order). One ``randn`` on ``device`` fills every matrix."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mats = [k for k, s in shapes.items()
            if k.endswith("weight") and len(s) >= 2]
    total = sum(math.prod(shapes[k]) for k in mats)
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        if k in mats:
            n = math.prod(shape)
            fan_in = n // shape[0]
            scale = (head_scale if k.startswith(HEADS) else 1.0)
            out[k] = draw[at:at + n].reshape(shape) * (scale
                                                       / math.sqrt(fan_in))
            at += n
        elif k.endswith("weight"):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    rot_bias = HEADS + "1.bias"
    if rot_bias in out:
        out[rot_bias] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    return out
