"""LPIPS, the VGG16 perceptual distance: the training term's network and
the ``metrics`` CLI's third number.

Counterpart of ``igs_tpu/train/lpips.py`` (the reference's lpipsPyTorch
and kiui LPIPS): inputs in [-1, 1] shifted by (-0.030, -0.088, -0.188)
and scaled by (0.458, 0.448, 0.450); the features after VGG16's convs
1, 3, 6, 9 and 12 (after their ReLU), each unit-normalised over channels
as ``a / (sqrt(sum a^2) + 1e-10)`` (the eps outside the root, not
``F.normalize``); the squared difference through a 1×1 linear head
without bias; the spatial mean, summed over the five stages → (B,).

The parameters carry lpipsPyTorch's names: ``net.layers.<i>.weight`` and
``.bias`` at torchvision's VGG16 feature indices (0, 2, 5, 7, 10, 12, 14,
17, 19, 21, 24, 26, 28) and ``lin.<i>.1.weight``, so a ``torch.save`` of
``LPIPS().state_dict()`` loads into the JAX package's ``make_lpips`` and
the reference's module. ``load_torch_lpips`` reads the three families
the JAX package reads (richzhang's ``net.sliceN.M``, lpipsPyTorch's
``net.layers.N``, and the lin heads' three spellings).

Without converted weights the VGG is drawn from a seeded generator (seed
0; the JAX package draws flax's init from ``PRNGKey(0)``, which torch
cannot reproduce: ROADMAP C26) and ``make_lpips`` reports it unavailable,
as the JAX package does. No VGG weights exist offline.

The module is frozen (``requires_grad_(False)``, ``eval()``) and never a
submodule of AGM-Net: it stays out of the model's ``state_dict``, its
checkpoints, the optimizer and the mixed-precision parameter copies.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
_STAGE_ENDS = (1, 3, 6, 9, 12)  # conv indices after which features are taken
STAGE_CH = (64, 128, 256, 512, 512)
# torchvision's ``vgg16().features`` index of each conv
CONV_LAYERS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_EPS = 1e-10
# a loaded file counts as weights when it carries more than this many
# tensors (the JAX package's rule: 13 convs and 5 heads make 18)
_AVAILABLE_OVER = 10


class VGG16Features(nn.Module):
    """torchvision's VGG16 ``features`` up to the last conv's ReLU; the
    forward returns the five stages' features."""

    def __init__(self):
        super().__init__()
        layers = []
        c_in = 3
        for v in _VGG_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c_in, v, 3, padding=1), nn.ReLU()]
                c_in = v
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        feats = []
        conv_i = 0
        for layer in self.layers:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                if conv_i in _STAGE_ENDS:
                    feats.append(x)
                conv_i += 1
        return feats


class LPIPS(nn.Module):
    """``forward(x, y)`` of two (B, 3, H, W) batches in [-1, 1] → (B,).
    ``generator``: the seeded draw of the VGG (fan-in scaled normal, zero
    biases); the heads start at ones, as flax's ``kernel_init=ones``."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = VGG16Features()
        self.lin = nn.ModuleList(
            nn.Sequential(nn.Identity(), nn.Conv2d(c, 1, 1, bias=False))
            for c in STAGE_CH)
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(
            1, 3, 1, 1), persistent=False)
        gen = generator or torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in self.net.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                                   / math.sqrt(fan_in))
                    m.bias.zero_()
            for head in self.lin:
                head[1].weight.fill_(1.0)
        self.requires_grad_(False)
        self.eval()

    def features(self, x):
        """The five stages' unit-normalised features of ``x`` in [-1, 1].
        With the frozen parameters, autograd records them only when ``x``
        needs a gradient."""
        feats = self.net((x - self.shift) / self.scale)
        return [a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True))
                     + _EPS) for a in feats]

    def forward(self, x, y):
        total = 0.0
        for head, a, b in zip(self.lin, self.features(x), self.features(y)):
            total = total + head((a - b) ** 2).mean(dim=(1, 2, 3))
        return total


def _conv_keys(state: Mapping[str, Any]):
    """The conv weights of a torch LPIPS ``state_dict`` in network order:
    richzhang's ``net.sliceN.M.weight``, else lpipsPyTorch's
    ``net.layers.N.weight`` (4-D only)."""
    keys = sorted((k for k in state if k.endswith(".weight")
                   and "slice" in k),
                  key=lambda k: (int(k.split("slice")[1].split(".")[0]),
                                 int(k.split(".")[2])))
    if not keys:
        keys = sorted((k for k in state if k.endswith(".weight")
                       and ".layers." in k and np.ndim(state[k]) == 4),
                      key=lambda k: int(k.split(".layers.")[1].split(".")[0]))
    return keys


@torch.no_grad()
def load_torch_lpips(model: LPIPS, state: Mapping[str, Any]) -> int:
    """Copy a torch LPIPS ``state_dict`` (tensors or arrays) into
    ``model``, as the JAX package's ``load_torch_lpips`` reads it: each
    4-D conv weight in network order onto the next conv whose shape it
    has (its bias with it), then the five heads under ``lins.<i>.model.1.
    weight``, ``lin<i>.model.1.weight`` or ``lin.<i>.1.weight``. Returns
    the tensors loaded (convs and heads; biases are not counted)."""
    convs = [m for m in model.net.layers if isinstance(m, nn.Conv2d)]
    loaded = conv_i = 0
    for k in _conv_keys(state):
        w = torch.as_tensor(np.asarray(state[k]), dtype=torch.float32)
        if w.ndim != 4 or conv_i >= len(convs):
            continue
        conv = convs[conv_i]
        if tuple(conv.weight.shape) == tuple(w.shape):
            conv.weight.copy_(w)
            bk = k[:-len("weight")] + "bias"
            if bk in state:
                conv.bias.copy_(torch.as_tensor(np.asarray(state[bk])))
            loaded += 1
            conv_i += 1
    for i in range(len(STAGE_CH)):
        for key in (f"lins.{i}.model.1.weight", f"lin{i}.model.1.weight",
                    f"lin.{i}.1.weight"):
            if key in state:
                model.lin[i][1].weight.copy_(
                    torch.as_tensor(np.asarray(state[key])))
                loaded += 1
                break
    return loaded


def load_lpips(weights_path: Optional[str] = None) -> Tuple[LPIPS, int]:
    """(the frozen LPIPS, tensors loaded): the seeded VGG (seed 0),
    overlaid with the torch file at ``weights_path`` when it exists
    (``load_torch_lpips``)."""
    from igs_tpu_torch.utils.resume import torch_weights

    model = LPIPS(generator=torch.Generator().manual_seed(0))
    loaded = 0
    if weights_path and os.path.exists(weights_path):
        loaded = load_torch_lpips(model, torch_weights(weights_path))
    return model, loaded


def make_lpips(weights_path: Optional[str] = None, device=None
               ) -> Tuple[LPIPS, bool]:
    """(the frozen LPIPS on ``device``, available): ``available`` when
    more than 10 tensors of ``weights_path`` loaded, as the JAX package's
    ``make_lpips``; otherwise the VGG is the seeded draw and a warning
    says so. The module is the function: ``fn(x, y)`` → (B,)."""
    from igs_tpu_torch.utils.device import resolve_device

    model, loaded = load_lpips(weights_path)
    available = loaded > _AVAILABLE_OVER
    if not available:
        warnings.warn("LPIPS without converted VGG weights: the VGG is a "
                      "seeded random draw, not a metric")
    return model.to(resolve_device(device)), available
