"""Carry the JAX package's AGM-Net weights into the port.

``state_dict_from_flax`` turns the flax parameter tree (nested dicts of
arrays, as ``AGMNet.init`` returns it) into a ``state_dict`` of this
port's ``AGMNet``, whose names are the reference torch model's — so this
is the inverse of ``igs_tpu/models/torch_convert.py``. Dense kernels
(in, out) become Linear weights (out, in); conv kernels HWIO become OIHW;
norm ``scale`` becomes ``weight``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# module-path rewrites, applied in order to the dotted flax path
_RULES: Tuple[Tuple[str, str], ...] = (
    (r"^backbone\.backbone\.(conv1|conv2)\.conv$", r"backbone.backbone.\1"),
    (r"^backbone\.backbone\.layer(\d)_(\d)\.downsample\.conv$",
     r"backbone.backbone.layer\1.\2.downsample.0"),
    (r"^backbone\.backbone\.layer(\d)_(\d)\.(conv1|conv2)\.conv$",
     r"backbone.backbone.layer\1.\2.\3"),
    (r"(^|\.)transformer\.layer(\d+)\.", r"\1transformer.layers.\2."),
    (r"\.mlp([02])$", r".mlp.\1"),
    (r"^triplane_encoder\.conv\.block(\d+)\.",
     r"triplane_encoder.conv.transformer_blocks.\1."),
    (r"\.attn1\.to_out$", ".attn1.to_out.0"),
    (r"\.ff\.proj$", ".ff.net.0.proj"),
    (r"\.ff\.out$", ".ff.net.2"),
    (r"^render\.head_xyz$", "render.out_layers.0"),
    (r"^render\.head_rotation$", "render.out_layers.1"),
)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _module_key(path: str, mlp_layers: int) -> str:
    m = re.match(r"^render\.mlp_net\.layer(\d+|_out)$", path)
    if m:
        i = mlp_layers if m.group(1) == "_out" else int(m.group(1))
        return f"render.mlp_net.layers.{2 * i}"
    for pat, rep in _RULES:
        path = re.sub(pat, rep, path)
    return path


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax AGMNet params (with or without the ``params`` level) → port
    ``state_dict``."""
    tree = params.get("params", params)
    flat = _flatten(tree)
    mlp_layers = len({p for p in flat
                      if re.match(r"^render\.mlp_net\.layer\d+\.", p)
                      and p.endswith(".kernel")})
    sd = {}
    for path, value in flat.items():
        module, leaf = path.rsplit(".", 1)
        x = np.asarray(value, np.float32)
        if leaf == "kernel":
            x = x.transpose(3, 2, 0, 1) if x.ndim == 4 else x.T
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unknown flax leaf {path}")
        sd[f"{_module_key(module, mlp_layers)}.{name}"] = torch.tensor(x)
    return sd


def load_flax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Load flax AGMNet params into ``model``; every parameter of the port
    must be covered and every flax leaf used (strict load)."""
    model.load_state_dict(state_dict_from_flax(params), strict=True)
