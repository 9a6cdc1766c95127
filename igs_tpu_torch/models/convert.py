"""Carry AGM-Net weights between the JAX package's layout and the port's.

``state_dict_from_flax`` turns the flax parameter tree (nested dicts of
arrays, as ``AGMNet.init`` returns it) into a ``state_dict`` of this
port's ``AGMNet``, whose names are the reference torch model's — so this
is the inverse of ``igs_tpu/models/torch_convert.py``. Dense kernels
(in, out) become Linear weights (out, in); conv kernels HWIO become OIHW;
norm ``scale`` becomes ``weight``. ``flax_from_state_dict`` is its
inverse (the port's counterpart of ``torch_convert.py``): the same rules
run backwards, so a port ``state_dict`` can be written as the JAX
package's ``params.msgpack`` (``utils/flax_msgpack.py``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Tuple

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


# the same rewrites run backwards: port module path → flax module path
_INVERSE_RULES: Tuple[Tuple[str, str], ...] = (
    (r"^render\.out_layers\.1$", "render.head_rotation"),
    (r"^render\.out_layers\.0$", "render.head_xyz"),
    (r"\.ff\.net\.2$", ".ff.out"),
    (r"\.ff\.net\.0\.proj$", ".ff.proj"),
    (r"\.attn1\.to_out\.0$", ".attn1.to_out"),
    (r"^triplane_encoder\.conv\.transformer_blocks\.(\d+)\.",
     r"triplane_encoder.conv.block\1."),
    (r"\.mlp\.([02])$", r".mlp\1"),
    (r"(^|\.)transformer\.layers\.(\d+)\.", r"\1transformer.layer\2."),
    (r"^backbone\.backbone\.layer(\d)\.(\d)\.(conv1|conv2)$",
     r"backbone.backbone.layer\1_\2.\3.conv"),
    (r"^backbone\.backbone\.layer(\d)\.(\d)\.downsample\.0$",
     r"backbone.backbone.layer\1_\2.downsample.conv"),
    (r"^backbone\.backbone\.(conv1|conv2)$", r"backbone.backbone.\1.conv"),
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


def _flax_module(module: str, mlp_out: int) -> str:
    m = re.match(r"^render\.mlp_net\.layers\.(\d+)$", module)
    if m:
        i = int(m.group(1)) // 2
        return f"render.mlp_net.layer{'_out' if i == mlp_out else i}"
    for pat, rep in _INVERSE_RULES:
        module = re.sub(pat, rep, module)
    return module


def flax_from_state_dict(sd: Mapping[str, Any],
                         empty: Iterable[str] = ()) -> Dict[str, Any]:
    """Port ``state_dict`` → flax AGMNet params ``{"params": tree}`` of
    float32 numpy arrays (the inverse of ``state_dict_from_flax``): a
    weight of two or more axes is a kernel (transposed back), a 1-D
    weight a norm ``scale``. The keys in ``empty`` get an empty map at
    their leaf: what ``optax.masked`` stores for a frozen parameter."""
    empty = set(empty)
    mlp = [int(m.group(1)) // 2 for m in (
        re.match(r"^render\.mlp_net\.layers\.(\d+)\.weight$", k)
        for k in sd) if m]
    mlp_out = max(mlp) if mlp else -1
    tree: Dict[str, Any] = {}
    for key, value in sd.items():
        module, leaf = key.rsplit(".", 1)
        x = (value.detach().cpu().float().numpy() if torch.is_tensor(value)
             else np.asarray(value, np.float32))
        if leaf == "weight" and x.ndim >= 2:
            x = x.transpose(2, 3, 1, 0) if x.ndim == 4 else x.T
            name = "kernel"
        elif leaf == "weight":
            name = "scale"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unknown port leaf {key}")
        node = tree
        for part in _flax_module(module, mlp_out).split("."):
            node = node.setdefault(part, {})
        node[name] = {} if key in empty else np.ascontiguousarray(x)
    return {"params": tree}


def load_flax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Load flax AGMNet params into ``model``; every parameter of the port
    must be covered and every flax leaf used (strict load)."""
    model.load_state_dict(state_dict_from_flax(params), strict=True)


def lpips_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax LPIPS params (``igs_tpu/train/lpips.py``: ``vgg/conv<i>/
    {kernel, bias}`` and ``lin<i>/kernel``, with or without the
    ``params`` level) → the port's ``train/lpips.LPIPS`` ``state_dict``
    (lpipsPyTorch's names): conv kernels (kh, kw, I, O) → (O, I, kh, kw),
    heads (1, 1, C, 1) → (1, C, 1, 1)."""
    from igs_tpu_torch.train.lpips import CONV_LAYERS, STAGE_CH

    tree = params.get("params", params)
    sd = {}
    for i, layer in enumerate(CONV_LAYERS):
        conv = tree["vgg"][f"conv{i}"]
        sd[f"net.layers.{layer}.weight"] = torch.tensor(
            np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1))
        sd[f"net.layers.{layer}.bias"] = torch.tensor(
            np.asarray(conv["bias"], np.float32))
    for i in range(len(STAGE_CH)):
        sd[f"lin.{i}.1.weight"] = torch.tensor(
            np.asarray(tree[f"lin{i}"]["kernel"], np.float32).transpose(
                3, 2, 0, 1))
    return sd


def flax_lpips_from_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's LPIPS ``state_dict`` → flax LPIPS params ``{"params":
    tree}`` of float32 numpy arrays (the inverse of
    ``lpips_state_dict_from_flax``)."""
    from igs_tpu_torch.train.lpips import CONV_LAYERS

    def np32(v):
        return (v.detach().cpu().float().numpy() if torch.is_tensor(v)
                else np.asarray(v, np.float32))

    conv_of = {layer: i for i, layer in enumerate(CONV_LAYERS)}
    vgg: Dict[str, Any] = {}
    tree: Dict[str, Any] = {"vgg": vgg}
    for key, value in sd.items():
        m = re.match(r"^net\.layers\.(\d+)\.(weight|bias)$", key)
        h = re.match(r"^lin\.(\d+)\.1\.weight$", key)
        if m and int(m.group(1)) in conv_of:
            node = vgg.setdefault(f"conv{conv_of[int(m.group(1))]}", {})
            x = np32(value)
            if m.group(2) == "weight":
                node["kernel"] = np.ascontiguousarray(x.transpose(2, 3, 1, 0))
            else:
                node["bias"] = x
        elif h:
            tree[f"lin{h.group(1)}"] = {"kernel": np.ascontiguousarray(
                np32(value).transpose(2, 3, 1, 0))}
        else:
            raise KeyError(f"not an LPIPS parameter: {key}")
    return {"params": tree}
