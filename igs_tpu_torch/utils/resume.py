"""Checkpoint overlays onto a port ``AGMNet``: the GMFlow backbone, then
``opt.resume``.

Counterpart of ``igs_tpu/utils/resume.py``. Every overlay is a
shape-checked partial load (the reference's main.py:131-149): a tensor
whose name and shape match the model's is copied, any other is skipped
with a warning, and the number loaded is printed. That count matters: a
JAX-package regression once loaded nothing from a resume file and
streamed random weights while reporting success, so a run's log must show
how many tensors each overlay loaded. The port's names are the reference
torch model's (``models/convert.py``), so reference files load without
renaming.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from igs_tpu_torch.train.driver import load_flax_checkpoint


def merge_shape_checked(model: torch.nn.Module, state_dict: Dict[str, Any],
                        prefix: str = "") -> int:
    """Copy the tensors whose name (after ``prefix``) and shape match the
    model's, warn on the rest; returns how many were loaded."""
    own = model.state_dict()
    loaded = 0
    with torch.no_grad():
        for k, v in state_dict.items():
            key = prefix + k
            v = torch.as_tensor(v)
            if key in own and own[key].shape == v.shape:
                own[key].copy_(v)
                loaded += 1
            else:
                print(f"[WARN] skipping param {key}: {tuple(v.shape)}")
    return loaded


def torch_weights(path: str) -> Dict[str, Any]:
    """The state dict of a torch ``.pth``/``.bin``, unwrapped from a
    ``{"model": ...}`` blob."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model" in blob:
        blob = blob["model"]
    return blob


def is_port_checkpoint(blob: Any) -> bool:
    """Whether a loaded torch file is ``train/driver.save_checkpoint``'s."""
    return isinstance(blob, dict) and "params" in blob and "step" in blob


def load_params_with_overlays(model: torch.nn.Module, system_cfg: dict,
                              opt_cfg: dict) -> torch.nn.Module:
    """Overlay, in order, onto ``model`` (in place; it is returned):

    * the GMFlow checkpoint at ``system.backbone.
      pretrained_model_name_or_path``, under ``backbone.``;
    * ``opt.resume``: the port's own ``train/driver.save_checkpoint``
      file, or a reference IGS ``.pth``/``.bin``, whose ``backbone.*``
      keys are left out as the JAX package's conversion leaves them (the
      reference strips them from its checkpoints), or the JAX package's
      native ``.msgpack`` (``train/driver.load_flax_checkpoint``), which
      replaces every tensor, the backbone's too, as the JAX overlay does:
      a missing, extra or misshapen tensor raises.

    A path that does not exist is skipped."""
    gmflow = (system_cfg.get("backbone", {}) or {}).get(
        "pretrained_model_name_or_path", "")
    if gmflow and os.path.exists(gmflow):
        n = merge_shape_checked(model, torch_weights(gmflow),
                                prefix="backbone.")
        print(f"loaded {n} GMFlow tensors")

    resume = opt_cfg.get("resume", "")
    if resume and os.path.exists(resume):
        if resume.endswith(".msgpack"):
            sd, step = load_flax_checkpoint(resume, model.state_dict())
            model.load_state_dict(sd)
            print(f"loaded native checkpoint {resume}")
            print(f"loaded {len(sd)} AGM tensors from it (step {step})")
            return model
        blob = torch.load(resume, map_location="cpu", weights_only=False)
        if is_port_checkpoint(blob):
            n = merge_shape_checked(model, blob["params"])
            print(f"loaded {n} AGM tensors from checkpoint {resume} "
                  f"(step {int(blob['step'])})")
        else:
            if isinstance(blob, dict) and "model" in blob:
                blob = blob["model"]
            sd = {k: v for k, v in blob.items()
                  if not k.startswith("backbone.")}
            n = merge_shape_checked(model, sd)
            print(f"loaded {n} AGM tensors from torch ckpt {resume} "
                  f"({len(blob) - len(sd)} unmapped)")
    return model
