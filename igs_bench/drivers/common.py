"""What the drivers share: the set-up log, the device sync, and AGM-Net
built for the program and for the reference from a configuration's
``model`` section."""

from __future__ import annotations

import sys
import time
from typing import Dict

import torch

BF16_FLAGS = ("cnn_bf16", "ft_bf16", "encoder_bf16")


def log(job, what: str) -> None:
    print(f"igs_bench: {time.perf_counter() - job.t_start:8.2f} s {what}",
          file=sys.stderr, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_model(cfg: Dict, device):
    """The port's AGM-Net, its parameters uninitialised on ``device`` (the
    benchmark loads its own)."""
    from igs_tpu_torch.models.agm import AGMNet

    with torch.device("meta"):
        model = AGMNet(**cfg["model"])
    return model.to_empty(device=device)


def reference_model(cfg: Dict, device, compute_types: bool = False):
    """The reference AGM-Net; with ``compute_types`` it carries the
    configuration's bf16 flags (for counting the work of the program's
    types), without them it is float32 throughout."""
    from igs_bench.reference.models.agm import AGMNet

    kw = dict(cfg["model"])
    if not compute_types:
        for k in BF16_FLAGS:
            kw[k] = False
    with torch.device(device):
        return AGMNet(**kw)


def peak_bytes(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
