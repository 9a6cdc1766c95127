"""Builders: reference YAML config sections → the port's objects.

Counterpart of ``igs_tpu/builders.py`` for the serving path: ``system`` →
``AGMNet``, output resolution → ``RasterSettings``, ``opt`` →
``StreamConfig``. Sections are plain dicts, as the YAML loads them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.models.networks import init_weights
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.stream.pipeline import StreamConfig
from igs_tpu_torch.utils.device import resolve_device

_BF16_FLAGS = ("encoder_bf16", "cnn_bf16", "ft_bf16")
_WAITING = {"free_view": False, "data_parallel": 1, "refine_parallel": 1}


def build_model(system: Dict[str, Any], device=None,
                generator: Optional[torch.Generator] = None) -> AGMNet:
    """system section → AGMNet on ``device`` (``cuda`` unless told).

    Weights are random from ``generator`` (seed 0 when None); load trained
    ones with ``models.convert.load_flax_params``. The bf16 compute flags
    are not ported yet and raise.
    """
    on = [f for f in _BF16_FLAGS if system.get(f)]
    if on:
        raise NotImplementedError(f"bf16 compute flags not ported yet: {on}")
    if system.get("render_flow") or system.get("renderer", {}).get(
            "render_flow"):
        raise NotImplementedError("render_flow is not ported yet")
    dev = resolve_device(device)
    backbone = system.get("backbone", {})
    transformer = system.get("transformer", {})
    enc_unet = system.get("triplane_encoder", {}).get("unet", {})
    model = AGMNet(
        feature_channels=backbone.get("feature_channels", 128),
        backbone_layers=backbone.get("transformer", {}).get("num_layers", 6),
        motion_layers=transformer.get("num_layers", 1),
        up_sample=system.get("up_sample", True),
        use_condition3d=system.get("use_condition3d", True),
        local_ray=system.get("local_ray", True),
        fine_tune_backbone=system.get("fine_tune_backbone", True),
        encoder_heads=enc_unet.get("num_attention_heads", 8),
        encoder_head_dim=enc_unet.get("attention_head_dim", 64),
        encoder_layers=enc_unet.get("num_layers", 4),
    )
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(dev).eval()


def build_raster_settings(height: int, width: int,
                          max_pairs: int = 0) -> RasterSettings:
    """Output-view settings; the default pair budget is ~2 blended
    contributions per pixel, a power of two in [2^15, 2^21] (denser
    scenes overflow loudly, and the pipeline grows it at stream start)."""
    if max_pairs <= 0:
        max_pairs = 1 << min(
            21, max(15, math.ceil(math.log2(max(height * width * 2, 1)))))
    return RasterSettings(image_height=height, image_width=width,
                          max_pairs=max_pairs)


def build_stream_configs(opt: Dict[str, Any]) -> StreamConfig:
    """opt section → StreamConfig (the refine half waits for its slice)."""
    for key, default in _WAITING.items():
        if opt.get(key, default) != default:
            raise NotImplementedError(f"opt.{key} is not ported yet")
    return StreamConfig(
        eval_batch_size=int(opt.get("eval_batch_size", 5)),
        refine_gs=bool(opt.get("refine_gs", True)),
        max_num=int(opt.get("max_num", 150_000)),
        workspace=str(opt.get("workspace", "logs/igs_tpu_torch/stream")),
        shared_cur_cnn=bool(opt.get("shared_cur_cnn", True)),
        depth_view_res=int(opt.get("depth_view_res", 128)),
        fps_buckets=int(opt.get("fps_buckets", 64)),
        shared_window_pairs=bool(opt.get("shared_window_pairs", True)),
        shared_pairs_drift_px=float(opt.get("shared_pairs_drift_px", 8.0)),
        shared_pairs_drift_frac=float(
            opt.get("shared_pairs_drift_frac", 0.01)),
    )
