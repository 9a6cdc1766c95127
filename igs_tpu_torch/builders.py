"""Builders: reference YAML config sections → the port's objects.

Counterpart of ``igs_tpu/builders.py``: ``system`` → ``AGMNet``, output
resolution → ``RasterSettings``, ``data`` → the training or the streaming
dataset, ``opt`` → ``OptConfig`` (training) or ``StreamConfig`` and
``RefineConfig`` (streaming). Sections are plain dicts, as the YAML loads
them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.models.networks import init_weights
from igs_tpu_torch.ops.rasterize import IMPLS, RasterSettings
from igs_tpu_torch.stream.pipeline import StreamConfig
from igs_tpu_torch.stream.refine import RefineConfig
from igs_tpu_torch.train.driver import OptConfig
from igs_tpu_torch.utils.device import resolve_device

# the reference's and the JAX package's class paths of the training and
# the streaming datasets (igs_tpu/__init__.py's _REMAP)
_N3D_DATASET = ("igs.data.data.N3dDataset", "igs_tpu.data.dataset.N3dDataset")
_INFER_DATASET = ("igs.data.infer_data.N3dDataset",
                  "igs_tpu.data.infer_data.N3dInferDataset")


def build_model(system: Dict[str, Any], device=None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, bf16_default: bool = False) -> AGMNet:
    """system section → AGMNet on ``device`` (``cuda`` unless told), in
    training mode when ``train``, else in eval mode.

    ``bf16_default`` is the default of the three bf16 compute flags
    (``encoder_bf16``, ``cnn_bf16``, ``ft_bf16``); a flag the section sets
    wins. Parameters stay float32. Weights are random from ``generator``
    (seed 0 when None); ``utils.resume`` overlays checkpoints, and
    ``models.convert.load_flax_params`` loads the JAX package's.
    """
    dev = resolve_device(device)
    backbone = system.get("backbone", {})
    transformer = system.get("transformer", {})
    enc_unet = system.get("triplane_encoder", {}).get("unet", {})
    renderer = system.get("renderer", {}) or {}
    model = AGMNet(
        feature_channels=backbone.get("feature_channels", 128),
        backbone_layers=backbone.get("transformer", {}).get("num_layers", 6),
        motion_layers=transformer.get("num_layers", 1),
        up_sample=system.get("up_sample", True),
        use_condition3d=system.get("use_condition3d", True),
        local_ray=system.get("local_ray", True),
        fine_tune_backbone=system.get("fine_tune_backbone", True),
        train_backbone=bool(system.get("train_backbone", False)),
        encoder_heads=enc_unet.get("num_attention_heads", 8),
        encoder_head_dim=enc_unet.get("attention_head_dim", 64),
        encoder_layers=enc_unet.get("num_layers", 4),
        encoder_bf16=bool(system.get("encoder_bf16", bf16_default)),
        cnn_bf16=bool(system.get("cnn_bf16", bf16_default)),
        ft_bf16=bool(system.get("ft_bf16", bf16_default)),
        render_flow=bool(renderer.get("render_flow", False)),
        flow_height=int(renderer.get("flow_height", 1024)),
        flow_width=int(renderer.get("flow_width", 1352)),
    )
    init_weights(model, generator or torch.Generator().manual_seed(0))
    model = model.to(dev)
    return model.train() if train else model.eval()


def build_raster_settings(height: int, width: int, clamp: bool = True,
                          max_pairs: int = 0, max_per_tile: int = 4096,
                          impl: str = "auto") -> RasterSettings:
    """Output-view settings with the clamp rasterizer's ±15 gradient clamp
    (``clamp``). ``impl="auto"`` is the packed route, the JAX package's
    choice on a chip; ``"pallas"`` is the windowed route with
    ``max_per_tile`` rows a tile; ``"tiles"`` and ``"reference"`` are the
    oracles, used only when named. The JAX package's ``"auto"`` is
    ``"tiles"`` off a TPU; the port's is its kernels on every device (C27).
    The default pair budget is ~2 blended contributions per pixel, a power
    of two in [2^15, 2^21] (denser scenes overflow loudly, and the pipeline
    grows it at stream start on the kernel routes)."""
    if impl == "auto":
        impl = "pallas_packed"
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; the port has {IMPLS} and 'auto'")
    if max_pairs <= 0:
        max_pairs = 1 << min(
            21, max(15, math.ceil(math.log2(max(height * width * 2, 1)))))
    return RasterSettings(image_height=height, image_width=width,
                          max_pairs=max_pairs, impl=impl,
                          max_per_tile=max_per_tile, clamp_grads=clamp)


def build_dataset(data_cfg: Dict[str, Any], training: bool):
    """data section → the training dataset (``data/dataset.N3dDataset``)
    or the streaming one (``data/infer_data.N3dInferDataset``), by the
    reference's or the JAX package's class path."""
    cls = data_cfg.get("data_cls", _N3D_DATASET[0])
    if cls in _N3D_DATASET:
        from igs_tpu_torch.data.dataset import N3dDataset

        return N3dDataset(data_cfg["data"], training=training)
    if cls in _INFER_DATASET:
        from igs_tpu_torch.data.infer_data import N3dInferDataset

        return N3dInferDataset(data_cfg["data"], training=training)
    raise ValueError(f"unknown data_cls {cls!r}")


def build_opt_config(opt: Dict[str, Any]) -> OptConfig:
    """opt section → OptConfig, with the keys and defaults of
    ``igs_tpu/builders.py`` (AdamW wd 0.05, betas (0.9, 0.95), OneCycle
    warmup 3000 unless the YAML says otherwise). ``mixed_precision``
    "bf16" or "fp16" runs the train step in bf16, as the JAX package does
    (``train/driver.make_train_step``); ``lambda_lpips`` > 0 adds the
    LPIPS term (``train/lpips.py``, its weights from
    ``opt.lpips_weights``)."""
    cfg = OptConfig(
        lr=float(opt.get("lr", 4e-4)),
        weight_decay=float(opt.get("weight_decay", 0.05)),
        beta1=float(opt.get("beta1", 0.9)),
        beta2=float(opt.get("beta2", 0.95)),
        num_epochs=int(opt.get("num_epochs", 30)),
        warmup_steps=int(opt.get("warmup_steps", 3000)),
        gradient_clip=float(opt.get("gradient_clip", 1.0)),
        lambda_rgb=float(opt.get("lambda_rgb", 1.0)),
        lambda_ssim=float(opt.get("lambda_ssim", 0.2)),
        lambda_lpips=float(opt.get("lambda_lpips", 0.0)),
        mixed_precision=str(opt.get("mixed_precision", "no")),
    )
    return cfg


def build_stream_configs(opt: Dict[str, Any]
                         ) -> Tuple[StreamConfig, RefineConfig]:
    """opt section → (StreamConfig, RefineConfig), from the keys and
    defaults of ``igs_tpu/builders.py``."""
    lrs = opt.get("training_lr", {})
    item = opt.get("refine_item", {})
    stream = StreamConfig(
        eval_batch_size=int(opt.get("eval_batch_size", 5)),
        refine_gs=bool(opt.get("refine_gs", True)),
        refine_iterations=int(opt.get("refine_iterations", 50)),
        max_num=int(opt.get("max_num", 150_000)),
        workspace=str(opt.get("workspace", "logs/igs_tpu_torch/stream")),
        shared_cur_cnn=bool(opt.get("shared_cur_cnn", True)),
        depth_view_res=int(opt.get("depth_view_res", 128)),
        fps_buckets=int(opt.get("fps_buckets", 64)),
        shared_window_pairs=bool(opt.get("shared_window_pairs", True)),
        shared_pairs_drift_px=float(opt.get("shared_pairs_drift_px", 8.0)),
        shared_pairs_drift_frac=float(
            opt.get("shared_pairs_drift_frac", 0.01)),
        free_view=bool(opt.get("free_view", False)),
        data_parallel=int(opt.get("data_parallel", 1)),
        refine_parallel=int(opt.get("refine_parallel", 1)),
    )
    refine = RefineConfig(
        position_lr=float(lrs.get("position_lr_init", 0.0016)),
        feature_lr=float(lrs.get("feature_lr", 0.0025)),
        opacity_lr=float(lrs.get("opacity_lr", 0.05)),
        scaling_lr=float(lrs.get("scaling_lr", 0.005)),
        rotation_lr=float(lrs.get("rotation_lr", 0.01)),
        lambda_l1=float(opt.get("lambda_l1", 0.8)),
        no_shs=bool(item.get("no_shs", False)),
        no_opacity=bool(item.get("no_opacity", False)),
        no_scaling=bool(item.get("no_scaling", False)),
        use_mask=bool(item.get("use_mask", False)),
        use_new_shs=bool(item.get("use_new_shs", False)),
        use_densify=bool(opt.get("use_densify", True)),
        densify_until_iter=int(opt.get("densify_until_iter", 100)),
        densify_from_iter=int(opt.get("densify_from_iter", 0)),
        densification_interval=int(opt.get("densification_interval", 20)),
        densify_grad_threshold=float(
            opt.get("densify_grad_threshold", 0.00015)),
        rebin_every=int(opt.get("rebin_every", 1)),
    )
    return stream, refine
