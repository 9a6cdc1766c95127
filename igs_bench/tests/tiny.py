"""A tiny streaming configuration and job for the CPU tests: the cell's
keys at toy sizes (every width cut), so a run takes seconds."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import torch

from igs_bench.run import HERE, Job


def tiny_config() -> dict:
    cfg = json.loads((HERE / "configs" / "igs_n3dv_stream.json").read_text())
    cfg = copy.deepcopy(cfg)
    # float32: at toy widths the bf16 flags' gap is not the cell's
    cfg["model"].update(feature_channels=32, backbone_layers=1,
                        encoder_heads=2, encoder_head_dim=16,
                        encoder_layers=1, cnn_bf16=False, ft_bf16=False,
                        encoder_bf16=False)
    cfg["stream"].update(refine_iterations=4, depth_view_res=16,
                         max_num=1200, anchor_size=64, fps_buckets=4)
    # a densify inside the four steps, so the check follows one
    cfg["refine"].update(densification_interval=2)
    cfg["views"].update(n_cams=6, input_views=[3, 1, 4, 2], input_res=32,
                        output_hw=[48, 64])
    cfg["scene"].update(n_gaussians=1000, scale_range=[-3.5, -2.5])
    # a deform large enough that a window's candidates differ visibly
    cfg["weights"]["head_scale"] = 1.0
    return cfg


def tiny_traffic() -> dict:
    t = json.loads((HERE / "workloads" / "n3dv_stream.refine.json"
                    ).read_text())
    t["clip_frames"] = 10
    # fast motion: a window's candidates see next frames that differ
    t["motion_scale"] = 2.0
    return t


def tiny_job(tmp: Path, seed: int = 3, trace: bool = False,
             control: bool = False, seconds: float = 0.0) -> Job:
    return Job(name="n3dv_stream.refine", cfg=tiny_config(),
               traffic=tiny_traffic(), seed=seed, seconds=seconds,
               trace=trace, device=torch.device("cpu"),
               t_start=time.perf_counter(), workspace=str(tmp / "ws"),
               control=control)


def tiny_train_config() -> dict:
    cfg = json.loads((HERE / "configs" / "igs_n3dv_train.json").read_text())
    cfg["model"].update(feature_channels=32, backbone_layers=1,
                        encoder_heads=2, encoder_head_dim=16,
                        encoder_layers=1)
    cfg["train"].update(capacity=1024, anchor_size=64)
    cfg["views"].update(n_cams=8, output_views=[3, 1, 4, 2, 0, 6], res=32)
    cfg["scene"].update(n_gaussians=1000, scale_range=[-3.5, -2.5])
    return cfg


def tiny_train_traffic() -> dict:
    return json.loads((HERE / "workloads" / "n3dv_train.step.json"
                       ).read_text())


def tiny_train_job(tmp: Path, seed: int = 3, trace: bool = False,
                   control: bool = False, seconds: float = 0.0) -> Job:
    return Job(name="n3dv_train.step", cfg=tiny_train_config(),
               traffic=tiny_train_traffic(), seed=seed, seconds=seconds,
               trace=trace, device=torch.device("cpu"),
               t_start=time.perf_counter(), workspace=str(tmp / "ws"),
               control=control)
