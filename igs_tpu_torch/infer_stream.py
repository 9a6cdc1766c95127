"""Streaming reconstruction: the port's counterpart of ``infer_stream.py``
(the reference's infer_batch.py).

    python -m igs_tpu_torch.infer_stream --config <yaml> [--max-batches N]
        [--device D] [a.b.c=value ...]

Reads an N3DV-layout scene through ``data/infer_data.N3dInferDataset``,
builds the AGM-Net from the ``system`` section, overlays the GMFlow and
``opt.resume`` checkpoints (``utils/resume.py``), and streams the windows
through ``StreamingPipeline`` with the key-frame refine; ``results.json``
and the eval views' PNGs go to ``opt.workspace``.

It runs on the card unless ``--device`` names another device. On the card
the three bf16 compute flags default to on, as the JAX CLI turns them on
on its accelerator; ``system.cnn_bf16=false system.ft_bf16=false
system.encoder_bf16=false`` runs the network in float32. The rasterizer
is float32 either way. ``run`` takes the config sections as plain dicts
and needs no PyYAML; the CLI reads the YAML and calls it.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Any, Dict, Optional, Union

from igs_tpu_torch.builders import (
    build_dataset, build_model, build_raster_settings, build_stream_configs)
from igs_tpu_torch.config import ExperimentConfig, config_from_dict
from igs_tpu_torch.stream.pipeline import StreamingPipeline
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.resume import load_params_with_overlays


def run(cfg: Union[ExperimentConfig, Dict[str, Any]],
        max_batches: Optional[int] = None, device=None) -> Dict[str, Any]:
    """Stream per the config's ``system``, ``data`` and ``opt`` sections
    (an ExperimentConfig or a dict of them, left unchanged) and return
    the results dict that ``results.json`` holds."""
    if isinstance(cfg, ExperimentConfig):
        cfg = {"opt": cfg.opt, "data": cfg.data, "system": cfg.system}
    cfg = config_from_dict(copy.deepcopy(dict(cfg)))
    dev = resolve_device(device)
    # a resume_cfg's system section under this config's keys
    resume_cfg = cfg.opt.get("resume_cfg")
    if resume_cfg and os.path.exists(resume_cfg):
        from igs_tpu_torch.config import load_config

        sys_cfg = load_config(resume_cfg).system
        sys_cfg.update(cfg.system or {})
        cfg.system.update(sys_cfg)
    cfg.data["data"]["up_sample"] = cfg.system.get("up_sample", True)

    ds = build_dataset(cfg.data, training=False)
    model = build_model(cfg.system, device=dev,
                        bf16_default=dev.type == "cuda")
    stream_cfg, refine_cfg = build_stream_configs(cfg.opt)
    out_h = int(cfg.data["data"].get("output_height", 1014))
    out_w = int(cfg.data["data"].get("output_width", 1352))
    settings = build_raster_settings(out_h, out_w, clamp=True)
    load_params_with_overlays(model, cfg.system, cfg.opt)

    pipe = StreamingPipeline(model, ds, stream_cfg, refine_cfg, settings,
                             device=dev)
    results = pipe.run(max_batches=max_batches)
    print(f"avg PSNR {results['avg']:.2f}  "
          f"sec/frame {results['sec/frame']:.3f}  "
          f"fps(render) {results['fps']:.1f}")
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args, extras = ap.parse_known_args(argv)

    from igs_tpu_torch.config import load_config

    run(load_config(args.config, cli_args=extras),
        max_batches=args.max_batches, device=args.device)


if __name__ == "__main__":
    main()
