"""Streaming reconstruction: the port's counterpart of ``infer_stream.py``
(the reference's infer_batch.py).

    python -m igs_tpu_torch.infer_stream --config <yaml> [--max-batches N]
        [--device D] [--backend nccl|gloo] [--share-card] [a.b.c=value ...]

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

With ``opt.data_parallel`` or ``opt.refine_parallel`` above 1 the stream
runs on that many ranks (the larger): in the group torchrun started, or
else in ranks it spawns itself, one per card over NCCL; ``--backend gloo
--share-card`` puts them all on one card, and ``--device cpu --backend
gloo`` on the CPU (``parallel/launch.py``). Rank 0 writes the files and
returns the results.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from typing import Any, Dict, Optional, Union

from igs_tpu_torch.builders import (
    build_dataset, build_model, build_raster_settings, build_stream_configs)
from igs_tpu_torch.config import ExperimentConfig, config_from_dict
from igs_tpu_torch.parallel import distributed as D
from igs_tpu_torch.parallel.launch import run_ranked
from igs_tpu_torch.stream.pipeline import StreamingPipeline
from igs_tpu_torch.utils.cache import enable_persistent_cache
from igs_tpu_torch.utils.device import resolve_device
from igs_tpu_torch.utils.profiling import kernel_launches
from igs_tpu_torch.utils.resume import load_params_with_overlays


def run(cfg: Union[ExperimentConfig, Dict[str, Any]],
        max_batches: Optional[int] = None, device=None,
        backend: Optional[str] = None, share_card: bool = False
        ) -> Dict[str, Any]:
    """Stream per the config's ``system``, ``data`` and ``opt`` sections
    (an ExperimentConfig or a dict of them, left unchanged) and return
    the results dict that ``results.json`` holds. ``backend`` and
    ``share_card`` lay out the ranks of a parallel config
    (``parallel/launch.rank_plan``)."""
    if isinstance(cfg, ExperimentConfig):
        cfg = {"opt": cfg.opt, "data": cfg.data, "system": cfg.system}
    cfg = copy.deepcopy(dict(cfg))
    stream_cfg, _ = build_stream_configs(cfg["opt"])
    ranks = max(stream_cfg.data_parallel, stream_cfg.refine_parallel)
    return run_ranked(_run_rank, ranks, (cfg, max_batches),
                      device=None if device is None else str(device),
                      backend=backend, share_card=share_card)


def _run_rank(rank: int, device, cfg: Dict[str, Any],
              max_batches: Optional[int]) -> Dict[str, Any]:
    """``run`` on this rank (or alone)."""
    cfg = config_from_dict(cfg)
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
    if D.process_index() == 0:
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
    ap.add_argument("--backend", default=None, choices=D.BACKENDS,
                    help="process-group backend of a parallel config "
                         "(default: nccl)")
    ap.add_argument("--share-card", action="store_true",
                    help="run every rank on the one card --device names "
                         "(needs --backend gloo)")
    args, extras = ap.parse_known_args(argv)
    enable_persistent_cache()

    from igs_tpu_torch.config import load_config

    run(load_config(args.config, cli_args=extras),
        max_batches=args.max_batches, device=args.device,
        backend=args.backend, share_card=args.share_card)
    # this process's launches (spawned ranks count their own)
    print(f"kernel launches {json.dumps(kernel_launches())}",
          file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
