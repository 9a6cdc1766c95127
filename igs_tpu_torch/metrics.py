"""Offline PSNR / SSIM / LPIPS over paired render and GT directories: the
port's counterpart of ``metrics.py`` (the reference's RaDe-GS
metric.py, the 3DGS evaluation protocol).

    python -m igs_tpu_torch.metrics --renders R --gt G
        [--lpips-weights P] [--out O] [--device cpu]

The ``.png``, ``.jpg`` and ``.jpeg`` files of ``--renders`` (any case),
sorted by name, each against the file of the same name in ``--gt``,
decoded by the port's codecs (``data/images.read_image``: PIL's pixels,
no PIL needed): the first three channels, /255 in float32; PSNR and SSIM
through ``train/losses.py``; LPIPS (``train/lpips.py``) at the image's
own size on ``2r − 1, 2g − 1``, only when ``--lpips-weights`` loads (more
than 10 tensors), as the JAX CLI. It prints the means as JSON and writes
``{"results": ..., "per_view": ...}`` to ``--out`` (default
``<renders>/../metric_results.json``); the ms per image (decode, PSNR and
SSIM, LPIPS, total) go to standard error. The CLI turns TF32 off, so the
card's convolutions are float32 as the CPU's. A one-channel (greyscale)
image raises a ``ValueError`` naming the file, where the JAX CLI fails on
``[..., :3]`` of a 2-D array. It runs on the card unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from igs_tpu_torch.data.images import read_image
from igs_tpu_torch.train.losses import psnr as psnr_fn, ssim as ssim_fn
from igs_tpu_torch.train.lpips import make_lpips
from igs_tpu_torch.utils.device import resolve_device

SUFFIXES = (".png", ".jpg", ".jpeg")


def _load(path: str, device) -> torch.Tensor:
    img = read_image(path)
    if img.ndim != 3:
        raise ValueError(f"{path}: a one-channel image; the metrics need "
                         "RGB (the JAX CLI fails on it too)")
    x = np.asarray(img[..., :3] / 255.0, np.float32).transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(x))[None].to(device)


def run(renders: str, gt: str, lpips_weights: Optional[str] = None,
        out: Optional[str] = None, device=None) -> Dict[str, Any]:
    """Score ``renders`` against ``gt``; returns ``{"results", "per_view",
    "ms"}`` and writes the first two to ``out``."""
    dev = resolve_device(device)
    lpips_fn, lpips_ok = make_lpips(lpips_weights or None, device=dev)
    names = sorted(f for f in os.listdir(renders)
                   if f.lower().endswith(SUFFIXES))
    per_view: Dict[str, Dict[str, float]] = {"psnr": {}, "ssim": {},
                                             "lpips": {}}
    ms = {"decode": 0.0, "psnr_ssim": 0.0, "lpips": 0.0}

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    with torch.no_grad():
        for name in names:
            t0 = clock()
            r = _load(os.path.join(renders, name), dev)
            g = _load(os.path.join(gt, name), dev)
            t1 = clock()
            per_view["psnr"][name] = float(psnr_fn(r, g))
            s, _ = ssim_fn(r, g)
            per_view["ssim"][name] = float(s)
            t2 = clock()
            if lpips_ok:
                per_view["lpips"][name] = float(
                    lpips_fn(2 * r - 1, 2 * g - 1)[0])
            t3 = clock()
            for k, dt in (("decode", t1 - t0), ("psnr_ssim", t2 - t1),
                          ("lpips", t3 - t2)):
                ms[k] += 1e3 * dt
    n = max(len(names), 1)
    ms = {k: v / n for k, v in ms.items()}
    ms["total"] = sum(ms.values())
    results = {"PSNR": float(np.mean(list(per_view["psnr"].values()))),
               "SSIM": float(np.mean(list(per_view["ssim"].values())))}
    if lpips_ok:
        results["LPIPS"] = float(np.mean(list(per_view["lpips"].values())))
    out = out or os.path.join(renders, "..", "metric_results.json")
    with open(out, "w") as f:
        json.dump({"results": results, "per_view": per_view}, f, indent=2)
    return {"results": results, "per_view": per_view, "ms": ms}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--renders", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--lpips-weights", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    # float32 convolutions and matmuls on the card, as the CPU computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = run(args.renders, args.gt, args.lpips_weights or None,
              args.out or None, args.device)
    print(json.dumps(res["results"], indent=2))
    n = len(res["per_view"]["psnr"])
    print(f"metrics: {n} images; ms per image "
          f"{json.dumps({k: round(v, 3) for k, v in res['ms'].items()})}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
