"""The approximation ladder's trained checkpoint: the 256² synthetic
training scene, its one-pair overfit file, and AGM-Net trained on it by
the port's ``train_agm``.

    python -m igs_tpu_torch.tools.ladder_checkpoint --root DIR
        [--workspace DIR] [--max-steps N] [--device cpu] [a.b.c=value ...]

No trained weights exist offline, so ``gates_256`` needs this first. The
scene is ``configs/synthetic_train_256.yaml``'s recipe (its header: 26
frames, 14 cameras, 4096 Gaussians at 256², interval 5, motion scale
0.3, a static fraction of 0.3, opacity logits in [-0.5, 2] and
log-scales in [-4.6, -3.4]), written by ``data/synthetic.
build_synthetic_scene`` under ``--root``; the overfit file is built as
``configs/synthetic_overfit_256.yaml``'s header says (training item 4,
``colmap_0`` → ``colmap_5``, twice, and once for validation); then
``train_agm.run`` on that config (800 steps of batch 2 with the full
128-channel network on the packed route, the JAX package's training
route on its chip), its ``data.data.root_dir`` set to ``--root`` and its
workspace to ``--workspace``, with any further overrides. The JSON
records the steps, the training's wall seconds (host clock) and seconds
a step, the first and last logged losses and PSNRs, the eval PSNRs and
the last checkpoint's path (``<workspace>/<epoch>/params.pth``), which
``gates_256`` takes together with ``data.data.root_dir=<root>`` and
``data.data.start_gs_path=<root>/train_scene/colmap_0/3dgs_rade/
point_cloud/iteration_6000_compress/point_cloud.ply``.
"""

from __future__ import annotations

import json
import os
import sys
import time

from igs_tpu_torch.tools.probe import _ROOT as ROOT, Probe, parser

TRAIN_CONFIG = os.path.join(ROOT, "configs", "synthetic_overfit_256.yaml")
# configs/synthetic_train_256.yaml's header
RECIPE = dict(scene_name="train_scene", n_frames=26, n_cams=14,
              n_gaussians=4096, height=256, width=256, interval=5,
              motion_scale=0.3, static_frac=0.3, opacity_range=(-0.5, 2.0),
              scale_range=(-4.6, -3.4))
OVERFIT_ITEM = 4  # colmap_0 -> colmap_5: 5 frames of core drift


def write_overfit_pairs(root: str, scene_name: str = "train_scene") -> str:
    """``<scene>_pairs_overfit.json``: one training pair twice, and once
    for validation."""
    with open(os.path.join(root, f"{scene_name}_pairs.json")) as f:
        pair = json.load(f)["train"][OVERFIT_ITEM]
    path = os.path.join(root, f"{scene_name}_pairs_overfit.json")
    with open(path, "w") as f:
        json.dump({"train": [pair] * 2, "val": [pair]}, f)
    return path


def start_gs_path(root: str, scene_name: str = "train_scene") -> str:
    return os.path.join(root, scene_name, "colmap_0", "3dgs_rade",
                        "point_cloud", "iteration_6000_compress",
                        "point_cloud.ply")


def last_checkpoint(workspace: str) -> str:
    epochs = [int(d) for d in os.listdir(workspace) if d.isdigit()
              and os.path.exists(os.path.join(workspace, d, "params.pth"))]
    if not epochs:
        raise FileNotFoundError(f"no checkpoint under {workspace}")
    return os.path.join(workspace, str(max(epochs)), "params.pth")


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--root", required=True,
                    help="where the scene is written")
    ap.add_argument("--workspace", default=os.path.join(
        "logs", "igs_tpu_torch", "overfit256"))
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop after this many steps (default: the "
                         "config's 800)")
    ap.add_argument("--recipe", default="{}",
                    help="JSON of build_synthetic_scene arguments that "
                         "replace the recipe's (a smaller scene)")
    ap.add_argument("overrides", nargs="*",
                    help="dotted overrides of the training config")
    args = ap.parse_intermixed_args(argv)
    pr = Probe("ladder_checkpoint", args)
    from igs_tpu_torch import train_agm
    from igs_tpu_torch.config import load_config
    from igs_tpu_torch.data.synthetic import build_synthetic_scene

    recipe = dict(RECIPE, **json.loads(args.recipe))
    t0 = time.perf_counter()
    build_synthetic_scene(args.root, device=pr.dev, **recipe)
    write_overfit_pairs(args.root, recipe["scene_name"])
    pr.put("scene_s", time.perf_counter() - t0, "s")
    cfg = load_config(TRAIN_CONFIG, cli_args=[
        f"data.data.root_dir={args.root}",
        f"opt.workspace={args.workspace}", *args.overrides])
    t0 = time.perf_counter()
    out = train_agm.run(cfg, max_steps=args.max_steps, device=pr.dev)
    train_s = time.perf_counter() - t0
    recs = out["records"]
    pr.put("steps", out["steps"])
    pr.put("train_s", train_s, "s")
    pr.put("sec/step", train_s / max(out["steps"], 1), "s")
    pr.put("first", recs[0] if recs else None)
    pr.put("last", recs[-1] if recs else None)
    pr.put("eval", out["eval"])
    pr.put("checkpoint", last_checkpoint(args.workspace))
    pr.put("start_gs_path", start_gs_path(args.root, recipe["scene_name"]))
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
