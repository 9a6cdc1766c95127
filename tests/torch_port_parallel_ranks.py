"""The ranks' side of the port's parallel tests.

Each function here runs in a process that ``igs_tpu_torch.parallel.launch
.spawn`` started, as ``fn(rank, device, *args)``, after the rank joined
its gloo group. It imports torch and the port only (never JAX: every rank
would pay its import), takes numpy inputs, and returns numpy results,
which the test compares with the JAX package's in the parent.
"""

from __future__ import annotations

import numpy as np
import torch

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.parallel import distributed as D
from igs_tpu_torch.parallel.mesh import make_mesh
from igs_tpu_torch.stream import refine as tref


def gaussians_from(arrays) -> Gaussians:
    return Gaussians.create(*(arrays[k] for k in (
        "xyz", "opacity", "rotation", "scaling", "shs")),
        valid=arrays["valid"], device="cpu")


def gaussians_numpy(g: Gaussians) -> dict:
    return {k: getattr(g, k).detach().cpu().numpy()
            for k in ("xyz", "opacity", "rotation", "scaling", "shs",
                      "valid")}


def collectives(rank, device):
    """The mesh, the sum, ``local_batch_slice`` and ``all_processes_mean``
    over the group, as ``tests/test_multihost.py`` checks JAX's."""
    n = D.process_count()
    mesh = D.make_global_mesh()
    x = torch.arange(4, dtype=torch.float32) + 10 * rank
    mesh2 = make_mesh(data=1, tile=n)
    half = make_mesh(data=1, ranks=[0])
    return {
        "count": n, "index": D.process_index(),
        "shape": mesh.shape, "coords": mesh.coords,
        "sum": mesh.sum(x, "data").numpy(),
        "tile_sum": mesh2.sum(x, "tile").numpy(),
        "tile_max": mesh2.max(x, "tile").numpy(),
        "gather": mesh.all_gather(torch.tensor([rank == 0]), "data").numpy(),
        "slice": D.local_batch_slice(8),
        "mean": D.all_processes_mean(float(rank + 1)),
        "given": half.give_to_all({"v": torch.full((3,), 7.0)}
                                  if half.member else None)["v"].numpy(),
    }


def refine_sharded(rank, device, scene, cfg_kw, order, iters, samples):
    """``refine_run_sharded`` on a (1, n) mesh with the split draws
    ``samples`` fed to each densify; per-step losses and the final
    Gaussians."""
    import igs_tpu_torch.stream.refine as mod

    fed = iter(samples)
    densify = mod.densify_and_prune
    mod.densify_and_prune = lambda st, c, extent: densify(
        st, c, extent, tuple(torch.from_numpy(s) for s in next(fed)))
    g = gaussians_from(scene["gaussians"])
    cams = Camera.stack([Camera.from_w2c(w, 0.8, 0.8, *scene["hw"],
                                         device="cpu")
                         for w in scene["w2c"]])
    mesh = make_mesh(data=1, tile=D.process_count())
    state = tref.init_refine_state(g, capacity=g.num_capacity)
    losses = []
    state = tref.refine_run_sharded(
        state, cams, torch.from_numpy(scene["gts"]), order,
        torch.from_numpy(scene["bg"]), tref.RefineConfig(**cfg_kw),
        scene["settings"], 1.0, iters, mesh,
        on_step=lambda it, st, m: losses.append(float(m["loss"])))
    return {"losses": losses, "gaussians": gaussians_numpy(state.gaussians)}


class MemoryStream:
    """``tests/torch_port_common.MemoryStream`` without its JAX imports:
    collate()-layout items in memory, the start Gaussians on the first
    window, ``refine`` the key frames' refine data."""

    def __init__(self, items, start_gs, refine=None):
        self.items, self.start_gs, self.refine = items, start_gs, refine or {}

    def build_refine_dataset(self, eval_batch_size):
        self.refine_dataset = set(
            range(eval_batch_size, len(self.items) + 1, eval_batch_size))

    def get_refine_data(self, key):
        return self.refine[key]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def collate(self, items):
        batch = {k: np.stack([it[k] for it in items])
                 for k in items[0] if k not in ("keyframe", "idx")}
        batch["keyframe"] = [it["keyframe"] for it in items]
        if items[0]["idx"] == 0:
            batch["gs"] = [self.start_gs]
        return batch


def agm_model(state_dict, model_kw):
    from igs_tpu_torch.models.agm import AGMNet

    model = AGMNet(**model_kw)
    model.load_state_dict(state_dict)
    return model.eval()


def stream_run(rank, device, state_dict, model_kw, items, gaussians, refine,
               cfg_kw, settings, workspace):
    """The port's ``StreamingPipeline`` over the group: its results, its
    refine log, and whether this rank writes the files."""
    from igs_tpu_torch.stream.pipeline import StreamConfig, StreamingPipeline
    from igs_tpu_torch.stream.refine import RefineConfig

    cfg = StreamConfig(workspace=workspace, **cfg_kw)
    pipe = StreamingPipeline(agm_model(state_dict, model_kw),
                             MemoryStream(items, gaussians_from(gaussians),
                                          refine),
                             cfg, RefineConfig(), settings, device=device)
    results = pipe.run(max_batches=2)
    return {"results": results, "refine_log": pipe.refine_log,
            "writer": pipe.writer}


def agm_sharded(rank, device, state_dict, model_kw, batch, state, gaussians,
                settings, depth_settings, kw):
    """``sharded_agm_apply`` on the (n, 1) mesh: the gathered outputs."""
    from igs_tpu_torch.ops.anchors import AnchorState
    from igs_tpu_torch.parallel.spmd import sharded_agm_apply

    model = agm_model(state_dict, model_kw)
    mesh = make_mesh(data=D.process_count(), tile=1)
    t = lambda x: torch.from_numpy(x)
    with torch.no_grad():
        out = sharded_agm_apply(model, settings, depth_settings, mesh, **kw)(
            {k: t(v) for k, v in batch.items()},
            AnchorState(*(t(x) for x in state)),
            Gaussians(**{k: t(v) for k, v in gaussians.items()}))
    return D.tree_map(lambda x: x.float().numpy() if x.is_floating_point()
                      else x.numpy(), {k: v for k, v in out.items()
                                       if k != "3dgs"}) | {
        "3dgs": gaussians_numpy(out["3dgs"])}


def train_steps(rank, device, state_dict, model_kw, cfg, settings, batches,
                state, gaussians, total_steps):
    """Data-parallel train steps: this rank's slice of each batch through
    ``make_train_step(mesh=)`` on the (n, 1) mesh; the metrics, the clipped
    gradient of step 1 (Adam's first moment over 1 − b1), the parameters
    after each step and the largest gradient mask of the steps."""
    from igs_tpu_torch.ops.anchors import AnchorState
    from igs_tpu_torch.parallel.mesh import shard_batch
    from igs_tpu_torch.train.driver import make_optimizer, make_train_step

    model = agm_model(state_dict, model_kw).train()
    mesh = make_mesh(data=D.process_count(), tile=1)
    optimizer, _ = make_optimizer(model, cfg, total_steps,
                                  train_backbone=model.train_backbone)
    step = make_train_step(cfg, settings, mesh=mesh)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    st = shard_batch(mesh, AnchorState(*(t(x) for x in state)))
    gs = shard_batch(mesh, Gaussians(**{k: t(v) for k, v in
                                        gaussians.items()}))
    out = {"metrics": [], "params": [], "masks": []}
    for i, b in enumerate(batches):
        m = step(model, optimizer, shard_batch(
            mesh, {k: t(v) for k, v in b.items()}), st, gs)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append({k: v.detach().numpy().copy()
                              for k, v in model.state_dict().items()})
        big = {k: (p.grad.abs() > 1e-4).numpy()
               for k, p in optimizer.params.items() if p.grad is not None}
        out["masks"].append(big if i == 0 else {
            k: out["masks"][-1][k] & big[k] for k in big})
        if i == 0:
            out["mu1"] = {k: (v / (1 - cfg.beta1)).numpy()
                          for k, v in optimizer.mu.items()}
    return out


def frame0_sweep(rank, device, frame_dirs, cfg, samples, capacity,
                 prune_percent, finetune_iters, max_pairs):
    """``build_frame0.train_frames_spmd`` in this rank of the group, the
    frames split over the ranks, each frame's densify fed the draws
    ``samples`` in turn: every frame's record."""
    from igs_tpu_torch import build_frame0

    densify = build_frame0.frame0_densify_and_prune
    train = build_frame0.train_one_frame
    fed = []

    def fed_densify(st, c, extent, size):
        return densify(st, c, extent, size,
                       tuple(torch.from_numpy(s) for s in next(fed[-1])))

    def train_fed(*args, **kw):
        fed.append(iter(samples))  # each frame from the first draws
        return train(*args, **kw)

    build_frame0.frame0_densify_and_prune = fed_densify
    build_frame0.train_one_frame = train_fed
    return build_frame0.train_frames_spmd(
        frame_dirs, "images_512", "sweep", cfg.iterations, prune_percent,
        capacity, n_devices=D.process_count(), finetune_iters=finetune_iters,
        device=device, max_pairs=max_pairs, backend="gloo", cfg=cfg)
