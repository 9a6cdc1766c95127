"""Key-frame refine: Adam on the Gaussian parameters + max-bounded densify.

Counterpart of ``igs_tpu/stream/refine.py`` (the reference's trainable
GaussianModel in the streaming refine loop):
  * ``init_refine_state``: pad to capacity, zero Adam moments;
  * ``refine_step``: loss 0.8·L1 + 0.2·(1−SSIM) of one color render,
    gradients of the five raw parameters and of a zero screen-space offset
    (the densify statistic), then gated Adam written out (eps 1e-15, bias
    correction from a float32 step, per-group learning rates, frozen
    groups, ``use_new_shs``);
  * ``densify_and_prune``: clone (inert at percent_dense 0) and split into
    free slots, the r-th free slot taking the r-th selected row, then the
    opacity prune;
  * ``refine_run``: the loop over ``view_order`` with interval densify,
    and with ``rebin_every > 1`` per-view pair lists rebuilt only when
    staler than that many Adam steps.

The Gaussian array has a fixed capacity: densify writes new rows into dead
slots and prune clears ``valid``. Adam is explicit (not ``torch.optim``)
because densify zeroes single moment rows. Split samples come from the
state's ``torch.Generator``; a caller may inject them instead.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.core.quaternion import quat_to_rotmat
from igs_tpu_torch.ops.rasterize import (
    RasterSettings, build_pairs_packed, rasterize)
from igs_tpu_torch.train.losses import l1_loss, ssim

TRAINABLE = ("xyz", "rotation", "shs", "opacity", "scaling")


class RefineConfig(NamedTuple):
    """Refine configuration (the YAML's opt.* keys)."""

    position_lr: float = 0.0016
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.01
    lambda_l1: float = 0.8
    no_shs: bool = False
    no_opacity: bool = False
    no_scaling: bool = False
    use_mask: bool = False
    # train only newly densified rows' SHs; rows valid before the refine
    # keep theirs
    use_new_shs: bool = False
    use_densify: bool = True
    densify_until_iter: int = 100
    densify_from_iter: int = 0
    densification_interval: int = 20
    densify_grad_threshold: float = 0.00015
    min_opacity: float = 0.005
    percent_dense: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15
    # pair-list staleness bound in Adam steps: 1 bins every step; K > 1
    # rebuilds a view's list only when it is K steps old (features are
    # still gathered from the current parameters every step)
    rebin_every: int = 1

    def lr_for(self, name: str) -> float:
        return {"xyz": self.position_lr, "rotation": self.rotation_lr,
                "shs": self.feature_lr, "opacity": self.opacity_lr,
                "scaling": self.scaling_lr}[name]

    def trains(self, name: str) -> bool:
        if name == "shs":
            return not self.no_shs
        if name == "opacity":
            return not self.no_opacity
        if name == "scaling":
            return not self.no_scaling
        return True  # xyz, rotation always train


@dataclass
class RefineState:
    gaussians: Gaussians
    adam_m: Dict[str, torch.Tensor]
    adam_v: Dict[str, torch.Tensor]
    step: int
    max_radii2d: torch.Tensor  # (N,) f32
    xyz_grad_accum: torch.Tensor  # (N,) f32
    denom: torch.Tensor  # (N,) f32
    generator: torch.Generator  # split samples
    overflow: torch.Tensor  # () int32, the largest overflow code seen
    init_valid: torch.Tensor  # (N,) rows valid before the refine


def init_refine_state(gaussians: Gaussians, capacity: int,
                      seed: int = 0) -> RefineState:
    """Pad to ``capacity`` and zero the Adam moments."""
    g = gaussians.pad_to(capacity)
    dev = g.xyz.device
    zeros = {k: torch.zeros_like(getattr(g, k)) for k in TRAINABLE}
    return RefineState(
        gaussians=g,
        adam_m=zeros,
        adam_v={k: torch.zeros_like(v) for k, v in zeros.items()},
        step=0,
        max_radii2d=torch.zeros(capacity, device=dev),
        xyz_grad_accum=torch.zeros(capacity, device=dev),
        denom=torch.zeros(capacity, device=dev),
        generator=torch.Generator(device=dev).manual_seed(seed),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
        init_valid=g.valid.clone(),
    )


def loss_and_grads(gaussians: Gaussians, camera: Camera, gt_image, bg,
                   cfg: RefineConfig, settings: RasterSettings,
                   pairs_override=None):
    """(loss, grads by name, grad of the screen-space offset (N, 2), radii,
    mse, overflow code) of one render of ``camera``."""
    params = {k: getattr(gaussians, k).detach().requires_grad_(True)
              for k in TRAINABLE}
    n = gaussians.num_capacity
    m2o = torch.zeros((n, 2), device=gaussians.xyz.device, requires_grad=True)
    g = replace(gaussians, **params)
    with torch.enable_grad():
        out = rasterize(
            means3d=g.get_xyz, opacity=g.get_opacity, scaling=g.get_scaling,
            rotation=g.get_rotation, camera=camera, shs=g.shs, bg=bg,
            means2d_offset=m2o, valid=g.valid, settings=settings,
            pairs_override=pairs_override)
        img = out["color"]
        s, _ = ssim(img, gt_image)
        loss = (cfg.lambda_l1 * l1_loss(img, gt_image)
                + (1 - cfg.lambda_l1) * (1.0 - s))
        grads = torch.autograd.grad(
            loss, [params[k] for k in TRAINABLE] + [m2o])
    mse = torch.mean((img.detach() - gt_image) ** 2)
    return (loss.detach(), dict(zip(TRAINABLE, grads[:-1])), grads[-1],
            out["radii"], mse, out["overflow_tiles"])


def refine_step(state: RefineState, camera: Camera, gt_image: torch.Tensor,
                bg: torch.Tensor, cfg: RefineConfig, settings: RasterSettings,
                do_densify_stats: bool = True, pairs_override=None
                ) -> Tuple[RefineState, Dict[str, torch.Tensor]]:
    """One optimisation iteration; returns the new state and {loss, psnr}
    as device tensors (no host sync)."""
    g = state.gaussians
    loss, grads, g_m2o, radii, mse, overflow = loss_and_grads(
        g, camera, gt_image, bg, cfg, settings, pairs_override)

    # gradient gating: dead rows, frozen groups, optionally the static region
    gate = g.valid
    if cfg.use_mask and g.mask is not None:
        gate = gate & g.mask
    gatef = gate.float()

    step = state.step + 1
    # bias corrections 1 − β^t evaluated in float32, as the JAX package does
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(cfg.beta1, dtype=torch.float32) ** t)
    bc2 = float(1 - torch.tensor(cfg.beta2, dtype=torch.float32) ** t)
    new_params, new_m, new_v = {}, {}, {}
    for name in TRAINABLE:
        p = getattr(g, name)
        gname = gatef
        if name == "shs" and cfg.use_new_shs:
            gname = gatef * (~state.init_valid).float()
        gr = grads[name] * gname.reshape((-1,) + (1,) * (p.dim() - 1))
        m = cfg.beta1 * state.adam_m[name] + (1 - cfg.beta1) * gr
        v = cfg.beta2 * state.adam_v[name] + (1 - cfg.beta2) * gr * gr
        mhat = m / bc1
        vhat = v / bc2
        if cfg.trains(name):
            p = p - cfg.lr_for(name) * mhat / (torch.sqrt(vhat) + cfg.eps)
        new_params[name] = p
        new_m[name] = m
        new_v[name] = v

    if do_densify_stats:
        vis = (radii > 0) & g.valid
        max_radii = torch.where(
            vis, torch.maximum(state.max_radii2d, radii.float()),
            state.max_radii2d)
        gnorm = torch.linalg.norm(g_m2o, dim=-1)
        accum = state.xyz_grad_accum + torch.where(
            vis, gnorm, torch.zeros_like(gnorm))
        denom = state.denom + vis.float()
    else:
        max_radii, accum, denom = (state.max_radii2d, state.xyz_grad_accum,
                                   state.denom)
    new_state = replace(
        state, gaussians=replace(g, **new_params), adam_m=new_m,
        adam_v=new_v, step=step, max_radii2d=max_radii, xyz_grad_accum=accum,
        denom=denom, overflow=torch.maximum(state.overflow,
                                            overflow.to(torch.int32)))
    return new_state, {"loss": loss, "psnr": -10 * torch.log10(mse)}


def _scatter_rows(g: Gaussians, adam_m, adam_v, src_mask: torch.Tensor,
                  rows: Dict[str, torch.Tensor]):
    """Write ``rows`` of the ``src_mask`` rows into dead slots: the r-th
    free slot takes the r-th selected row, and what does not fit is
    dropped (the max-points bound). Moments of filled slots are zeroed.
    Returns (gaussians, adam_m, adam_v, n_added)."""
    n = g.num_capacity
    free = ~g.valid
    free_rank = torch.cumsum(free.long(), 0) - 1
    src_rank = torch.cumsum(src_mask.long(), 0) - 1
    n_add = torch.minimum(free.sum(), src_mask.sum())
    take = src_mask & (src_rank < n_add)
    taken = torch.zeros(n, dtype=torch.long, device=free.device)
    idx = torch.nonzero(take)[:, 0]
    taken[:idx.shape[0]] = idx
    is_dest = free & (free_rank < n_add)
    gidx = taken[free_rank.clamp(0, n - 1)]  # per-slot source row

    def sel(arr):
        return is_dest.reshape((-1,) + (1,) * (arr.dim() - 1))

    def fill(arr, new):
        return torch.where(sel(arr), new[gidx], arr)

    g2 = replace(
        g, xyz=fill(g.xyz, rows["xyz"]),
        opacity=fill(g.opacity, rows["opacity"]),
        rotation=fill(g.rotation, rows["rotation"]),
        scaling=fill(g.scaling, rows["scaling"]),
        shs=fill(g.shs, rows["shs"]),
        valid=g.valid | is_dest,
        # clones and splits inherit the source row's dynamic-region bit
        mask=None if g.mask is None else fill(g.mask, g.mask))

    def zero(d):
        return {k: torch.where(sel(a), torch.zeros_like(a), a)
                for k, a in d.items()}

    return g2, zero(adam_m), zero(adam_v), n_add


def _split_rows(g: Gaussians, eps: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One split sample per row: xyz + R (eps · scale), scale / 1.6."""
    std = g.get_scaling
    rot = quat_to_rotmat(g.rotation, normalize=True)
    offset = torch.einsum("nij,nj->ni", rot, eps * std)
    return {"xyz": g.xyz + offset, "opacity": g.opacity,
            "rotation": g.rotation,
            "scaling": torch.log(g.get_scaling / (0.8 * 2)), "shs": g.shs}


def densify_and_prune(state: RefineState, cfg: RefineConfig, extent: float,
                      samples: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      = None) -> RefineState:
    """Max-bounded densify (clone + split) then the opacity prune.

    ``samples``: the two (N, 3) standard-normal split draws (new rows,
    then the rows replaced in place); drawn from the state's generator
    when None.
    """
    g = state.gaussians
    n = g.num_capacity
    dev = g.xyz.device
    valid_before = g.valid
    grads = torch.where(state.denom > 0,
                        state.xyz_grad_accum / state.denom.clamp_min(1.0),
                        torch.zeros_like(state.denom))
    selected = (grads >= cfg.densify_grad_threshold) & g.valid
    is_big = torch.amax(g.get_scaling, dim=1) > cfg.percent_dense * extent

    # clone small Gaussians (inert at percent_dense == 0)
    clone_sel = selected & ~is_big
    g, m, v, _ = _scatter_rows(
        g, state.adam_m, state.adam_v, clone_sel,
        {k: getattr(g, k) for k in TRAINABLE})

    # split big ones: one sample into a free slot, and the original row
    # replaced by a second sample (add two, prune the original)
    if samples is None:
        samples = tuple(torch.randn((n, 3), generator=state.generator,
                                    device=dev) for _ in range(2))
    eps_a, eps_b = samples
    split_sel = selected & is_big
    g, m, v, _ = _scatter_rows(g, m, v, split_sel, _split_rows(g, eps_a))
    rows_b = _split_rows(g, eps_b)
    sel3 = split_sel[:, None]
    g = replace(g, xyz=torch.where(sel3, rows_b["xyz"], g.xyz),
                scaling=torch.where(sel3, rows_b["scaling"], g.scaling))

    def reset(d):  # re-split originals start with fresh moments
        return {k: torch.where(
            split_sel.reshape((-1,) + (1,) * (a.dim() - 1)),
            torch.zeros_like(a), a) for k, a in d.items()}

    m, v = reset(m), reset(v)

    # prune by opacity (size pruning is off in the streaming refine)
    g = replace(g, valid=g.valid & (g.get_opacity[:, 0] >= cfg.min_opacity))
    new_rows = (g.valid & ~valid_before) | split_sel
    return replace(
        state, gaussians=g, adam_m=m, adam_v=v,
        max_radii2d=torch.zeros_like(state.max_radii2d),
        xyz_grad_accum=torch.zeros_like(state.xyz_grad_accum),
        denom=torch.zeros_like(state.denom),
        init_valid=state.init_valid & ~new_rows)


def view_order(iters: int, views: int) -> list:
    """The view of each step: permutations of the views drawn from
    ``np.random.RandomState(0)``, one after another (every view once
    before any repeats, as the reference pops views without replacement)."""
    rng = np.random.RandomState(0)
    order: list = []
    while len(order) < iters:
        order.extend(rng.permutation(views).tolist())
    return order[:iters]


def _densify_now(cfg: RefineConfig, it: int) -> bool:
    return (cfg.use_densify and it < cfg.densify_until_iter
            and it > cfg.densify_from_iter
            and it % cfg.densification_interval == 0)


def refine_run(state: RefineState, cameras: Camera, gt_images: torch.Tensor,
               view_order, bg: torch.Tensor, cfg: RefineConfig,
               settings: RasterSettings, extent: float, iters: int,
               on_step: Optional[Callable[[int, RefineState, Dict], None]]
               = None) -> RefineState:
    """The key-frame refine loop over ``view_order`` (one view per step)
    with interval densify. ``cameras`` is a stack of the training views,
    ``gt_images`` (V, 3, H, W). ``on_step(it, state, metrics)`` is called
    after each step (and its densify), with device-tensor metrics.

    With ``cfg.rebin_every > 1`` each view's pair list is built before the
    loop and rebuilt when it is ``rebin_every`` Adam steps old, or after a
    densify; the features are gathered from the current parameters every
    step, so only the tile assignment and per-tile depth order go stale.
    """
    order = [int(v) for v in view_order][:iters]
    rebin = cfg.rebin_every > 1
    pairs, built = {}, {}

    def build(v, st):
        g = st.gaussians
        return build_pairs_packed(
            g.get_xyz, g.get_opacity, g.get_scaling, g.get_rotation,
            cameras.view(v), valid=g.valid, settings=settings)

    if rebin:
        for v in range(gt_images.shape[0]):
            pairs[v], built[v] = build(v, state), 0
    for it, v in enumerate(order):
        override = None
        if rebin:
            if it - built[v] >= cfg.rebin_every:
                pairs[v], built[v] = build(v, state), it
            override = pairs[v]
        state, metrics = refine_step(state, cameras.view(v), gt_images[v], bg,
                                     cfg, settings, pairs_override=override)
        if _densify_now(cfg, it):
            state = densify_and_prune(state, cfg, extent)
            # the Gaussian set changed: every cached list is invalid
            built = dict.fromkeys(built, -(cfg.rebin_every + 1))
        if on_step is not None:
            on_step(it, state, metrics)
    return state


def convert2stream(state: RefineState) -> Gaussians:
    """Back to the stream representation."""
    return state.gaussians
