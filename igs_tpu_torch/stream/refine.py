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
    staler than that many Adam steps: on CUDA tensors with
    ``rebin_every`` 1 and the packed raster route it takes
    ``refine_run_graphed``, whose step is captured once as a CUDA graph
    and replayed (the host then makes one launch a step, not hundreds),
    elsewhere ``refine_run_eager``;
  * ``refine_run_sharded``: the same loop with each render and its
    backward split by tile-row strips over a mesh axis of ranks.

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

from igs_tpu_torch.core.camera import _PER_VIEW, Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.core.quaternion import quat_to_rotmat
from igs_tpu_torch.ops.projection import TILE_Y
from igs_tpu_torch.ops.rasterize import (
    RasterSettings, build_pairs_packed, rasterize)
from igs_tpu_torch.train.losses import l1_loss, ssim
from igs_tpu_torch.utils.profiling import count, deferred_counts, span

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
                   pairs_override=None, strip_row0: Optional[int] = None,
                   mesh=None, axis: str = "tile"):
    """(loss, grads by name, grad of the screen-space offset (N, 2), radii,
    mse, overflow code) of one render of ``camera``.

    Sharded (``mesh`` given): this rank renders the strip of
    ``settings.image_height`` rows from tile row ``strip_row0``; the
    axis's strips are gathered into the full image, this rank's own strip
    live in its slot, for the loss (the SSIM window crosses strips), so
    the backward reaches this strip's Gaussians only, with the true
    gradient. The parameter grads, the offset grads and the overflow are
    then summed over the axis (the same bits on every rank).
    """
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
            strip_row0=strip_row0, pairs_override=pairs_override)
        img = out["color"]
        if mesh is not None:
            strips = list(mesh.all_gather(img, axis).unbind(0))
            strips[mesh.index(axis)] = img
            img = torch.cat(strips, dim=-2)
        s, _ = ssim(img, gt_image)
        loss = (cfg.lambda_l1 * l1_loss(img, gt_image)
                + (1 - cfg.lambda_l1) * (1.0 - s))
        grads = torch.autograd.grad(
            loss, [params[k] for k in TRAINABLE] + [m2o])
    mse = torch.mean((img.detach() - gt_image) ** 2)
    grads, g_m2o, overflow = (dict(zip(TRAINABLE, grads[:-1])), grads[-1],
                              out["overflow_tiles"])
    if mesh is not None:
        grads = {k: mesh.sum(v, axis) for k, v in grads.items()}
        g_m2o = mesh.sum(g_m2o, axis)
        overflow = mesh.sum(overflow.to(torch.int32), axis)
    return loss.detach(), grads, g_m2o, out["radii"], mse, overflow


def bias_corrections(step: int, beta1: float, beta2: float):
    """Adam's 1 − β^t, evaluated in float32 as the JAX package does."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return tuple(float(1 - torch.tensor(b, dtype=torch.float32) ** t)
                 for b in (beta1, beta2))


def refine_step(state: RefineState, camera: Camera, gt_image: torch.Tensor,
                bg: torch.Tensor, cfg: RefineConfig, settings: RasterSettings,
                do_densify_stats: bool = True, pairs_override=None,
                strip_row0: Optional[int] = None, mesh=None,
                axis: str = "tile"
                ) -> Tuple[RefineState, Dict[str, torch.Tensor]]:
    """One optimisation iteration; returns the new state and {loss, psnr}
    as device tensors (no host sync). ``strip_row0``/``mesh``/``axis``:
    the sharded mode of ``loss_and_grads``; every rank of the axis then
    applies the same update."""
    return _step(state, camera, gt_image, bg, cfg, settings,
                 bias_corrections(state.step + 1, cfg.beta1, cfg.beta2),
                 do_densify_stats, pairs_override, strip_row0, mesh, axis)


def _step(state: RefineState, camera: Camera, gt_image: torch.Tensor,
          bg: torch.Tensor, cfg: RefineConfig, settings: RasterSettings, bc,
          do_densify_stats: bool = True, pairs_override=None,
          strip_row0: Optional[int] = None, mesh=None, axis: str = "tile"):
    """``refine_step`` with Adam's bias corrections ``bc`` given: the pair
    (1 − β1^t, 1 − β2^t) as floats, or the (4,) float32 device tensor that
    a graph reads (the pair, then its reciprocals; ``_unbias``)."""
    g = state.gaussians
    loss, grads, g_m2o, radii, mse, overflow = loss_and_grads(
        g, camera, gt_image, bg, cfg, settings, pairs_override, strip_row0,
        mesh, axis)

    # gradient gating: dead rows, frozen groups, optionally the static region
    gate = g.valid
    if cfg.use_mask and g.mask is not None:
        gate = gate & g.mask
    gatef = gate.float()

    step = state.step + 1
    new_params, new_m, new_v = {}, {}, {}
    for name in TRAINABLE:
        p = getattr(g, name)
        gname = gatef
        if name == "shs" and cfg.use_new_shs:
            gname = gatef * (~state.init_valid).float()
        gr = grads[name] * gname.reshape((-1,) + (1,) * (p.dim() - 1))
        m = cfg.beta1 * state.adam_m[name] + (1 - cfg.beta1) * gr
        v = cfg.beta2 * state.adam_v[name] + (1 - cfg.beta2) * gr * gr
        mhat = _unbias(m, bc, 0)
        vhat = _unbias(v, bc, 1)
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


def _unbias(x: torch.Tensor, bc, i: int) -> torch.Tensor:
    """``x`` over the ``i``-th bias correction of ``bc`` (``_step``'s),
    bit for bit as the eager step divides by a Python float: on CUDA that
    division is a product with the float32 reciprocal, which a device
    ``bc`` holds at ``2 + i``; on the CPU it is a division."""
    if isinstance(bc, torch.Tensor) and bc.is_cuda:
        return x * bc[2 + i]
    return x / bc[i]


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


# the state's tensors that a step reads or writes, in the order of
# ``_tensors``: the Gaussians' fields, Adam's moments, the statistics
_GAUSS_FIELDS = TRAINABLE + ("valid", "mask")
_STATS = ("max_radii2d", "xyz_grad_accum", "denom", "overflow", "init_valid")
# steps a new graph's first refine runs uncaptured on a side stream before
# the capture, so that lazy set-up (a library's first load, the cuDNN
# handle of autograd's thread) happens outside it
WARMUP_STEPS = 2


def _tensors(st: RefineState) -> list:
    g = st.gaussians
    return ([getattr(g, k) for k in _GAUSS_FIELDS]
            + [st.adam_m[k] for k in TRAINABLE]
            + [st.adam_v[k] for k in TRAINABLE]
            + [getattr(st, k) for k in _STATS])


def _with_tensors(st: RefineState, ts: list) -> RefineState:
    """``st`` with ``_tensors``' fields taken from ``ts``; the rest (the
    generator, the step, the Gaussians' residuals) kept."""
    ng, nt = len(_GAUSS_FIELDS), len(TRAINABLE)
    return replace(
        st, gaussians=replace(st.gaussians,
                              **dict(zip(_GAUSS_FIELDS, ts[:ng]))),
        adam_m=dict(zip(TRAINABLE, ts[ng:ng + nt])),
        adam_v=dict(zip(TRAINABLE, ts[ng + nt:ng + 2 * nt])),
        **dict(zip(_STATS, ts[ng + 2 * nt:])))


def _layout(ts: list) -> Tuple[list, int]:
    """Where each of ``ts``' tensors lies in one byte buffer that packs
    them all (each at a 256-byte boundary): (offset, shape, dtype) or
    None, and the buffer's size."""
    out, at = [], 0
    for t in ts:
        if t is None:
            out.append(None)
            continue
        out.append((at, t.shape, t.dtype))
        at += -(-t.numel() * t.element_size() // 256) * 256
    return out, at


def _carve(buf: torch.Tensor, layout: list) -> list:
    """The tensors of ``layout``, as views of the byte buffer ``buf``."""
    return [None if s is None else
            buf[s[0]:s[0] + s[1].numel() * s[2].itemsize].view(s[2]).view(
                s[1]) for s in layout]


def _copy_into(dst: list, src: list) -> None:
    for d, x in zip(dst, src):
        if d is not None and d is not x:
            d.copy_(x)


def _camera_rows(cameras: Camera) -> torch.Tensor:
    """(V, 37) float32: each view's per-view camera fields, flattened."""
    v = cameras.world_view_transform.shape[0]
    return torch.cat([getattr(cameras, f).reshape(v, -1)
                      for f in _PER_VIEW], 1)


def _camera_on(row: torch.Tensor, like: Camera) -> Camera:
    """The single camera ``like`` with its per-view fields views of
    ``row`` (one row of ``_camera_rows``)."""
    fields, at = {}, 0
    for f in _PER_VIEW:
        shape = getattr(like, f).shape
        k = shape.numel()
        fields[f] = row[at:at + k].view(shape)
        at += k
    return replace(like, **fields)


class _GraphedStep:
    """One refine step (render, loss, backward, gated Adam, densify
    statistics) on static buffers: the state at capacity (views of one
    byte buffer, so that a snapshot is one copy), one view's camera
    fields and ground truth, the background, Adam's bias corrections. On
    a CUDA device the step runs ``WARMUP_STEPS`` times uncaptured on a
    side stream, is then captured once as a CUDA graph, and every later
    step replays it; the inputs are filled by device-to-device copies
    before each step. On the CPU the same step runs uncaptured."""

    def __init__(self, key, state: RefineState, camera: Camera,
                 gt: torch.Tensor, bg: torch.Tensor, cfg: RefineConfig,
                 settings: RasterSettings):
        dev = gt.device
        self.key, self.cfg, self.settings = key, cfg, settings
        self.layout, size = _layout(_tensors(state))
        with torch.inference_mode(False):
            self.buf = torch.empty(size, dtype=torch.uint8, device=dev)
            self.state = _with_tensors(state, _carve(self.buf, self.layout))
            self.row = torch.empty(
                sum(getattr(camera, f).numel() for f in _PER_VIEW),
                dtype=torch.float32, device=dev)
            self.camera = _camera_on(self.row, camera)
            self.gt = torch.empty_like(gt)
            self.bg = torch.empty_like(bg)
            self.bc = torch.empty(4, dtype=torch.float32, device=dev)
        # row t - 1: the bias corrections of Adam step t, then their
        # reciprocals
        self.table = torch.empty((0, 4), dtype=torch.float32, device=dev)
        self.graph = self.out = self.side = None
        self.taps: list = []
        self.warm = 0

    def load(self, state: RefineState, bg: torch.Tensor, steps: int) -> None:
        """Copy ``state`` and ``bg`` in; bias corrections up to ``steps``."""
        _copy_into(_tensors(self.state), _tensors(state))
        self.bg.copy_(bg)
        if steps > self.table.shape[0]:
            # bias_corrections' own float32 arithmetic, and the reciprocal
            # that CUDA's division by a host float takes in float32 on the
            # host (IEEE), once a graph
            bcs = np.array([bias_corrections(t, self.cfg.beta1,
                                             self.cfg.beta2)
                            for t in range(1, steps + 1)], np.float32)
            self.table = torch.from_numpy(np.concatenate(
                [bcs, np.float32(1) / bcs], 1)).to(self.bc.device)

    def _body(self) -> Dict[str, torch.Tensor]:
        new, metrics = _step(self.state, self.camera, self.gt, self.bg,
                             self.cfg, self.settings, self.bc)
        _copy_into(_tensors(self.state), _tensors(new))
        return metrics

    def run(self, row: torch.Tensor, gt: torch.Tensor,
            t: int) -> Dict[str, torch.Tensor]:
        """Adam step ``t`` (1-based) on the view of camera row ``row``;
        returns {loss, psnr}, static buffers when replayed."""
        self.row.copy_(row)
        self.gt.copy_(gt)
        self.bc.copy_(self.table[t - 1])
        if not self.bc.is_cuda:
            count("refine.eager_steps", 1)
            return self._body()
        if self.graph is None and self.warm < WARMUP_STEPS:
            count("refine.eager_steps", 1)
            self.warm += 1
            return self._side(self._body)
        if self.graph is None:
            self.graph = torch.cuda.CUDAGraph()
            with deferred_counts() as taps, torch.cuda.graph(self.graph):
                self.out = self._body()
            self.taps = taps
            count("refine.graph_captures", 1)
        self.graph.replay()
        # what the capture counted, for this replay: the kernels' launches,
        # the blends' pair counts from the graph's own tile counts
        for tap in self.taps:
            tap()
        count("refine.graph_replays", 1)
        return self.out

    def _side(self, fn):
        cur = torch.cuda.current_stream(self.bc.device)
        if self.side is None:
            self.side = torch.cuda.Stream(self.bc.device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            out = fn()
        cur.wait_stream(self.side)
        return out

    def densify(self, base: RefineState, extent: float) -> None:
        """``densify_and_prune`` on the static state, eager, its result
        copied back (``base`` gives the generator)."""
        st = _with_tensors(base, _tensors(self.state))
        _copy_into(_tensors(self.state),
                   _tensors(densify_and_prune(st, self.cfg, extent)))

    def snapshot(self, base: RefineState, step: int) -> RefineState:
        """The static state as fresh tensors: views of one copy of the
        byte buffer (one device copy, no sync)."""
        return _with_tensors(replace(base, step=step),
                             _carve(self.buf.clone(), self.layout))


# the graphed step of each device, for the shapes of its key
_graphs: Dict[torch.device, _GraphedStep] = {}


def _graphed_step(state, camera, gt, bg, cfg, settings) -> _GraphedStep:
    """The device's graphed step, made anew (and captured anew) only when
    what the capture fixed changed: the state's shapes, the view's size,
    the refine and raster settings (``max_pairs`` among them), the
    backends' precision flags. The graph replays the kernels it captured:
    a caller that swaps a module's kernel function for another (a
    comparison with a plain version) runs ``refine_run_eager``."""
    key = (tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in _tensors(state)),
           camera.height, camera.width, camera.znear, camera.zfar,
           tuple(gt.shape), tuple(bg.shape), bg.dtype, cfg, settings,
           _backend_flags())
    dev = gt.device
    step = _graphs.get(dev)
    if step is None or step.key != key:
        _graphs.pop(dev, None)  # free the old graph's memory first
        step = _graphs[dev] = _GraphedStep(key, state, camera, gt, bg, cfg,
                                           settings)
    return step


def _backend_flags() -> tuple:
    """The precision and algorithm choices a capture fixes."""
    b = torch.backends
    return (torch.get_float32_matmul_precision(), b.cuda.matmul.allow_tf32,
            b.cudnn.allow_tf32, b.cudnn.benchmark, b.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled())


def refine_run_graphed(state: RefineState, cameras: Camera,
                       gt_images: torch.Tensor, view_order, bg: torch.Tensor,
                       cfg: RefineConfig, settings: RasterSettings,
                       extent: float, iters: int,
                       on_step: Optional[Callable[[int, RefineState, Dict],
                                                  None]] = None
                       ) -> RefineState:
    """``refine_run``'s loop on ``_GraphedStep``: the route ``refine_run``
    takes on CUDA tensors with ``rebin_every`` 1 and the packed raster
    route (on CPU tensors it runs
    the same static-buffer step uncaptured). The densify steps run eager
    between replays. What ``on_step`` receives and what is returned are
    snapshots (device copies), so later replays leave them as they are
    and the returned state shares no storage with the graph."""
    order = [int(v) for v in view_order][:iters]
    if not order:
        return state
    gs = _graphed_step(state, cameras.view(0), gt_images[0], bg, cfg,
                       settings)
    gs.load(state, bg, state.step + len(order))
    rows = _camera_rows(cameras)
    snap = None
    for it, v in enumerate(order):
        with span("refine.step"):
            metrics = gs.run(rows[v], gt_images[v], state.step + it + 1)
            if _densify_now(cfg, it):
                with span("refine.densify"):
                    gs.densify(state, extent)
        if on_step is not None:
            snap = gs.snapshot(state, state.step + it + 1)
            on_step(it, snap, {k: m.clone() for k, m in metrics.items()})
    if snap is None:
        snap = gs.snapshot(state, state.step + len(order))
    return snap


def refine_run(state: RefineState, cameras: Camera, gt_images: torch.Tensor,
               view_order, bg: torch.Tensor, cfg: RefineConfig,
               settings: RasterSettings, extent: float, iters: int,
               on_step: Optional[Callable[[int, RefineState, Dict], None]]
               = None) -> RefineState:
    """The key-frame refine loop over ``view_order`` (one view per step)
    with interval densify. ``cameras`` is a stack of the training views,
    ``gt_images`` (V, 3, H, W). ``on_step(it, state, metrics)`` is called
    after each step (and its densify), with device-tensor metrics.

    On CUDA tensors with ``cfg.rebin_every`` 1 and the packed raster route
    (``settings.impl`` "pallas_packed", the default: its step reads
    nothing back to the host) the steps replay one CUDA graph
    (``refine_run_graphed``); elsewhere they run eager
    (``refine_run_eager``): the oracle routes read counts back to the
    host (``"tiles"`` its pair lists), which no capture allows.
    """
    if (state.gaussians.xyz.is_cuda and cfg.rebin_every == 1
            and settings.impl == "pallas_packed"):
        return refine_run_graphed(state, cameras, gt_images, view_order, bg,
                                  cfg, settings, extent, iters, on_step)
    return refine_run_eager(state, cameras, gt_images, view_order, bg, cfg,
                            settings, extent, iters, on_step)


def refine_run_eager(state: RefineState, cameras: Camera,
                     gt_images: torch.Tensor, view_order, bg: torch.Tensor,
                     cfg: RefineConfig, settings: RasterSettings,
                     extent: float, iters: int,
                     on_step: Optional[Callable[[int, RefineState, Dict],
                                                None]] = None
                     ) -> RefineState:
    """``refine_run``'s loop with ``refine_step`` run eager: the route on
    CPU tensors, with ``cfg.rebin_every > 1`` and with a raster route
    other than the packed one. With ``rebin_every > 1``
    each view's pair list is built before the loop and rebuilt when it is
    ``rebin_every`` Adam steps old, or after a densify; the features are
    gathered from the current parameters every step, so only the tile
    assignment and per-tile depth order go stale."""
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
        count("refine.eager_steps", 1)
        with span("refine.step"):
            override = None
            if rebin:
                if it - built[v] >= cfg.rebin_every:
                    pairs[v], built[v] = build(v, state), it
                override = pairs[v]
            state, metrics = refine_step(state, cameras.view(v), gt_images[v],
                                         bg, cfg, settings,
                                         pairs_override=override)
            if _densify_now(cfg, it):
                with span("refine.densify"):
                    state = densify_and_prune(state, cfg, extent)
                # the Gaussian set changed: every cached list is invalid
                built = dict.fromkeys(built, -(cfg.rebin_every + 1))
        if on_step is not None:
            on_step(it, state, metrics)
    return state


def strip_settings(settings: RasterSettings, shards: int,
                   axis: str = "tile") -> RasterSettings:
    """The settings of one of ``shards`` tile-row strips of the image.
    Raises when the image's tile rows do not split evenly, or when its
    height is not a whole number of tiles a strip (the JAX package floors
    the tile rows and fails later at such heights, ROADMAP C30)."""
    grid_rows = settings.image_height // TILE_Y
    if grid_rows % shards:
        raise ValueError(
            f"image tile rows {grid_rows} not divisible by mesh axis "
            f"'{axis}' size {shards}")
    if settings.image_height % (TILE_Y * shards):
        raise ValueError(
            f"image height {settings.image_height} is not a multiple of "
            f"{TILE_Y}·{shards}: the strips of mesh axis '{axis}' would "
            f"drop its last {settings.image_height % TILE_Y} rows")
    return settings._replace(image_height=settings.image_height // shards)


def refine_run_sharded(state: RefineState, cameras: Camera,
                       gt_images: torch.Tensor, view_order, bg: torch.Tensor,
                       cfg: RefineConfig, settings: RasterSettings,
                       extent: float, iters: int, mesh, axis: str = "tile",
                       on_step: Optional[Callable[[int, RefineState, Dict],
                                                  None]] = None
                       ) -> RefineState:
    """``refine_run`` with each render and its backward split by tile-row
    strips over ``mesh``'s ``axis``: member d renders rows [d·H/n,
    (d+1)·H/n) of the full-image ``settings``/``gt_images``. The state
    stays replicated: every member applies the same summed update and the
    same densify (the same split draws from the same generator), so it
    needs no re-sync. As in the JAX package the sharded loop never rebins
    (``rebin_every`` has no effect, ROADMAP C32). Only members call it."""
    nsh = mesh.shape[axis]
    local = strip_settings(settings, nsh, axis)
    row0 = mesh.index(axis) * (local.image_height // TILE_Y)
    for it, v in enumerate([int(v) for v in view_order][:iters]):
        count("refine.eager_steps", 1)
        with span("refine.step"):
            state, metrics = refine_step(
                state, cameras.view(v), gt_images[v], bg, cfg, local,
                strip_row0=row0, mesh=mesh, axis=axis)
            if _densify_now(cfg, it):
                with span("refine.densify"):
                    state = densify_and_prune(state, cfg, extent)
        if on_step is not None:
            on_step(it, state, metrics)
    return state


def convert2stream(state: RefineState) -> Gaussians:
    """Back to the stream representation."""
    return state.gaussians
