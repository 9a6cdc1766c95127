"""The refine's graphed route (``stream/refine.refine_run_graphed``) and the
sync-free pair expansion it rests on (``ops/binning.expand_pairs``).

* ``expand_pairs`` and ``build_tile_pairs`` against the
  ``repeat_interleave`` construction they replaced (kept here as the
  oracle), field for field: one view, several views, a view over its pair
  budget, a view with no visible Gaussian, the segmented-reduction aux on
  and off.
* The static-buffer step on the CPU (uncaptured there) against the eager
  ``refine_step`` loop over 50 steps with both densifies: losses, leaves
  and Adam's moments bit-equal; what ``on_step`` received unchanged after
  the run; the returned state sharing no storage with the step's buffers.
* On a card (the ``card`` marker; skipped without one): the graphed
  ``refine_run`` bit-equal to the eager loop, the blends' pair counters
  equal under a profiler and one capture across two refines, the
  kernels' launch tallies equal to ``refine_run_eager``'s. This file
  imports no JAX, so on the card it runs alone:
  ``python -m pytest --noconftest -p no:cacheprovider
  tests/test_torch_port_refine_graph.py -m card``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.ops import binning
from igs_tpu_torch.ops.binning import build_tile_pairs, expand_pairs
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.rasterize import (
    RasterSettings, build_pairs_packed, rasterize)
from igs_tpu_torch.stream import refine as R
from igs_tpu_torch.utils import profiling

HW = 48
BG = (0.1, 0.2, 0.3)
SETTINGS = RasterSettings(image_height=HW, image_width=HW, outputs="color",
                          max_pairs=1 << 12)
# a threshold at which both densifies (steps 20, 40) split rows, the
# second up to the capacity
CFG = R.RefineConfig(densify_grad_threshold=2e-3)
ITERS = 50


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)


def _w2c(yaw, radius=4.0):
    c, s = np.cos(yaw), np.sin(yaw)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    w2c[2, 3] = radius
    return w2c


def _gaussians(n, capacity, device, seed=4):
    rng = np.random.RandomState(seed)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1.5, 1.5, (n, 3))
    shs[:, 1:] = 0.12 * rng.normal(size=(n, 15, 3))
    g = Gaussians.create(
        rng.uniform(-1, 1, (n, 3)), rng.uniform(-1, 3, (n, 1)),
        rot / np.linalg.norm(rot, axis=1, keepdims=True),
        rng.uniform(-3.2, -1.8, (n, 3)), shs, device=device)
    return g.pad_to(capacity)


def _cameras(device, views=((-0.25, 4.0), (0.0, 4.0), (0.3, 4.0))):
    return Camera.stack([Camera.from_w2c(_w2c(y, r), 0.8, 0.8, HW, HW,
                                         device=device) for y, r in views])


def _scene(device, n=200, capacity=400):
    """Gaussians at capacity, three views, and ground truth rendered from a
    moved copy of the Gaussians."""
    g = _gaussians(n, capacity, device)
    cams = _cameras(device)
    rng = np.random.RandomState(5)
    shift = torch.from_numpy(rng.normal(0, 0.03, (capacity, 3)).astype(
        np.float32)).to(device)
    bg = torch.tensor(BG, device=device)
    gts = torch.stack([torch.clamp(rasterize(
        g.get_xyz + shift, g.get_opacity, g.get_scaling, g.get_rotation,
        cams.view(i), shs=g.shs, bg=bg, valid=g.valid,
        settings=SETTINGS)["color"], 0, 1) for i in range(3)])
    return g, cams, gts, bg


# ---------------------------------------------------------------------------
# the pair expansion
# ---------------------------------------------------------------------------


def _expand_oracle(order, rect_min, rect_max, tt, grid_x, num_tiles,
                   max_pairs):
    """The expansion as it was built before: ``repeat_interleave`` at the
    data's size (a host sync), then a scatter into the budget's slots."""
    nv, n = order.shape
    offsets = torch.cumsum(tt, dim=1)
    base = offsets - tt
    kept = torch.clamp(torch.minimum(tt, max_pairs - base), min=0).reshape(-1)
    rows = torch.repeat_interleave(torch.arange(nv * n), kept)
    row_start = torch.cumsum(kept, 0) - kept
    local = torch.arange(rows.shape[0]) - row_start[rows]
    view = rows // n
    x0 = rect_min[..., 0].reshape(-1)[rows].to(torch.int64)
    y0 = rect_min[..., 1].reshape(-1)[rows].to(torch.int64)
    rw = torch.clamp(rect_max[..., 0] - rect_min[..., 0], min=1).reshape(-1)[
        rows].to(torch.int64)
    q = torch.div(local, rw, rounding_mode="floor")
    tile = view * num_tiles + (y0 + q) * grid_x + x0 + (local - q * rw)
    slot = view * max_pairs + base.reshape(-1)[rows] + local
    tile_full = torch.full((nv * max_pairs,), nv * num_tiles,
                           dtype=torch.int32)
    tile_full[slot] = tile.to(torch.int32)
    gauss_full = torch.full((nv * max_pairs,), -1, dtype=torch.int32)
    gauss_full[slot] = (view * n + order.reshape(-1)[rows]).to(torch.int32)
    return tile_full, gauss_full, offsets, kept


# (views as (yaw, radius), pair budget): radius 4 sees the scene, radius
# -4 puts every Gaussian behind the camera (no visible one), radius 2
# fills more tiles than the others
CASES = {
    "one_view": (((0.0, 4.0),), 1 << 12),
    "three_views": (((-0.25, 4.0), (0.0, 4.0), (0.3, 4.0)), 1 << 12),
    "view_overflows": (((0.0, 4.0), (0.1, 2.0)), None),
    "view_all_invisible": (((0.0, 4.0), (0.0, -4.0), (0.2, 4.0)), 1 << 12),
}


def _projection(views):
    g = _gaussians(150, 160, "cpu")
    return project(g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                   _cameras("cpu", views), colors_precomp=torch.zeros_like(
                       g.xyz), valid=g.valid, geometry=False)


@pytest.mark.parametrize("segred_aux", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expansion_equals_the_repeat_interleave_oracle(case, segred_aux,
                                                       monkeypatch):
    views, budget = CASES[case]
    proj = _projection(views)
    gx, gy = binning.image_tile_grid(HW, HW)
    order, rmin, rmax, tt = binning.depth_order(proj)
    totals = tt.sum(1)
    if budget is None:  # between the two views' pair counts
        budget = int((totals.min() + totals.max()) // 2)
    if case == "view_overflows":
        assert int(totals.min()) <= budget < int(totals.max())
    if case == "view_all_invisible":
        assert int(totals[1]) == 0
    got = expand_pairs(order, rmin, rmax, tt, gx, gx * gy, budget)
    want = _expand_oracle(order, rmin, rmax, tt, gx, gx * gy, budget)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)

    pairs = build_tile_pairs(proj, gx, gy, budget, segred_aux=segred_aux)
    monkeypatch.setattr(binning, "expand_pairs", _expand_oracle)
    oracle = build_tile_pairs(proj, gx, gy, budget, segred_aux=segred_aux)
    for name, a, b in zip(pairs._fields, pairs, oracle):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert bool(pairs.overflowed.any()) == (case == "view_overflows")


# ---------------------------------------------------------------------------
# the static-buffer step against the eager loop
# ---------------------------------------------------------------------------


def _eager(state, cams, gts, bg, on_step=None):
    """Today's eager ``refine_step`` loop, written out."""
    for it, v in enumerate(R.view_order(ITERS, gts.shape[0])):
        state, metrics = R.refine_step(state, cams.view(v), gts[v], bg, CFG,
                                       SETTINGS)
        if R._densify_now(CFG, it):
            state = R.densify_and_prune(state, CFG, 2.0)
        if on_step is not None:
            on_step(it, state, metrics)
    return state


def _graphed(state, cams, gts, bg, on_step=None):
    return R.refine_run_graphed(
        state, cams, gts, R.view_order(ITERS, gts.shape[0]), bg, CFG,
        SETTINGS, 2.0, ITERS, on_step=on_step)


def _leaves(st):
    g = st.gaussians
    out = {k: getattr(g, k) for k in R.TRAINABLE + ("valid",)}
    out.update({f"m.{k}": v for k, v in st.adam_m.items()})
    out.update({f"v.{k}": v for k, v in st.adam_v.items()})
    out.update(max_radii2d=st.max_radii2d, denom=st.denom,
               accum=st.xyz_grad_accum, overflow=st.overflow,
               init_valid=st.init_valid)
    return out


def _storages(st):
    return {t.untyped_storage().data_ptr() for t in R._tensors(st)
            if t is not None}


def _run_both(device):
    g, cams, gts, bg = _scene(device)
    runs = {}
    for name, fn in (("eager", _eager), ("graphed", _graphed)):
        seen = []
        state0 = R.init_refine_state(g, capacity=g.num_capacity)
        out = fn(state0, cams, gts, bg,
                 on_step=lambda it, st, m: seen.append((it, st, m)))
        runs[name] = (state0, out, seen)
    return runs


def _assert_same_runs(runs):
    """Every step of the two runs of ``_run_both`` bit-equal, both
    densifies splitting rows; the graphed run returns its last step's
    state, with the first state's generator."""
    (_, eager, e_seen), (state0, graphed, g_seen) = (runs["eager"],
                                                     runs["graphed"])
    assert len(e_seen) == len(g_seen) == ITERS
    # both densifies split rows
    n0 = int(state0.gaussians.valid.sum())
    for it in (20, 40):
        assert int(g_seen[it][1].gaussians.valid.sum()) > int(
            g_seen[it - 1][1].gaussians.valid.sum()) >= n0, it
    for (it, est, em), (_, gst, gm) in zip(e_seen, g_seen):
        assert torch.equal(em["loss"], gm["loss"]), it
        assert torch.equal(em["psnr"], gm["psnr"]), it
        assert gst.step == est.step == it + 1
        for k, a in _leaves(est).items():
            assert torch.equal(a, _leaves(gst)[k]), (it, k)
    assert graphed is g_seen[-1][1]
    assert graphed.generator is state0.generator


def test_graphed_step_equals_the_eager_loop_on_the_cpu():
    R._graphs.clear()
    _assert_same_runs(_run_both("cpu"))


def test_what_on_step_received_stays_after_the_run():
    R._graphs.clear()
    g, cams, gts, bg = _scene("cpu")
    kept = []

    def on_step(it, st, m):
        # the state and metrics as given, and copies taken at the time
        kept.append((st, m, {k: v.clone() for k, v in _leaves(st).items()},
                     m["loss"].clone()))

    state0 = R.init_refine_state(g, capacity=g.num_capacity)
    before0 = {k: v.clone() for k, v in _leaves(state0).items()}
    out = _graphed(state0, cams, gts, bg, on_step)
    static = R._graphs[torch.device("cpu")].state
    # a second refine replays the same buffers
    _graphed(R.init_refine_state(g, capacity=g.num_capacity), cams, gts, bg)
    for st, m, copies, loss in kept:
        assert torch.equal(m["loss"], loss)
        for k, v in _leaves(st).items():
            assert torch.equal(v, copies[k]), k
        assert not _storages(st) & _storages(static)
    for k, v in _leaves(state0).items():
        assert torch.equal(v, before0[k]), k
    assert not _storages(out) & _storages(static)
    assert not _storages(out) & _storages(state0)


def test_refine_run_keeps_the_eager_route_on_the_cpu():
    """``refine_run`` on CPU tensors is the eager loop, step for step; the
    graphed route there would count its steps as eager too, so the route
    is told by the static step it leaves behind."""
    R._graphs.clear()
    g, cams, gts, bg = _scene("cpu")
    seen = []
    R.refine_run(R.init_refine_state(g, capacity=g.num_capacity), cams, gts,
                 R.view_order(3, 3), bg, CFG, SETTINGS, 2.0, 3,
                 on_step=lambda it, st, m: seen.append(m["loss"]))
    assert len(seen) == 3 and not R._graphs


def test_deferred_counts_are_kept_not_added():
    """Counts and launch tallies made inside ``deferred_counts`` are kept
    as taps, and each run of the taps makes them once (a replay's)."""
    t = torch.tensor([3, 4], dtype=torch.int32)

    def kernel():
        pass

    kernel.launches, kernel.launches_by_mode = 0, {"color": 0, "full": 0}
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.deferred_counts() as kept:
            profiling.count("x.pairs", t)
            profiling.count("x.n", 2)
            profiling.launched(kernel, "color")
            profiling.launched(kernel)
        assert profiling.counters() == {} and kernel.launches == 0
        for _ in range(2):
            for tap in kept:
                tap()
        assert profiling.counters() == {"x.pairs": 14, "x.n": 4}
    assert kernel.launches == 4
    assert kernel.launches_by_mode == {"color": 2, "full": 0}
    profiling.launched(kernel, "full")  # outside: made at once
    assert kernel.launches == 5 and kernel.launches_by_mode["full"] == 1
    profiling.reset_counters()


@pytest.mark.parametrize("counts, share", [
    ({"refine.graph_replays": 300}, 100.0),
    ({"refine.graph_replays": 98, "refine.eager_steps": 2}, 98.0),
    ({"refine.eager_steps": 50}, 0.0),
    ({}, None),
])
def test_graph_share_reader(counts, share, monkeypatch):
    """The benchmark's ``refine_graph_share.stream`` reads the program's
    step counters, and nothing where the program counts none."""
    from igs_bench import run as bench_run, spans

    monkeypatch.setattr(spans, "program_counters", lambda: dict(counts))
    got = bench_run.load_metric("refine_graph_share.stream").read({})
    assert got == share


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.card
def test_graphed_refine_matches_eager_on_the_card(card):
    """The graphed ``refine_run`` (captured and replayed) against the
    eager ``refine_step`` loop over 50 steps with both densifies: every
    step's loss and PSNR, and the state after it (leaves, Adam's moments,
    statistics), bit-equal. The eager step divides by Adam's bias
    corrections as Python floats, which PyTorch's CUDA division turns
    into a product with their float32 reciprocals; the graph multiplies
    by the same reciprocals, read from its device table."""
    R._graphs.clear()
    _assert_same_runs(_run_both(card))
    assert R._graphs[card].graph is not None


@pytest.mark.card
def test_graphed_refine_counts_every_blend_on_the_card(card):
    """Under a profiler two graphed refines capture one graph, replay the
    rest, and count every step's blended pairs forward and backward: the
    pairs of each step's state binned on its own."""
    R._graphs.clear()
    g, cams, gts, bg = _scene(card)
    order = R.view_order(ITERS, 3)
    runs = []
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(2):
            states = [R.init_refine_state(g, capacity=g.num_capacity)]
            R.refine_run(states[0], cams, gts, order, bg, CFG, SETTINGS,
                         2.0, ITERS,
                         on_step=lambda it, st, m: states.append(st))
            runs.append(states)
        torch.cuda.synchronize(card)
    got = profiling.counters()
    profiling.reset_counters()
    want = 0
    for states in runs:
        for st, v in zip(states, order):
            gs = st.gaussians
            want += int(build_pairs_packed(
                gs.get_xyz, gs.get_opacity, gs.get_scaling, gs.get_rotation,
                cams.view(v), valid=gs.valid,
                settings=SETTINGS).tile_count.sum())
    assert got["raster.pairs_blended.fwd"] == want
    assert got["raster.pairs_blended.bwd"] == want
    assert got["refine.graph_captures"] == 1
    assert got["refine.eager_steps"] == R.WARMUP_STEPS
    assert got["refine.graph_replays"] == 2 * ITERS - R.WARMUP_STEPS


@pytest.mark.card
def test_graphed_refine_counts_every_launch_on_the_card(card):
    """Two graphed refines (the first captures its step, the second
    replays every step) tally the launches of the packed blends and the
    scan that two eager refines make: each replay tallies what its
    capture launched, and the capture itself launches nothing."""
    from igs_tpu_torch.ops import blend, segred

    R._graphs.clear()
    g, cams, gts, bg = _scene(card)
    order = R.view_order(ITERS, 3)
    fns = (blend.blend_raw_packed_cuda, blend.blend_raw_packed_bwd_cuda,
           segred.segmented_scan_cuda)

    def launches(run):
        before = [(fn.launches, dict(getattr(fn, "launches_by_mode", {})))
                  for fn in fns]
        for _ in range(2):
            run(R.init_refine_state(g, capacity=g.num_capacity), cams, gts,
                order, bg, CFG, SETTINGS, 2.0, ITERS)
        torch.cuda.synchronize(card)
        return [(fn.launches - n,
                 {m: fn.launches_by_mode[m] - k for m, k in by.items()})
                for fn, (n, by) in zip(fns, before)]

    graphed = launches(R.refine_run)
    assert R._graphs[card].graph is not None
    eager = launches(R.refine_run_eager)
    assert graphed == eager
    assert all(n >= 2 * ITERS for n, _ in eager), eager


@pytest.mark.card
@pytest.mark.parametrize("impl", ["tiles", "pallas", "reference"])
def test_refine_run_keeps_other_raster_routes_eager_on_the_card(card, impl):
    """On a card, a raster route other than the packed one (whose step
    reads pair counts back to the host, or may) runs the eager loop: no
    graphed step is made, and the losses are the eager loop's (to float
    rounding: the oracle routes' backwards may add in any order)."""
    R._graphs.clear()
    g, cams, gts, bg = _scene(card)
    settings = SETTINGS._replace(impl=impl, max_per_tile=256)
    order = R.view_order(3, 3)
    losses = {}
    for name, run in (("route", R.refine_run), ("eager", R.refine_run_eager)):
        seen = []
        run(R.init_refine_state(g, capacity=g.num_capacity), cams, gts,
            order, bg, CFG, settings, 2.0, 3,
            on_step=lambda it, st, m: seen.append(float(m["loss"])))
        losses[name] = seen
    assert not R._graphs
    assert len(losses["route"]) == 3
    np.testing.assert_allclose(losses["route"], losses["eager"], rtol=1e-5)
