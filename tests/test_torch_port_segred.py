"""Port segmented reduction: the binning aux against the JAX package's
exactly, ``segmented_scan_plain`` against the JAX Pallas kernel in
interpret mode, and ``gather_pairs``' backward against the JAX VJP.

The scan is held to 1e-5 of each segment's magnitude (Σ|x| over the
segment): the JAX kernel's bf16 hi/lo split dots carry ~2^-17 relative
error (``igs_tpu/ops/segred.py:21-27``); the plain version sums in
float64. The gather's backward is held to the same bound per row.
"""

import pathlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.ops.binning import build_tile_pairs as jax_build_pairs
from igs_tpu.ops.projection import project as jax_project
from igs_tpu.ops.segred import gather_pairs as jax_gather_pairs
from igs_tpu.ops.segred import segmented_scan as jax_segmented_scan
from igs_tpu_torch.data.scan_ids import scan_edge_ids
from igs_tpu_torch.ops.binning import build_tile_pairs
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.segred import (
    gather_pairs, segmented_scan, segmented_scan_cuda, segmented_scan_plain)
from tests.test_torch_port_raster import H, W, _args, _scene

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]

REL = 1e-5


def _pairs(seed, budget):
    jg, tg, jcam, tcam = _scene(seed=seed)
    jp = jax_project(**_args(jg), camera=jcam, shs=jg.shs, valid=jg.valid)
    tp = project(tg.get_xyz, tg.get_scaling, tg.get_rotation,
                 tg.get_opacity, tcam, shs=tg.shs, valid=tg.valid)
    gx, gy = (W + 15) // 16, (H + 15) // 16
    want = jax_build_pairs(jp, gx, gy, budget, segred_aux=True)
    got = build_tile_pairs(tp, gx, gy, budget, segred_aux=True)
    return want, got


@pytest.mark.parametrize("budget", [1 << 14, 256])  # roomy and overflowing
def test_binning_aux_matches_exactly(budget):
    want, got = _pairs(seed=3, budget=budget)
    for name in ("exp_to_sorted", "exp_gauss_id", "gauss_last_row"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert bool(got.overflowed[0]) == (budget == 256)
    # without the flag the fields are empty
    _, tg, _, tcam = _scene(seed=3)
    tp = project(tg.get_xyz, tg.get_scaling, tg.get_rotation,
                 tg.get_opacity, tcam, shs=tg.shs, valid=tg.valid)
    plain = build_tile_pairs(tp, 4, 3, budget)
    assert plain.gauss_last_row.numel() == plain.exp_to_sorted.numel() == 0


def _segments(mp, seed):
    """ids of contiguous runs: short ones, runs over 256 rows and over the
    JAX kernel's 4096-row grid step, and a pad tail of -1."""
    rng = np.random.RandomState(seed)
    lengths = list(rng.geometric(0.2, size=200)) + [300, 5000]
    rng.shuffle(lengths)
    ids = np.concatenate([np.full(n, i, np.int32)
                          for i, n in enumerate(lengths)])[:mp - 77]
    return np.concatenate([ids, np.full(mp - ids.shape[0], -1, np.int32)])


def _seg_scale(x, ids):
    """Σ|x| over each element's segment, per lane: (L, MP)."""
    out = np.zeros_like(x, dtype=np.float64)
    for s in np.unique(ids):
        m = ids == s
        out[:, m] = np.abs(x[:, m]).sum(axis=1, keepdims=True)
    return out


@pytest.mark.parametrize("lanes", [16, 32])
def test_segmented_scan_plain_matches_jax(lanes):
    mp = 8192
    ids = _segments(mp, seed=lanes)
    rng = np.random.RandomState(7)
    x = rng.normal(0, 1, (lanes, mp)).astype(np.float32)
    x[:, ids < 0] = 0.0  # pad rows carry zero grads
    want = np.asarray(jax_segmented_scan(jnp.asarray(x.T.copy()),
                                         jnp.asarray(ids), interpret=True)).T
    got = segmented_scan(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    exact = segmented_scan_plain(torch.from_numpy(x).double().float(),
                                 torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, exact)
    scale = _seg_scale(x, ids)
    assert np.all(np.abs(got - want) <= REL * scale + 1e-30)
    # the last row of each run is the run's sum
    last = np.nonzero(np.append(ids[1:] != ids[:-1], True))[0]
    for e in last[:20]:
        run = ids == ids[e]
        np.testing.assert_allclose(got[:, e], x[:, run].sum(axis=1),
                                   rtol=1e-5, atol=1e-5)


EDGE_ROWS = 1 << 14


@pytest.mark.parametrize("lanes", [16, 32])
@pytest.mark.parametrize("case", ["long_run", "tile_edges", "singletons",
                                  "ragged", "leading_pad"])
def test_segmented_scan_plain_matches_jax_on_edge_ids(case, lanes):
    """The plain scan against the JAX kernel on the id patterns that
    chip_smoke.py holds the CUDA kernel to (``scan_edge_ids``, here at
    2^14 rows): a run over many rows, runs ending on 512-row edges,
    singletons only, a row count that is no multiple of 128, a leading pad
    run. The kernel's own tile and look-back edges are checked on the
    card; its look-back order by the emulation below."""
    ids = scan_edge_ids(lanes, EDGE_ROWS)[case]
    mp = ids.shape[0]
    rng = np.random.RandomState(lanes + mp)
    x = rng.normal(0, 1, (lanes, mp)).astype(np.float32)
    # the JAX kernel takes whole 128-row blocks: pad with a run of its own
    pad = -mp % 128
    jids = np.concatenate([ids, np.full(pad, ids.max() + 1, np.int32)])
    jx = np.concatenate([x, np.zeros((lanes, pad), np.float32)], axis=1)
    want = np.asarray(jax_segmented_scan(jnp.asarray(jx.T.copy()),
                                         jnp.asarray(jids),
                                         interpret=True)).T[:, :mp]
    got = segmented_scan(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    assert np.all(np.abs(got - want) <= REL * _seg_scale(x, ids) + 1e-30)


# The look-back protocol of igs_tpu_torch/csrc/segscan.cu, emulated tile
# by tile: statuses NONE / AGG / INCL, a window of the kernel's kWindow
# predecessors, and stops at whatever INCL a schedule has published.
NONE, AGG, INCL = 0, 1, 2
WINDOW = int(re.search(r"constexpr int kWindow = (\d+);",
                       (ROOT / "igs_tpu_torch/csrc/segscan.cu").read_text())[1])


def _lookback(seed, head, head0, aggs, oldest_first=True):
    """Run the tiles under one seeded schedule: up to ``resident`` tiles
    in flight, taken by ticket in order, each advanced one step at a time
    in random order; a status read may see any value the status has
    held. Returns ({tile: carry}, {tile: the INCL it stopped at}, whether
    some look-back found its whole window AGG and waited)."""
    rng = np.random.RandomState(seed)
    n = head.size
    status = np.zeros(n, np.int8)
    seen = [[NONE] for _ in range(n)]  # every status a tile has held
    agg, incl = np.zeros_like(aggs), np.zeros_like(aggs)  # as published
    carries, stops, window_full = {}, {}, False
    resident = rng.randint(2, 3 * WINDOW)
    stale = rng.choice([0.0, 0.3])
    step = {}  # tile -> 0 (to publish) or 1 (to look back)
    ticket = 0

    def publish(t, s):
        status[t] = s
        seen[t].append(s)

    while ticket < n or step:
        if ticket < n and (len(step) < resident and rng.rand() < 0.5
                           or not step):
            step[ticket] = 0
            ticket += 1
            continue
        b = list(step)[rng.randint(len(step))]
        if step[b] == 0:  # publish the aggregate, or the prefix at a head
            (incl if head[b] else agg)[b] = aggs[b]
            publish(b, INCL if head[b] else AGG)
            if head0[b]:
                del step[b]
            else:
                step[b] = 1
            continue
        # look back: the nearest INCL must have only AGGs after it
        near_incl = near_none = WINDOW
        for j in range(WINDOW):
            t = b - 1 - j
            st = INCL if t < 0 else (
                seen[t][rng.randint(len(seen[t]))] if rng.rand() < stale
                else status[t])
            if st == INCL:
                near_incl = j
                break
            if st == NONE:
                near_none = j
                break
        if near_incl >= near_none:
            window_full |= near_incl == near_none == WINDOW
            continue  # wait
        k = b - 1 - near_incl
        parts = [incl[k]] + [agg[t] for t in range(k + 1, b)]
        if not oldest_first:
            parts = parts[::-1]
        c = parts[0]
        for p in parts[1:]:
            c = c + p  # float32, one rounding per add
        carries[b], stops[b] = c, k
        if not head[b]:
            incl[b] = c + aggs[b]
            publish(b, INCL)
        del step[b]
    return carries, stops, window_full


def _lookback_tiles(n=700, lanes=4):
    """Head flags and aggregates of ``n`` tiles: tile 0 starts a run,
    headless stretches of up to 300 tiles (over two windows), heads
    inside a tile (a carry in, the prefix out at once) and at its first
    pair (no carry), aggregates over six decades so the order of the adds
    shows in the bits."""
    rng = np.random.RandomState(5)
    head = rng.rand(n) < 0.04
    head[150:450] = False
    head[0] = True
    head0 = head & (rng.rand(n) < 0.5)
    head0[0] = True
    aggs = (rng.normal(size=(n, lanes))
            * 10.0 ** rng.uniform(-3, 3, (n, lanes))).astype(np.float32)
    return head, head0, aggs


def _carry_chain(head, aggs, b):
    """The carry into tile b as the source defines it: the aggregate of
    the last tile with a head, then the headless tiles' aggregates added
    oldest first."""
    h = max(t for t in range(b) if head[t])
    c = aggs[h]
    for t in range(h + 1, b):
        c = c + aggs[t]
    return c


@pytest.mark.parametrize("oldest_first", [True, False])
def test_segscan_lookback_carries_are_bitwise_repeatable(oldest_first):
    """Whatever INCL a look-back stops at, adding the aggregates after it
    oldest first gives the chain's bits; summed in another order (newest
    first here) the carries depend on the stop points."""
    head, head0, aggs = _lookback_tiles()
    want = {b: _carry_chain(head, aggs, b)
            for b in range(head.size) if not head0[b]}
    runs = [_lookback(seed, head, head0, aggs, oldest_first)
            for seed in range(8)]
    # the schedules stop at different points, past the window too
    stop_sets = [{r[1][b] for r in runs} for b in want]
    assert max(len(s) for s in stop_sets) > 2
    assert any(r[2] for r in runs)
    same = all(np.array_equal(r[0][b], want[b]) for r in runs for b in want)
    assert same == oldest_first


def test_gather_pairs_backward_matches_jax_vjp():
    want_pairs, got_pairs = _pairs(seed=1, budget=1 << 14)
    n, lanes = 300, 16
    rng = np.random.RandomState(2)
    feats = rng.normal(size=(n, lanes)).astype(np.float32)
    cot = rng.normal(size=(want_pairs.gauss_id.shape[0], lanes)).astype(
        np.float32)
    fwd, vjp = jax.vjp(
        lambda f: jax_gather_pairs(
            f, want_pairs.gauss_id, want_pairs.exp_to_sorted,
            want_pairs.exp_gauss_id, want_pairs.gauss_last_row, True),
        jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(cot))
    rows = torch.from_numpy(feats.T.copy()).requires_grad_(True)
    p = got_pairs
    out = gather_pairs(rows, p.gauss_id, p.exp_to_sorted, p.exp_gauss_id,
                       p.gauss_last_row)
    np.testing.assert_array_equal(out.detach().numpy().T, np.asarray(fwd))
    (got,) = torch.autograd.grad(out, rows, torch.from_numpy(cot.T.copy()))
    # the scatter-add of index_select is a third witness
    rows2 = rows.detach().clone().requires_grad_(True)
    out2 = torch.index_select(rows2, 1, p.gauss_id.clamp_min(0).long())
    live = (p.gauss_id >= 0).float()
    (scat,) = torch.autograd.grad(out2, rows2,
                                  torch.from_numpy(cot.T.copy()) * live)
    scale = np.abs(scat.numpy()).max(axis=1, keepdims=True) + 1.0
    assert np.all(np.abs(got.numpy() - np.asarray(want).T)
                  <= 1e2 * REL * scale)
    np.testing.assert_allclose(got.numpy(), scat.numpy(), rtol=0,
                               atol=float(1e2 * REL * scale.max()))


def test_kernel_wrapper_rejects_cpu_tensors():
    x = torch.zeros((16, 256))
    ids = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        segmented_scan_cuda(x, ids)
    with pytest.raises(TypeError, match="int32"):
        segmented_scan(x, ids.long())
    with pytest.raises(ValueError, match="ids for"):
        segmented_scan(x, ids[:128])
