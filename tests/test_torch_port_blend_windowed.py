"""Port windowed blend: the plain ``blend_raw_plain`` and
``blend_raw_bwd_plain`` against the JAX package's windowed kernels
(``blend_raw`` and its VJP, interpret mode) on identical windows, in
all three modes, at a window that truncates two tiles and at one that
truncates none; the kernels' plain versions, which go from the pair
features (``blend_raw_pairs_plain``, ``blend_raw_bwd_pairs_plain``),
against the JAX route through ``gather_tile_windows`` at both windows in
all modes; the autograd function over pair features against the plain
version over windows and the JAX VJP; and the windowed route against the
packed one in the port where nothing truncates, forward and backward.
Each (seed, window, mode) runs the JAX forward once for the file.

The six tiles of ``test_torch_port_blend.py`` have empty tiles,
unaligned segments over several 128-row chunks and a tile that ends
early. Tolerances are the packed tests': forward 2e-4 absolute off
threshold-flip pixels (the JAX kernel's bf16 split dots), backward 2e-5
of each lane's largest grad.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.ops.pallas_blend import blend_raw as jax_blend_raw
from igs_tpu.ops.pallas_blend import gather_tile_windows as jax_windows
from igs_tpu_torch.ops.blend import (
    blend_raw_packed_bwd_plain, blend_raw_packed_plain)
from igs_tpu_torch.ops.blend_windowed import (
    blend_raw, blend_raw_bwd, blend_raw_bwd_cuda, blend_raw_bwd_pairs_plain,
    blend_raw_bwd_plain, blend_raw_cuda, blend_raw_fwd, blend_raw_pairs_plain,
    blend_raw_plain, fold_tile_windows, gather_tile_windows)
from tests.test_torch_port_blend import GRID_X, GRID_Y, _case

torch.set_num_threads(2)

ATOL = 2e-4
REL = 2e-5
CHUNK = 128
SCALARS = jnp.asarray([GRID_X, 0, 0, 0, 0, 0, 0, 0], jnp.float32)
# 256 truncates the 300- and 400-pair tiles; 512 truncates none
WINDOWS = (256, 512)


def _inputs(seed, maxpt):
    feats_t, starts, counts, num_pairs = _case(seed)
    counts_w = np.minimum(counts, maxpt).astype(np.int32)
    return feats_t, starts, counts, counts_w, num_pairs


def _cot(seed, nt):
    rng = np.random.RandomState(seed + 10)
    cot = rng.normal(size=(nt, 256, 24)).astype(np.float32)
    cot[..., 16:] = 0.0  # n_contrib, the median slot and pad carry none
    return cot


def _jax_windows(feats_t, starts, maxpt):
    ids = jnp.arange(feats_t.shape[1], dtype=jnp.int32)
    return jax_windows(jnp.asarray(feats_t.T), ids, jnp.asarray(starts),
                       maxpt)


@functools.lru_cache(maxsize=None)
def _jax_raw(seed, maxpt, mode):
    """The JAX route's raw on ``_inputs(seed, maxpt)``: ``gather_tile_windows``
    → ``blend_raw`` in interpret mode."""
    feats_t, starts, _, counts_w, _ = _inputs(seed, maxpt)
    return np.asarray(jax_blend_raw(_jax_windows(feats_t, starts, maxpt),
                                    jnp.asarray(counts_w), SCALARS, GRID_X,
                                    GRID_Y, CHUNK, True, mode))


def _close_to_jax(got, want):
    """The forward tolerance: n_contrib flips on at most 2 pixels, ``ATOL``
    on every other pixel."""
    flips = got[..., 16] != want[..., 16]
    assert flips.sum() <= 2, f"{flips.sum()} n_contrib flips"
    np.testing.assert_allclose(got[~flips], want[~flips], atol=ATOL, rtol=0)


def _per_lane_close(got, want, what):
    got = got.reshape(-1, got.shape[-1])
    want = want.reshape(-1, want.shape[-1])
    scale = np.abs(want).max(axis=0, keepdims=True)
    err = np.abs(got - want)
    assert np.all(err <= REL * scale + 1e-6), (
        f"{what}: rel err {float((err / (scale + 1e-30)).max()):.3g}")


@pytest.mark.parametrize("maxpt", WINDOWS)
@pytest.mark.parametrize("mode", ["color", "color_depth", "full"])
def test_plain_windowed_matches_jax(mode, maxpt):
    feats_t, starts, counts, counts_w, _ = _inputs(0, maxpt)
    jwin = _jax_windows(feats_t, starts, maxpt)
    win = gather_tile_windows(torch.from_numpy(feats_t),
                              torch.from_numpy(starts), maxpt)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))

    want = _jax_raw(0, maxpt, mode)
    cw = torch.from_numpy(counts_w)
    got = blend_raw_plain(win, cw, GRID_X, GRID_Y, mode, CHUNK)
    assert got.shape == want.shape == (6, 256, 24)
    _close_to_jax(got.numpy(), want)
    # the saturating tile ended early, the empty ones stayed empty, and a
    # truncated tile never walked past its window
    assert (got[4, :, 16] < counts_w[4]).all()
    assert (got[1, :, 16] <= counts_w[1]).all()
    assert not got[[0, 3], :, :4].any()
    if mode != "full":
        assert (got[..., 17] == -1.0).all() and not got[..., 11:15].any()
    if mode == "color":
        assert not got[..., 4:11].any()

    cot = _cot(0, 6)
    _, vjp = jax.vjp(lambda w: jax_blend_raw(
        w, jnp.asarray(counts_w), SCALARS, GRID_X, GRID_Y, CHUNK, True,
        mode), jwin)
    (dwant,) = vjp(jnp.asarray(cot))
    dgot = blend_raw_bwd_plain(win, cw, GRID_X, GRID_Y, mode, got,
                               torch.from_numpy(cot), CHUNK).numpy()
    _per_lane_close(dgot, np.asarray(dwant), f"dwindows {mode}")
    # slots past each tile's count and the lanes the mode does not read
    # take no gradient
    rows = np.arange(maxpt)[None, :] >= counts_w[:, None]
    assert not dgot[rows].any()
    assert not dgot[..., {"color": 9, "color_depth": 21, "full": 24}[mode]:
                    ].any()


@pytest.mark.parametrize("maxpt", WINDOWS)
@pytest.mark.parametrize("mode", ["color", "color_depth", "full"])
def test_pairs_plain_forward_matches_jax(mode, maxpt):
    """The forward kernel's plain version, from the pair features at
    ``tile_start`` with ``counts`` rows a tile, against the JAX route:
    ``gather_tile_windows`` of ``max_per_tile`` rows → ``blend_raw``."""
    feats_t, starts, _, counts_w, _ = _inputs(0, maxpt)
    ft, st = torch.from_numpy(feats_t), torch.from_numpy(starts)
    cw = torch.from_numpy(counts_w)
    got = blend_raw_pairs_plain(ft, st, cw, GRID_X, GRID_Y, mode, CHUNK)
    want = _jax_raw(0, maxpt, mode)
    assert got.shape == want.shape == (6, 256, 24)
    _close_to_jax(got.numpy(), want)
    # the dispatcher sends CPU tensors to it
    assert torch.equal(blend_raw_fwd(ft, st, cw, GRID_X, GRID_Y, mode, CHUNK),
                       got)


@pytest.mark.parametrize("maxpt", WINDOWS)
@pytest.mark.parametrize("mode", ["color", "color_depth", "full"])
def test_autograd_forward_on_cpu_equals_plain_over_windows(mode, maxpt):
    """``blend_raw`` on CPU tensors, which gathers the tiles' largest count
    of rows, equals ``blend_raw_plain`` over the whole ``max_per_tile``
    windows bit for bit: no row past a tile's count is read."""
    feats_t, starts, _, counts_w, _ = _inputs(2, maxpt)
    ft, st = torch.from_numpy(feats_t), torch.from_numpy(starts)
    cw = torch.from_numpy(counts_w)
    got = blend_raw(ft, st, cw, GRID_X, GRID_Y, mode, CHUNK)
    want = blend_raw_plain(gather_tile_windows(ft, st, maxpt), cw, GRID_X,
                           GRID_Y, mode, CHUNK)
    assert torch.equal(got, want)


def _jax_pairs_vjp(feats_t, starts, counts_w, maxpt, mode, cot):
    """The JAX route's gradient of the pair features: ``jax.vjp`` of
    ``gather_tile_windows`` → ``blend_raw`` (interpret mode)."""
    def jfn(f):
        ids = jnp.arange(f.shape[0], dtype=jnp.int32)
        w = jax_windows(f, ids, jnp.asarray(starts), maxpt)
        return jax_blend_raw(w, jnp.asarray(counts_w), SCALARS, GRID_X,
                             GRID_Y, CHUNK, True, mode)

    _, vjp = jax.vjp(jfn, jnp.asarray(feats_t.T))
    (want,) = vjp(jnp.asarray(cot))
    return np.asarray(want).T


@pytest.mark.parametrize("maxpt", WINDOWS)
@pytest.mark.parametrize("mode", ["color", "color_depth", "full"])
def test_pairs_plain_backward_matches_jax_vjp(mode, maxpt):
    """The backward kernel's plain version, (32, pairs) grads of the pair
    features, against the JAX VJP through the window gather; pairs past a
    truncated window, padding and the lanes the mode does not read take
    zero."""
    feats_t, starts, counts, counts_w, num_pairs = _inputs(3, maxpt)
    cot = _cot(3, 6)
    want = _jax_pairs_vjp(feats_t, starts, counts_w, maxpt, mode, cot)
    ft, st = torch.from_numpy(feats_t), torch.from_numpy(starts)
    cw = torch.from_numpy(counts_w)
    win = gather_tile_windows(ft, st, maxpt)
    raw = blend_raw_plain(win, cw, GRID_X, GRID_Y, mode, CHUNK)
    got = blend_raw_bwd_pairs_plain(ft, st, cw, GRID_X, GRID_Y, mode, raw,
                                    torch.from_numpy(cot), CHUNK)
    assert got.shape == ft.shape
    got = got.numpy()
    _per_lane_close(got.T[:num_pairs], want[:, :num_pairs].T,
                    f"dfeats {mode}")
    lanes = {"color": 9, "color_depth": 21, "full": 24}[mode]
    assert not got[lanes:].any()
    live = np.zeros(feats_t.shape[1], bool)
    for s0, n in zip(starts, counts_w):
        live[s0:s0 + n] = True
    assert not got[:, ~live].any()
    if maxpt == 256:  # the 300- and 400-pair tiles truncate
        assert not live[starts[1] + maxpt:starts[1] + 300].any()
        assert not live[starts[4] + maxpt:starts[4] + 400].any()


def _narrow(wide):
    """The windowed 24-lane raw or cotangent → the packed color layout
    [C W logT n_contrib pad(2)]."""
    return torch.cat([wide[..., :4], wide[..., 15:17],
                      torch.zeros(wide.shape[:-1] + (2,))], -1)


def _widen(narrow):
    """The packed color layout → the windowed 24-lane one (geometry and
    the median lanes zero, med_pos -1)."""
    out = torch.zeros(narrow.shape[:-1] + (24,))
    out[..., :4] = narrow[..., :4]
    out[..., 15:17] = narrow[..., 4:6]
    out[..., 17] = -1.0
    return out


@pytest.mark.parametrize("raw_from", ["windowed", "packed"])
@pytest.mark.parametrize("mode", ["color", "color_depth", "full"])
def test_pairs_backward_matches_packed_where_nothing_truncates(mode,
                                                               raw_from):
    """Window 512, so ``counts`` = ``tile_count``: the windowed backward
    to the pair features equals the packed one bit for bit on the same
    pairs, with the raw block laid out both ways (in color mode the
    windowed route's 24 lanes and the packed 8), taken from either
    route's forward."""
    feats_t, starts, counts, counts_w, _ = _inputs(0, 512)
    ft, st = torch.from_numpy(feats_t), torch.from_numpy(starts)
    cw, cp = torch.from_numpy(counts_w), torch.from_numpy(counts)
    assert torch.equal(cw, cp)
    packed_ft = ft[:16] if mode == "color" else ft
    if raw_from == "windowed":
        raw_w = blend_raw_plain(gather_tile_windows(ft, st, 512), cw, GRID_X,
                                GRID_Y, mode)
        raw_p = _narrow(raw_w) if mode == "color" else raw_w
    else:
        raw_p = blend_raw_packed_plain(packed_ft, st, cp, GRID_X, GRID_Y,
                                       mode)
        raw_w = _widen(raw_p) if mode == "color" else raw_p
    cot_w = torch.from_numpy(_cot(4, 6))
    if mode == "color":
        cot_w[..., 4:15] = 0.0  # color mode reads no geometry cotangent
        cot_p = _narrow(cot_w)
    else:
        cot_p = cot_w
    got = blend_raw_bwd_pairs_plain(ft, st, cw, GRID_X, GRID_Y, mode, raw_w,
                                    cot_w)
    want = blend_raw_packed_bwd_plain(packed_ft, st, cp, GRID_X, GRID_Y,
                                      mode, raw_p, cot_p)
    lanes = want.shape[0]
    assert torch.equal(got[:lanes], want)
    assert not got[lanes:].any()


@pytest.mark.parametrize("mode", ["color", "full"])
def test_autograd_over_pair_features_matches_jax(mode):
    """``blend_raw`` (gather + blend + fold) against the JAX VJP through
    ``gather_tile_windows``, at the truncating window."""
    maxpt = 256
    feats_t, starts, _, counts_w, num_pairs = _inputs(1, maxpt)
    cot = _cot(1, 6)

    def jfn(f):
        ids = jnp.arange(f.shape[0], dtype=jnp.int32)
        w = jax_windows(f, ids, jnp.asarray(starts), maxpt)
        return jax_blend_raw(w, jnp.asarray(counts_w), SCALARS, GRID_X,
                             GRID_Y, CHUNK, True, mode)

    _, vjp = jax.vjp(jfn, jnp.asarray(feats_t.T))
    (want,) = vjp(jnp.asarray(cot))
    ft = torch.from_numpy(feats_t).requires_grad_(True)
    raw = blend_raw(ft, torch.from_numpy(starts), torch.from_numpy(counts_w),
                    GRID_X, GRID_Y, mode, CHUNK)
    (got,) = torch.autograd.grad(raw, ft, torch.from_numpy(cot))
    _per_lane_close(got.numpy().T[:num_pairs], np.asarray(want)[:num_pairs],
                    "dfeats")
    # pairs past a truncated tile's window take no gradient
    assert not got[:, starts[1] + maxpt:starts[1] + 300].any()
    assert not got[:, starts[4] + maxpt:starts[4] + 400].any()


@pytest.mark.parametrize("mode", ["color", "color_depth", "full"])
def test_windowed_matches_packed_where_nothing_truncates(mode):
    """Window 512: every tile fits, and the windowed walk reads the same
    pairs in the same chunks as the packed one."""
    feats_t, starts, counts, counts_w, _ = _inputs(0, 512)
    ft, st = torch.from_numpy(feats_t), torch.from_numpy(starts)
    win = gather_tile_windows(ft, st, 512)
    cw = torch.from_numpy(counts_w)
    raw_w = blend_raw_plain(win, cw, GRID_X, GRID_Y, mode)
    packed_ft = ft[:16] if mode == "color" else ft
    raw_p = blend_raw_packed_plain(packed_ft, st, torch.from_numpy(counts),
                                   GRID_X, GRID_Y, mode)
    if mode == "color":  # packed color layout: C W logT n_contrib
        pairs = ((slice(0, 4), slice(0, 4)), (slice(15, 17), slice(4, 6)))
    else:
        pairs = ((slice(0, 24), slice(0, 24)),)
    for lw, lp in pairs:
        assert torch.equal(raw_w[..., lw], raw_p[..., lp])

    cot = torch.from_numpy(_cot(2, 6))
    dwin = blend_raw_bwd_plain(win, cw, GRID_X, GRID_Y, mode, raw_w, cot)
    cot_p = cot if mode != "color" else torch.cat(
        [cot[..., :4], cot[..., 15:16], torch.zeros(6, 256, 3)], -1)
    dfeats_p = blend_raw_packed_bwd_plain(packed_ft, st,
                                          torch.from_numpy(counts), GRID_X,
                                          GRID_Y, mode, raw_p, cot_p)
    dfeats_w = fold_tile_windows(dwin, st, cw, ft.shape[1])
    lanes = dfeats_p.shape[0]
    torch.testing.assert_close(dfeats_w[:lanes], dfeats_p, rtol=0, atol=0)


def test_kernel_wrappers_reject_cpu_tensors_and_bad_shapes():
    feats_t, starts, _, counts_w, _ = _inputs(0, 256)
    ft, st = torch.from_numpy(feats_t), torch.from_numpy(starts)
    win = gather_tile_windows(ft, st, 256)
    cw = torch.from_numpy(counts_w)
    with pytest.raises(ValueError, match="CUDA"):
        blend_raw_cuda(ft, st, cw, GRID_X, GRID_Y, "full")
    with pytest.raises(ValueError, match="feats_t must be"):
        blend_raw_cuda(ft[:16], st, cw, GRID_X, GRID_Y, "color")
    with pytest.raises(TypeError, match="tile_count must be"):
        blend_raw_fwd(ft, st, cw.long(), GRID_X, GRID_Y, "full")
    with pytest.raises(ValueError, match="differ in shape"):
        blend_raw_fwd(ft, st[:3], cw, GRID_X, GRID_Y, "full")
    raw = torch.zeros((6, 256, 24))
    with pytest.raises(ValueError, match="CUDA"):
        blend_raw_bwd_cuda(ft, st, cw, GRID_X, GRID_Y, "full", raw, raw)
    with pytest.raises(ValueError, match="windows must be"):
        blend_raw_plain(win[..., :16], cw, GRID_X, GRID_Y, "full")
    with pytest.raises(TypeError, match="int32"):
        blend_raw_plain(win, cw.long(), GRID_X, GRID_Y, "full")
    with pytest.raises(ValueError, match="cot must be"):
        blend_raw_bwd(ft, st, cw, GRID_X, GRID_Y, "full", raw, raw[..., :8])
    with pytest.raises(ValueError, match="feats_t must be"):
        blend_raw_bwd(ft[:16], st, cw, GRID_X, GRID_Y, "color", raw, raw)
    with pytest.raises(TypeError, match="tile_count must be"):
        blend_raw_bwd(ft, st, cw.long(), GRID_X, GRID_Y, "full", raw, raw)
    with pytest.raises(ValueError, match="differ in shape"):
        blend_raw_bwd(ft, st[:3], cw, GRID_X, GRID_Y, "full", raw, raw)
