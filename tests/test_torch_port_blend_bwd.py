"""Port blend backward: ``blend_raw_packed_bwd_plain`` against ``jax.vjp``
of the JAX packed kernel in interpret mode and against torch autograd
through the plain forward, in all three modes.

The six-tile case of ``test_torch_port_blend.py`` has empty tiles,
unaligned segments over several 128-pair chunks and a tile that ends
early. Per-pair grads are held per lane to 2e-5 of the lane's largest
magnitude: the JAX kernel's bf16 split dots and T recovery carry ~4e-6
there, torch autograd ~1e-6. Columns past the live pairs are the JAX
kernel's scratch (its "dump block") and are not compared; the port's
come back zero.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.ops.pallas_blend import blend_raw_packed as jax_blend
from igs_tpu_torch.ops.blend import (
    blend_raw_packed, blend_raw_packed_bwd, blend_raw_packed_bwd_cuda,
    blend_raw_packed_bwd_plain, blend_raw_packed_plain, candidate_box,
    tile_pixels)
from tests.test_torch_port_blend import GRID_X, GRID_Y, _candidates, _case

torch.set_num_threads(2)

REL = 2e-5


def _inputs(seed, mode):
    feats_t, starts, counts, num_pairs = _case(seed)
    if mode == "color":
        feats_t = feats_t[:16]
    rng = np.random.RandomState(seed + 10)
    nl = 8 if mode == "color" else 24
    cot = rng.normal(size=(GRID_X * GRID_Y, 256, nl)).astype(np.float32)
    # n_contrib and the median slot are not differentiable
    cot[..., [5] if mode == "color" else [16, 17]] = 0.0
    return feats_t, starts, counts, num_pairs, cot


def _per_lane_close(got, want, what):
    scale = np.abs(want).max(axis=1, keepdims=True)
    err = np.abs(got - want)
    assert np.all(err <= REL * scale + 1e-6), (
        f"{what}: worst lane {int(np.argmax((err / (scale + 1e-30)).max(1)))}"
        f" rel err {float((err / (scale + 1e-30)).max()):.3g}")


@pytest.mark.parametrize("mode", ["color", "color_depth", "full"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_backward_matches_jax_vjp_and_autograd(mode, seed):
    feats_t, starts, counts, num_pairs, cot = _inputs(seed, mode)
    scalars = jnp.asarray([GRID_X, num_pairs, 0, 0, 0, 0, 0, 0], jnp.float32)
    _, vjp = jax.vjp(
        lambda f: jax_blend(f, jnp.asarray(counts), jnp.asarray(starts),
                            scalars, GRID_X, GRID_Y, True, mode),
        jnp.asarray(feats_t))
    (want,) = vjp(jnp.asarray(cot))
    want = np.asarray(want)

    ft, st, ct = (torch.from_numpy(a) for a in (feats_t, starts, counts))
    raw = blend_raw_packed_plain(ft, st, ct, GRID_X, GRID_Y, mode)
    got = blend_raw_packed_bwd_plain(ft, st, ct, GRID_X, GRID_Y, mode, raw,
                                     torch.from_numpy(cot)).numpy()
    assert got.shape == feats_t.shape
    _per_lane_close(got[:, :num_pairs], want[:, :num_pairs], "vs jax")

    # third witness: autograd through the plain forward's arithmetic
    ftr = ft.clone().requires_grad_(True)
    raw2 = blend_raw_packed_plain(ftr, st, ct, GRID_X, GRID_Y, mode)
    (auto,) = torch.autograd.grad(raw2, ftr, torch.from_numpy(cot))
    _per_lane_close(got, auto.numpy(), "vs autograd")

    # only the read lanes of live pairs carry grads
    lanes = {"color": 9, "color_depth": 21, "full": 24}[mode]
    assert not got[lanes:].any()
    assert not got[:, :starts[1]].any() and not got[:, num_pairs:].any()


def test_autograd_function_runs_the_analytic_backward():
    feats_t, starts, counts, _, cot = _inputs(0, "color")
    ft, st, ct = (torch.from_numpy(a) for a in (feats_t, starts, counts))
    ftr = ft.clone().requires_grad_(True)
    raw = blend_raw_packed(ftr, st, ct, GRID_X, GRID_Y, "color")
    (got,) = torch.autograd.grad(raw, ftr, torch.from_numpy(cot))
    want = blend_raw_packed_bwd(ft, st, ct, GRID_X, GRID_Y, "color",
                                raw.detach(), torch.from_numpy(cot))
    assert torch.equal(got, want)
    assert torch.equal(raw.detach(), blend_raw_packed_plain(
        ft, st, ct, GRID_X, GRID_Y, "color"))


def test_backward_wrapper_checks():
    feats_t, starts, counts, _, cot = _inputs(0, "full")
    ft, st, ct = (torch.from_numpy(a) for a in (feats_t, starts, counts))
    raw = torch.zeros((GRID_X * GRID_Y, 256, 24))
    with pytest.raises(ValueError, match="CUDA"):
        blend_raw_packed_bwd_cuda(ft, st, ct, GRID_X, GRID_Y, "full", raw,
                                  torch.from_numpy(cot))
    with pytest.raises(ValueError, match="cot must be"):
        blend_raw_packed_bwd(ft, st, ct, GRID_X, GRID_Y, "full", raw,
                             torch.from_numpy(cot[..., :8]))


@pytest.mark.parametrize("seed", [0, 1])
def test_every_pixel_pair_the_backward_takes_lies_in_the_pairs_box(seed):
    """The backward kernel skips, per warp, the pairs whose candidate box
    (blend_common.cuh) misses the warp's pixels. On the six-tile case every
    pixel-pair the backward takes (candidate and before the pixel's
    n_contrib, from the plain forward) lies in its pair's box."""
    feats_t, starts, counts, _, _ = _inputs(seed, "full")
    ft = torch.from_numpy(feats_t)
    st, ct = torch.from_numpy(starts), torch.from_numpy(counts)
    nc = blend_raw_packed_plain(ft, st, ct, GRID_X, GRID_Y, "full")[..., 16]
    tiles = torch.arange(GRID_X * GRID_Y)
    px, py = tile_pixels(tiles, GRID_X, GRID_X * GRID_Y)
    taken = 0
    for t in tiles[ct > 0].tolist():
        cols = starts[t] + torch.arange(int(ct[t]))
        f = ft[:6, cols]
        take = _candidates(f, px[t], py[t]) & (
            torch.arange(1, cols.numel() + 1)[:, None] <= nc[t][None, :])
        box = candidate_box(f)
        inside = ((px[t][None] >= box[:, 0:1]) & (px[t][None] <= box[:, 1:2])
                  & (py[t][None] >= box[:, 2:3])
                  & (py[t][None] <= box[:, 3:4]))
        assert not (take & ~inside).any()
        taken += int(take.sum())
    assert taken > 1000
