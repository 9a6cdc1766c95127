"""Port blend: the plain PyTorch ``blend_raw_packed`` against the JAX
packed kernel in interpret mode, on identical packed features.

Tolerance 2e-4 absolute: the envelope of the JAX kernel's bf16 hi/lo
split dots (pallas_blend.py:50-58). ``n_contrib`` must be equal except
where a pixel sits on the termination threshold, where the two
summation orders may flip the decision; such flips are counted and
bounded.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.ops.pallas_blend import blend_raw_packed as jax_blend
from igs_tpu_torch.ops.blend import (
    MIN_ALPHA, blend_raw_packed, blend_raw_packed_cuda, candidate_box,
    tile_order)

torch.set_num_threads(2)

GRID_X, GRID_Y = 3, 2
ATOL = 2e-4


def _tile_features(rng, tile, n, opaque=False):
    """(n, 32) features of Gaussians centred in ``tile``."""
    tx, ty = tile % GRID_X, tile // GRID_X
    f = np.zeros((n, 32), np.float32)
    f[:, 0] = tx * 16 + rng.uniform(-4, 20, n)
    f[:, 1] = ty * 16 + rng.uniform(-4, 20, n)
    # conic of a random SPD 2×2 covariance
    s = rng.uniform(1.5, 6.0, (n, 2))
    th = rng.uniform(0, np.pi, n)
    c, si = np.cos(th), np.sin(th)
    a = c * c / s[:, 0] ** 2 + si * si / s[:, 1] ** 2
    b = c * si * (1 / s[:, 0] ** 2 - 1 / s[:, 1] ** 2)
    d = si * si / s[:, 0] ** 2 + c * c / s[:, 1] ** 2
    f[:, 2], f[:, 3], f[:, 4] = a, b, d
    f[:, 5] = rng.uniform(0.9, 1.0, n) if opaque else rng.uniform(0.05, 0.9, n)
    f[:, 6:9] = rng.uniform(0, 1, (n, 3))
    f[:, 9:12] = rng.normal(0, 1, (n, 3))  # vp
    f[:, 12] = rng.uniform(2, 6, n)  # t
    f[:, 13:21] = rng.normal(0, 0.05, (n, 8))  # cpx cpy rp
    nrm = rng.normal(0, 1, (n, 3))
    f[:, 21:24] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    return f


def _case(seed):
    """Six tiles: empty, a 300-pair segment spanning several 128-chunks
    at an unaligned start, a small one, empty, a saturating tile that
    terminates early, a medium one."""
    rng = np.random.RandomState(seed)
    counts = [0, 300, 5, 0, 400, 77]
    feats, starts, pos = [], [], 37  # unaligned first segment
    feats.append(np.zeros((37, 32), np.float32))
    for t, n in enumerate(counts):
        starts.append(pos)
        if n:
            feats.append(_tile_features(rng, t, n, opaque=(t == 4)))
        pos += n
    f = np.concatenate(feats)
    mp = -(-f.shape[0] // 128) * 128
    f = np.pad(f, ((0, mp + 128 - f.shape[0]), (0, 0)))  # +1 window: JAX DMA
    return (f.T.copy(), np.asarray(starts, np.int32),
            np.asarray(counts, np.int32), pos)


def _run_jax(feats_t, starts, counts, num_pairs, mode):
    scalars = jnp.asarray([GRID_X, num_pairs, 0, 0, 0, 0, 0, 0], jnp.float32)
    return np.asarray(jax_blend(jnp.asarray(feats_t), jnp.asarray(counts),
                                jnp.asarray(starts), scalars, GRID_X, GRID_Y,
                                True, mode))


@pytest.mark.parametrize("mode", ["color", "color_depth", "full"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_blend_matches_jax_kernel(mode, seed):
    feats_t, starts, counts, num_pairs = _case(seed)
    if mode == "color":
        feats_t = feats_t[:16]
    want = _run_jax(feats_t, starts, counts, num_pairs, mode)
    got = blend_raw_packed(torch.from_numpy(feats_t),
                           torch.from_numpy(starts), torch.from_numpy(counts),
                           GRID_X, GRID_Y, mode).numpy()
    assert got.shape == want.shape
    nc = 5 if mode == "color" else 16
    flips = got[..., nc] != want[..., nc]
    # threshold flips change every later lane of that pixel; bound them
    assert flips.sum() <= 2, f"{flips.sum()} n_contrib flips"
    ok = ~flips
    np.testing.assert_allclose(got[ok], want[ok], atol=ATOL, rtol=0)
    # the saturating tile really terminated early, the empty ones are empty
    assert (got[4, :, nc] < counts[4]).all()
    assert np.all(got[[0, 3]][..., :4] == 0)
    if mode != "color":
        assert np.all(got[[0, 3]][..., 17] == -1.0)  # no median contributor


def test_kernel_wrapper_rejects_cpu_tensors():
    feats_t, starts, counts, _ = _case(0)
    with pytest.raises(ValueError, match="CUDA"):
        blend_raw_packed_cuda(torch.from_numpy(feats_t),
                              torch.from_numpy(starts),
                              torch.from_numpy(counts), GRID_X, GRID_Y, "full")


def test_wrapper_checks_shapes_and_dtypes():
    feats_t, starts, counts, _ = _case(0)
    with pytest.raises(ValueError, match="lanes"):
        blend_raw_packed(torch.from_numpy(feats_t[:16]),
                         torch.from_numpy(starts), torch.from_numpy(counts),
                         GRID_X, GRID_Y, "full")
    with pytest.raises(TypeError, match="int32"):
        blend_raw_packed(torch.from_numpy(feats_t),
                         torch.from_numpy(starts).long(),
                         torch.from_numpy(counts), GRID_X, GRID_Y, "full")
    with pytest.raises(ValueError, match="whole views"):
        blend_raw_packed(torch.from_numpy(feats_t), torch.from_numpy(starts),
                         torch.from_numpy(counts), GRID_X, GRID_Y + 1, "full")


def _pairs(regime, n=48, seed=3):
    """(6, n) float32 pair lanes xy conic o around the origin: the tiles'
    Gaussians, elongated ones (axis ratios to 300, condition numbers to
    ~1e5), or faint ones at the 1/255 opacity threshold."""
    rng = np.random.RandomState(seed)
    f = _tile_features(rng, 0, n).T[:6].copy()
    f[0:2] = rng.uniform(-0.5, 0.5, (2, n)).astype(np.float32)
    if regime == "elongated":
        s = np.stack([rng.uniform(0.1, 0.6, n), rng.uniform(2.0, 30.0, n)], 1)
        th = rng.uniform(0, np.pi, n)
        c, si = np.cos(th), np.sin(th)
        f[2] = c * c / s[:, 0] ** 2 + si * si / s[:, 1] ** 2
        f[3] = c * si * (1 / s[:, 0] ** 2 - 1 / s[:, 1] ** 2)
        f[4] = si * si / s[:, 0] ** 2 + c * c / s[:, 1] ** 2
    if regime == "faint":
        f[5] = MIN_ALPHA * rng.uniform(0.999, 1.05, n)
    return torch.from_numpy(f.astype(np.float32))


def _candidates(f, px, py):
    """(n, pixels) bool: the plain version's candidate test, float32."""
    dx = f[0][:, None] - px[None, :]
    dy = f[1][:, None] - py[None, :]
    power = (-0.5 * (f[2][:, None] * dx * dx + f[4][:, None] * dy * dy)
             - f[3][:, None] * dx * dy)
    alpha = torch.clamp_max(
        f[5][:, None] * torch.exp(torch.clamp_max(power, 0.0)), 0.99)
    return (power <= 0.0) & (alpha >= MIN_ALPHA)


@pytest.mark.parametrize("regime", ["tiles", "elongated", "faint"])
def test_candidate_box_holds_every_candidate_pixel(regime):
    """The box by which the kernels skip a warp's pairs (blend_common.cuh)
    holds every pixel whose candidate test passes, so skipping changes no
    pixel's walk. On the tiles' Gaussians it is also tight enough to skip:
    within two pixels and 2 % of the candidates' own extent."""
    f = _pairs(regime)
    r = torch.arange(-110.0, 111.0)
    py, px = (g.reshape(-1) for g in torch.meshgrid(r, r, indexing="ij"))
    cand = _candidates(f, px, py)
    box = candidate_box(f)
    inside = ((px[None] >= box[:, 0:1]) & (px[None] <= box[:, 1:2])
              & (py[None] >= box[:, 2:3]) & (py[None] <= box[:, 3:4]))
    assert not (cand & ~inside).any()
    assert torch.isfinite(box).all()
    assert cand.any(1).sum() >= (8 if regime == "faint" else 40)
    if regime != "tiles":
        return
    for lo, hi, pix in ((0, 1, px), (2, 3, py)):
        span = (torch.where(cand, pix, -math.inf).amax(1)
                - torch.where(cand, pix, math.inf).amin(1))
        assert ((box[:, hi] - box[:, lo]) <= 1.02 * span + 2.0).all()


def test_candidate_box_edges():
    """Under 1/255 opacity no pixel is a candidate (empty box); a conic
    that is not positive definite, or a non-finite lane, gives the whole
    plane."""
    f = _pairs("tiles", n=4)
    f[5, 0] = MIN_ALPHA * 0.99
    f[3, 1] = 2.0 * torch.sqrt(f[2, 1] * f[4, 1])  # b^2 > ac
    f[0, 2] = math.nan
    box = candidate_box(f)
    assert box[0, 0] > box[0, 1] and box[0, 2] > box[0, 3]
    whole = torch.tensor([-math.inf, math.inf, -math.inf, math.inf])
    assert torch.equal(box[1], whole) and torch.equal(box[2], whole)
    assert torch.isfinite(box[3]).all()


def test_tile_order_is_a_permutation_deepest_first():
    """The launch order of both kernels (blend_common.cuh): a permutation
    of the tiles whose depth key never rises, the key having four steps an
    octave of tile_count, ties kept by index, empty tiles last."""
    rng = np.random.RandomState(5)
    count = np.concatenate([rng.randint(0, 40_000, 500), np.zeros(20),
                            np.arange(0, 70), [2 ** 30, 2 ** 31 - 1]])
    rng.shuffle(count)
    order = tile_order(torch.from_numpy(count.astype(np.int32))).numpy()
    assert sorted(order.tolist()) == list(range(count.size))
    # the key, independently: 0-3 as they are, then 4 per octave
    def key(c):
        if c < 4:
            return c
        e = int(c).bit_length() - 1
        return 4 * (e - 1) + ((int(c) >> (e - 2)) & 3)
    keys = np.array([key(c) for c in count[order]])
    assert (np.diff(keys) <= 0).all() and keys.max() < 128
    for k in np.unique(keys):
        tiles = order[keys == k]
        assert (np.diff(tiles) > 0).all()  # ties by index
    assert [key(c) for c in (4, 5, 7, 8, 10, 15, 16, 24)] == [
        4, 5, 7, 8, 9, 11, 12, 14]
    assert (count[order][-20:] == 0).all()
