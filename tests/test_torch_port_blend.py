"""Port blend: the plain PyTorch ``blend_raw_packed`` against the JAX
packed kernel in interpret mode, on identical packed features.

Tolerance 2e-4 absolute: the envelope of the JAX kernel's bf16 hi/lo
split dots (pallas_blend.py:50-58). ``n_contrib`` must be equal except
where a pixel sits on the termination threshold, where the two
summation orders may flip the decision; such flips are counted and
bounded.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.ops.pallas_blend import blend_raw_packed as jax_blend
from igs_tpu_torch.ops.blend import blend_raw_packed, blend_raw_packed_cuda

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
