"""Port segmented reduction: the binning aux against the JAX package's
exactly, ``segmented_scan_plain`` against the JAX Pallas kernel in
interpret mode, and ``gather_pairs``' backward against the JAX VJP.

The scan is held to 1e-5 of each segment's magnitude (Σ|x| over the
segment): the JAX kernel's bf16 hi/lo split dots carry ~2^-17 relative
error (``igs_tpu/ops/segred.py:21-27``); the plain version sums in
float64. The gather's backward is held to the same bound per row.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.ops.binning import build_tile_pairs as jax_build_pairs
from igs_tpu.ops.projection import project as jax_project
from igs_tpu.ops.segred import gather_pairs as jax_gather_pairs
from igs_tpu.ops.segred import segmented_scan as jax_segmented_scan
from igs_tpu_torch.ops.binning import build_tile_pairs
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.segred import (
    gather_pairs, segmented_scan, segmented_scan_cuda, segmented_scan_plain)
from tests.test_torch_port_raster import H, W, _args, _scene

torch.set_num_threads(2)

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
