"""The port's LPIPS (``train/lpips.py``) against the JAX package's, its
weights carried both ways, and the LPIPS term's resize.

The same seeded flax init (random VGG, random heads) goes through
``models/convert.lpips_state_dict_from_flax`` into the port: the two
distances agree to 1e-4 relative per item (float32 convolutions summed
in another order; measured ≤ 1e-6). A port ``state_dict`` written with
``torch.save`` loads into the JAX package's ``make_lpips``, which must
report it available with 18 tensors and give the port's distance; the
port's ``load_torch_lpips`` reads richzhang's and lpipsPyTorch's names
with JAX's count. Without weights the port's VGG is a seeded draw that
``make_lpips`` reports unavailable (ROADMAP C26).

The term's resize: ``jax.image.resize(method="bilinear")`` antialiases a
downsample, so the port resizes with ``F.interpolate(antialias=True)``
(ROADMAP C22): within 1e-6 of JAX at 512² → 256² and 64² → 256², where
plain bilinear misses by more than 1e-2 at 512².
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from igs_tpu.train import lpips as jlpips
from igs_tpu_torch.models.convert import (
    flax_lpips_from_state_dict, lpips_state_dict_from_flax)
from igs_tpu_torch.train import lpips
from igs_tpu_torch.train.driver import LPIPS_RES, lpips_prep

torch.set_num_threads(2)


def _flax_init(seed=0):
    """A flax LPIPS init with the heads drawn random (their ones-init
    would hide a head mix-up)."""
    model = jlpips.LPIPS()
    dummy = jnp.zeros((1, 3, 64, 64))
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), dummy, dummy))
    rng = np.random.RandomState(seed + 1)
    for i in range(5):
        k = params["params"][f"lin{i}"]["kernel"]
        params["params"][f"lin{i}"]["kernel"] = rng.uniform(
            0, 0.1, k.shape).astype(np.float32)
    return model, params


@pytest.fixture(scope="module")
def carried():
    model, params = _flax_init()
    port = lpips.LPIPS()
    port.load_state_dict(lpips_state_dict_from_flax(params), strict=True)
    return model, params, port


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 3, 64, 64), (1, 3, 48, 80)])
def test_lpips_matches_jax(carried, shape):
    model, params, port = carried
    x, y = _inputs(shape, seed=shape[2])
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x),
                                           jnp.asarray(y)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_weights_round_trip_and_load_into_jax(carried, tmp_path):
    model, params, port = carried
    # the inverse conversion gives back the flax tree, bit for bit
    back = flax_lpips_from_state_dict(port.state_dict())
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back) == 31
    for path, v in flat:
        np.testing.assert_array_equal(flat_back[path], v)
    # a torch.save of the port's state_dict is an lpipsPyTorch file
    sd = port.state_dict()
    assert sorted(k for k in sd if k.startswith("lin.")) == [
        f"lin.{i}.1.weight" for i in range(5)]
    assert {int(k.split(".")[2]) for k in sd if k.startswith("net.")} == set(
        lpips.CONV_LAYERS)
    path = str(tmp_path / "lpips.pth")
    torch.save(sd, path)
    fn, available = jlpips.make_lpips(path)
    assert available
    _, loaded = jlpips.load_torch_lpips(
        model.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, 64, 64)),
                   jnp.zeros((1, 3, 64, 64))),
        {k: v.numpy() for k, v in sd.items()})
    assert loaded == 18
    x, y = _inputs((2, 3, 64, 64), seed=5)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(np.asarray(fn(jnp.asarray(x), jnp.asarray(y))),
                               got, rtol=1e-4, atol=0)
    # and back through the port's own reader
    again, ok = lpips.make_lpips(path, device="cpu")
    assert ok
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("family", ["richzhang", "lpipsPyTorch"])
def test_load_torch_lpips_counts_as_jax(carried, family):
    model, params, port = carried
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    if family == "richzhang":
        # lpips' slices: the convs of each stage, indexed as in features
        slices = (range(0, 4), range(4, 9), range(9, 16), range(16, 23),
                  range(23, 30))
        renamed = {}
        for n, idx in enumerate(slices, start=1):
            for layer in idx:
                for leaf in ("weight", "bias"):
                    k = f"net.layers.{layer}.{leaf}"
                    if k in sd:
                        renamed[f"net.slice{n}.{layer}.{leaf}"] = sd[k]
        for i in range(5):
            renamed[f"lins.{i}.model.1.weight"] = sd[f"lin.{i}.1.weight"]
        sd = renamed
    init = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 3, 64, 64)),
                      jnp.zeros((1, 3, 64, 64)))
    _, want = jlpips.load_torch_lpips(init, sd)
    fresh = lpips.LPIPS(generator=torch.Generator().manual_seed(9))
    assert lpips.load_torch_lpips(fresh, sd) == want == 18
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, port.state_dict()[k]), k


def test_unweighted_lpips_is_the_seeded_draw(tmp_path):
    """Only without weights is the VGG the seeded draw (C26): the same
    draw every time, unavailable; a weights file replaces all of it."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        a, ok_a = lpips.make_lpips(None, device="cpu")
        b, ok_b = lpips.make_lpips(str(tmp_path / "missing.pth"),
                                   device="cpu")
    assert not ok_a and not ok_b
    assert any("seeded random draw" in str(w.message) for w in caught)
    seeded = lpips.LPIPS(generator=torch.Generator().manual_seed(0))
    for k, v in seeded.state_dict().items():
        assert torch.equal(a.state_dict()[k], v)
        assert torch.equal(b.state_dict()[k], v)
    assert not any(p.requires_grad for p in a.parameters())
    assert not a.training
    _, params = _flax_init(seed=3)
    path = str(tmp_path / "w.pth")
    torch.save(lpips_state_dict_from_flax(params), path)
    c, ok_c = lpips.make_lpips(path, device="cpu")
    assert ok_c
    weights = [k for k in c.state_dict() if k.endswith(".weight")]
    assert len(weights) == 18
    for k in weights:
        assert not torch.equal(c.state_dict()[k], seeded.state_dict()[k]), k


def _jax_prep(img):
    b, v = img.shape[:2]
    flat = img.reshape(b * v, *img.shape[2:]) * 2.0 - 1.0
    return jax.image.resize(flat, (b * v, flat.shape[1], LPIPS_RES,
                                   LPIPS_RES), method="bilinear")


@pytest.mark.parametrize("hw", [512, 64])
def test_resize_matches_jax_image_resize(hw):
    rng = np.random.RandomState(hw)
    img = rng.uniform(0, 1, (1, 2, 3, hw, hw)).astype(np.float32)
    want = np.asarray(jax.jit(_jax_prep)(jnp.asarray(img)))
    got = lpips_prep(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 3, LPIPS_RES, LPIPS_RES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    plain = F.interpolate(torch.from_numpy(img[0]) * 2 - 1,
                          size=(LPIPS_RES, LPIPS_RES), mode="bilinear",
                          align_corners=False).numpy()
    if hw == 512:  # C22: the plain bilinear filter the JAX comment names
        assert np.abs(plain - want).max() > 1e-2
    else:  # upsampling: no antialias, the two filters agree
        np.testing.assert_allclose(plain, want, rtol=0, atol=1e-6)
