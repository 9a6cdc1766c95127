"""Port network modules against their flax counterparts, with the flax
weights carried over by ``igs_tpu_torch.models.convert``.

Float32 on the CPU on both sides; tolerances are stated per module (the
two frameworks sum convolutions, matmuls and norm statistics in other
orders, which costs ~1e-6 relative per op).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.models import backbone as jbb, grid_encoder as jge
from igs_tpu.models import networks as jnw, renderer as jrd, swin as jsw
from igs_tpu.models import transformer1d as jt1
from igs_tpu_torch.models import backbone, grid_encoder, networks, renderer
from igs_tpu_torch.models import swin, transformer1d
from igs_tpu_torch.models.convert import state_dict_from_flax

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)


def _load(module, flax_vars, prefix):
    """Load a standalone flax module's params into ``module`` by placing
    them at their AGM-Net path ``prefix`` for the converter."""
    tree = flax_vars["params"]
    for part in reversed(prefix.split(".")):
        tree = {part: tree}
    sd = state_dict_from_flax(tree)
    cut = len(prefix) + 1
    module.load_state_dict({k[cut:]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def test_cnn_encoder():
    x = np.random.RandomState(0).normal(size=(2, 3, 32, 32)).astype(np.float32)
    jm = jbb.CNNEncoder(32)
    v = jm.init(KEY, jnp.asarray(x))
    tm = _load(backbone.CNNEncoder(32), v, "backbone.backbone")
    _close(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)), atol=1e-4)


@pytest.mark.parametrize("cls", ["FeatureTransformer", "FeatureTransformerMy"])
def test_feature_transformers(cls):
    rng = np.random.RandomState(1)
    f0, f1 = (rng.normal(size=(2, 32, 8, 8)).astype(np.float32)
              for _ in range(2))
    layers = 2  # the shifted-window mask runs on the odd layer
    jm = getattr(jsw, cls)(num_layers=layers, d_model=32)
    v = jm.init(KEY, jnp.asarray(f0), jnp.asarray(f1))
    prefix = "backbone.transformer" if cls == "FeatureTransformer" else "transformer"
    tm = _load(getattr(swin, cls)(num_layers=layers, d_model=32), v, prefix)
    want = jm.apply(v, jnp.asarray(f0), jnp.asarray(f1))
    got = tm(torch.from_numpy(f0), torch.from_numpy(f1))
    if cls == "FeatureTransformer":
        for g_, w_ in zip(got, want):
            _close(g_, w_, atol=1e-4)
    else:
        _close(got, want, atol=1e-4)


def test_feature_add_position():
    rng = np.random.RandomState(2)
    f0, f1 = (rng.normal(size=(1, 32, 8, 8)).astype(np.float32)
              for _ in range(2))
    want = jsw.feature_add_position(jnp.asarray(f0), jnp.asarray(f1), 2, 32)
    got = swin.feature_add_position(torch.from_numpy(f0), torch.from_numpy(f1),
                                    2, 32)
    for g_, w_ in zip(got, want):
        _close(g_, w_, atol=1e-6)


def test_transformer1d():
    x = np.random.RandomState(3).normal(size=(2, 32, 48)).astype(np.float32)
    jm = jt1.Transformer1D(in_channels=32, num_attention_heads=2,
                           attention_head_dim=16, num_layers=2)
    v = jm.init(KEY, jnp.asarray(x))
    tm = _load(transformer1d.Transformer1D(32, 2, 16, 2), v,
               "triplane_encoder.conv")
    _close(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)), atol=1e-4)


def test_grid_encoder():
    rng = np.random.RandomState(4)
    b, v, a = 2, 3, 40
    motion = rng.normal(size=(b * v, 32, 16, 16)).astype(np.float32)
    anchors = rng.uniform(-1, 1, (b, a, 3)).astype(np.float32)
    fov = np.full((b, 2), 0.8, np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    c2w[:, :, 2, 3] = -4.0
    c2w[:, :, 0, 3] = rng.uniform(-0.5, 0.5, (b, v))
    args = [motion, anchors, fov, c2w]
    jm = jge.GridEncoder(in_channels=32, num_attention_heads=2,
                         attention_head_dim=16, num_layers=1)
    vs = jm.init(KEY, *map(jnp.asarray, args))
    tm = _load(grid_encoder.GridEncoder(32, 2, 16, 1), vs, "triplane_encoder")
    _close(tm(*map(torch.from_numpy, args)),
           jm.apply(vs, *map(jnp.asarray, args)), atol=1e-4)


def test_modln():
    rng = np.random.RandomState(5)
    x = rng.normal(size=(2, 6, 6, 32)).astype(np.float32)
    cond = rng.normal(size=(2, 6, 6, 33)).astype(np.float32)
    jm = jnw.ModLN(32)
    v = jm.init(KEY, jnp.asarray(x), jnp.asarray(cond))
    tm = _load(networks.ModLN(32, mod_dim=33), v, "ModLN")
    _close(tm(torch.from_numpy(x), torch.from_numpy(cond)),
           jm.apply(v, jnp.asarray(x), jnp.asarray(cond)), atol=1e-5)


def test_residual_decoder():
    rng = np.random.RandomState(6)
    x = rng.normal(size=(2, 50, 32)).astype(np.float32)
    jm = jrd.ResidualDecoder(in_channels=32, n_neurons=32)
    v = jm.init(KEY, jnp.asarray(x))
    v = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, 0.3, p.shape), jnp.float32), v)  # heads are zero-init
    tm = _load(renderer.ResidualDecoder(32, 32), v, "render")
    want = jm.apply(v, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    for k in ("xyz", "rotation"):
        _close(got[k], want[k], atol=1e-5)


def test_zero_init_heads_from_generator():
    m = renderer.ResidualDecoder(32, 32)
    networks.init_weights(m, torch.Generator().manual_seed(0))
    out = m(torch.randn(4, 32))
    assert torch.all(out["xyz"] == 0)
    assert torch.allclose(out["rotation"],
                          torch.tensor([1.0, 1e-2, 1e-2, 1e-2]).expand(4, 4))
