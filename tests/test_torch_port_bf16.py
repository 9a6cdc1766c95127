"""The bf16 compute flags and ``mixed_precision: bf16`` against the JAX
package's bf16 modules, with the flax weights carried over by
``models/convert``.

bf16 parity is never bitwise: XLA keeps some bf16 intermediates in float32
inside a fusion where PyTorch rounds after every op, and the JAX window
attention rounds its scores to bf16 before the float32 softmax where
``F.scaled_dot_product_attention`` keeps them in float32 (single layers
that round at the same points, a bf16 Dense or Conv, agree bit for bit).
So each tolerance is sized from the JAX package's own bf16-versus-f32 gap
on the same inputs and weights, ``gap = jax_bf16 − jax_f32``:

* the port's bf16 output against JAX's bf16 output: RMS at most 1.5 × the
  RMS of ``gap`` and max |·| at most 2 × max |gap| (measured: RMS
  0.67–0.95 ×, max 0.66–1.17 × over the modules below);
* the port's own bf16-versus-f32 change has an RMS between 0.5 × and
  2 × the RMS of ``gap``: the port's bf16 moves the output as much as
  JAX's does, so a float32 path passing as bf16 fails;
* every layer's output type equals the type of the JAX layer at the same
  parameter path (bf16 where JAX computes in bf16, float32 where it pins
  float32: the LayerNorms, the residual adds, the encoder's output).

The whole AGM-Net forward with the three flags: the same bounds on the
eval render, and the rasterizer's inputs are float32.

One train step with ``mixed_precision: bf16`` against JAX
``make_train_step`` (C18's float32 bounds cannot hold: the JAX bf16 step
itself moves each tensor's clipped gradient by 3–66 % of its largest
entry): the loss within 0.5 × the JAX bf16-versus-f32 loss gap plus 1e-5
relative (measured 0.17 ×), the port's own bf16-versus-f32 loss change
between 0.5 × and 2 × that gap (measured 1.17 ×); the clipped gradient
(the first Adam moment over 1 − b1) per tensor within 1.5 × the JAX
gap's max |·| (measured ≤ 0.99 ×) and over all tensors within 0.75 × its
L2 norm (measured 0.48 ×); parameters and optimizer state stay float32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.models import backbone as jbb, swin as jsw
from igs_tpu.models import transformer1d as jt1
from igs_tpu.models.agm import AGMNet as JAGMNet
from igs_tpu.ops.anchors import select_anchors as jax_select_anchors
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.train import driver as jdriver
from igs_tpu_torch.models import backbone, swin, transformer1d
from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.models.convert import (
    _module_key, load_flax_params, state_dict_from_flax)
from igs_tpu_torch.models.networks import Conv, Dense, GroupNorm, LayerNorm
from igs_tpu_torch.ops import rasterize as rasterize_mod
from igs_tpu_torch.ops.anchors import AnchorState
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.train.driver import (
    OptConfig, make_optimizer, make_train_step)
from tests.torch_port_common import (
    TINY, flax_params, numpy_batch, to_torch_gaussians)

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
BF16 = torch.bfloat16
RMS_RATIO, MAX_RATIO = 1.5, 2.0
OWN_GAP = (0.5, 2.0)


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x))))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not \
        torch.is_tensor(x) else x.detach().float().numpy()


def _check_gap(name, jax_f32, jax_bf16, port_f32, port_bf16):
    jf, jb, tf, tb = map(_f32, (jax_f32, jax_bf16, port_f32, port_bf16))
    gap, err, own = jb - jf, tb - jb, tb - tf
    assert _rms(gap) > 0, name
    assert _rms(err) <= RMS_RATIO * _rms(gap), (name, _rms(err), _rms(gap))
    assert np.abs(err).max() <= MAX_RATIO * np.abs(gap).max(), (
        name, np.abs(err).max(), np.abs(gap).max())
    lo, hi = OWN_GAP
    assert lo * _rms(gap) <= _rms(own) <= hi * _rms(gap), (
        name, _rms(own), _rms(gap))


def _load(module, flax_vars, prefix):
    """Load a standalone flax module's params into ``module`` by placing
    them at their AGM-Net path ``prefix`` for the converter."""
    tree = flax_vars["params"]
    for part in reversed(prefix.split(".")):
        tree = {part: tree}
    cut = len(_module_key(prefix, 2)) + 1
    module.load_state_dict({k[cut:]: v for k, v in
                            state_dict_from_flax(tree).items()}, strict=True)
    return module.eval()


def _jax_types(intermediates, prefix):
    """{port module name: output dtype} of the flax modules whose path
    maps to a port layer."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(intermediates)[0]
    for path, leaf in flat:
        keys = [p.key for p in path if hasattr(p, "key")]
        if keys[-1] != "__call__":
            continue
        module = ".".join(filter(None, [prefix] + keys[:-1]))
        out[_module_key(module, 2)] = leaf.dtype
    return out


def _port_types(module, prefix, run):
    """{name: output dtype} of the port's Dense/Conv/LayerNorm/GroupNorm
    layers while ``run()`` calls ``module``."""
    seen, hooks = {}, []

    def record(full):
        def hook(_m, _a, out):
            seen.setdefault(full, out.dtype)
        return hook

    for name, m in module.named_modules():
        if isinstance(m, (Dense, Conv, LayerNorm, GroupNorm)):
            full = ".".join(filter(None, [prefix, name]))
            hooks.append(m.register_forward_hook(record(full)))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return seen


def _check_types(jax_types, port_types, want_bf16):
    names = sorted(set(jax_types) & set(port_types))
    assert len(names) >= 3, (sorted(jax_types), sorted(port_types))
    for n in names:
        want = torch.bfloat16 if jax_types[n] == jnp.bfloat16 else \
            torch.float32
        assert port_types[n] == want, (n, port_types[n], jax_types[n])
    assert any(port_types[n] == torch.bfloat16 for n in names) == want_bf16


def _modules(kind):
    """(flax f32, flax bf16, port f32, port bf16, AGM-Net path, numpy
    inputs) of one module kind."""
    rng = np.random.RandomState(0)
    if kind == "cnn":
        x = rng.normal(size=(2, 3, 64, 64)).astype(np.float32)
        return (jbb.CNNEncoder(32), jbb.CNNEncoder(32, dtype=jnp.bfloat16),
                backbone.CNNEncoder(32), backbone.CNNEncoder(32, dtype=BF16),
                "backbone.backbone", [x])
    if kind in ("transformer_layer", "feature_transformer"):
        f0, f1 = (rng.normal(size=(2, 32, 8, 8)).astype(np.float32)
                  for _ in range(2))
        if kind == "feature_transformer":
            return (jsw.FeatureTransformer(2, 32),
                    jsw.FeatureTransformer(2, 32, dtype=jnp.bfloat16),
                    swin.FeatureTransformer(2, 32),
                    swin.FeatureTransformer(2, 32, dtype=BF16),
                    "backbone.transformer", [f0, f1])
        t0, t1 = (f.reshape(2, 32, 64).transpose(0, 2, 1).copy()
                  for f in (f0, f1))
        # the shifted-window layer: the −100 mask in the query's type
        return (jsw.TransformerLayer(32), jsw.TransformerLayer(
                    32, dtype=jnp.bfloat16),
                swin.TransformerLayer(32), swin.TransformerLayer(
                    32, dtype=BF16),
                "backbone.transformer.layer0.cross_attn_ffn",
                [t0, t1, 8, 8, 2, True])
    x = rng.normal(size=(2, 32, 48)).astype(np.float32)
    if kind == "attention":
        t = x.transpose(0, 2, 1).copy()
        return (jt1.Attention(2, 16), jt1.Attention(2, 16,
                                                      dtype=jnp.bfloat16),
                transformer1d.Attention(32, 2, 16),
                transformer1d.Attention(32, 2, 16, dtype=BF16),
                "triplane_encoder.conv.block0.attn1", [t])
    return (jt1.Transformer1D(32, 2, 16, 2),
            jt1.Transformer1D(32, 2, 16, 2, dtype=jnp.bfloat16),
            transformer1d.Transformer1D(32, 2, 16, 2),
            transformer1d.Transformer1D(32, 2, 16, 2, dtype=BF16),
            "triplane_encoder.conv", [x])


@pytest.mark.parametrize("kind", ["cnn", "transformer_layer",
                                  "feature_transformer", "attention",
                                  "transformer1d"])
def test_module_bf16_matches_jax(kind):
    jf, jb, tf, tb, prefix, args = _modules(kind)
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for a in args]
    v = jf.init(KEY, *jargs)
    want_f32 = jf.apply(v, *jargs)
    want, inter = jb.apply(v, *jargs, capture_intermediates=True,
                           mutable=["intermediates"])
    _load(tf, v, prefix)
    _load(tb, v, prefix)
    with torch.no_grad():
        got_f32 = tf(*targs)
        types = _port_types(tb, _module_key(prefix, 2), lambda: tb(*targs))
        got = tb(*targs)
    if kind == "feature_transformer":
        for i in range(2):
            _check_gap(f"{kind}[{i}]", want_f32[i], want[i], got_f32[i],
                       got[i])
            assert got[i].dtype == torch.float32
    else:
        _check_gap(kind, want_f32, want, got_f32, got)
        assert got.dtype == torch.float32
    _check_types(_jax_types(inter["intermediates"], prefix), types, True)


def _agm_inputs():
    _, params, g = flax_params()
    batch = numpy_batch(b=2)
    state = jax_select_anchors(g.xyz, jnp.asarray(batch["bounding_box"][0]),
                               valid=g.valid, anchor_size=32, k=4,
                               exact_knn=True)
    return params, g, batch, state


def test_agm_forward_bf16_matches_jax():
    """The three flags on: the eval render against JAX's, and every
    rasterizer input float32."""
    params, g, batch, state = _agm_inputs()
    js = JSettings(image_height=40, image_width=48, impl="pallas_packed",
                   pallas_interpret=True, max_pairs=1 << 14)
    ts = RasterSettings(image_height=40, image_width=48, max_pairs=1 << 14)
    rep = lambda x: None if x is None else jnp.stack([x] * 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flags = dict(encoder_bf16=True, cnn_bf16=True, ft_bf16=True)
    want = {}
    for on in (False, True):
        m = JAGMNet(**TINY, **(flags if on else {}))
        want[on] = np.asarray(m.apply(params, jb, jax.tree.map(rep, state),
                                      jax.tree.map(rep, g), js)["images_pred"])
    tg = to_torch_gaussians(g)
    tstate = AnchorState(*(torch.tensor(np.asarray(x)).expand(
        (2,) + x.shape) for x in state))
    tgs = tg.map(lambda x: x.expand((2,) + x.shape))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, seen = {}, []
    rasterize = rasterize_mod.rasterize

    def spy(*a, **kw):
        seen.extend(x.dtype for x in list(a) + list(kw.values())
                    if torch.is_tensor(x) and x.is_floating_point())
        return rasterize(*a, **kw)

    for on in (False, True):
        m = AGMNet(**TINY, **(flags if on else {}))
        load_flax_params(m, params)
        m.eval()
        with torch.no_grad():
            got[on] = m(tb, tstate, tgs, ts)["images_pred"].numpy()
    _check_gap("images_pred", want[False], want[True], got[False], got[True])

    from igs_tpu_torch.models import renderer
    renderer.rasterize, old = spy, renderer.rasterize
    try:
        with torch.no_grad():
            out = m(tb, tstate, tgs, ts)
    finally:
        renderer.rasterize = old
    assert seen and all(d == torch.float32 for d in seen)
    assert out["3dgs"].xyz.dtype == torch.float32


def test_mixed_precision_train_step_matches_jax():
    """One ``mixed_precision: bf16`` step: loss and clipped gradient."""
    _, params, g = flax_params(local_ray=False)
    batch = numpy_batch(b=2, v=2, hw=32, out_hw=(32, 32), seed=0)
    state = jax_select_anchors(g.xyz, jnp.asarray(batch["bounding_box"][0]),
                               valid=g.valid, anchor_size=32, k=4,
                               exact_knn=True)
    host_params = jax.tree.map(np.asarray, params)
    js = JSettings(image_height=32, image_width=32, impl="pallas",
                   pallas_interpret=True, max_pairs=1 << 13,
                   max_per_tile=128, chunk=64, clamp_grads=True)
    ts = RasterSettings(image_height=32, image_width=32, impl="pallas",
                        max_pairs=1 << 13, max_per_tile=128, chunk=64,
                        clamp_grads=True)
    rep = lambda x: None if x is None else jnp.stack([x] * 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JAGMNet(local_ray=False, **TINY)
    want = {}
    for mp in ("no", "bf16"):
        cfg = OptConfig(warmup_steps=3, gradient_clip=0.1,
                        mixed_precision=mp)
        p = jax.tree.map(jnp.asarray, host_params)
        tx, _ = jdriver.make_optimizer(p, cfg, 10)
        opt_state = tx.init(p)
        step = jdriver.make_train_step(jmodel, tx, cfg, js)
        _, opt_state, metrics = step(p, opt_state, jb,
                                     jax.tree.map(rep, state),
                                     jax.tree.map(rep, g))
        mu = [leaf for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(leaf, "mu")][0].mu
        want[mp] = (float(metrics["loss"]), state_dict_from_flax(
            jax.tree.map(lambda x: x / (1 - cfg.beta1), mu)))

    tstate = AnchorState(*(torch.tensor(np.asarray(x)).expand(
        (2,) + x.shape) for x in state))
    tgs = to_torch_gaussians(g).map(lambda x: x.expand((2,) + x.shape))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = {}
    for mp in ("no", "bf16"):
        cfg = OptConfig(warmup_steps=3, gradient_clip=0.1,
                        mixed_precision=mp)
        model = AGMNet(local_ray=False, **TINY)
        load_flax_params(model, host_params)
        model.train()
        optimizer, _ = make_optimizer(model, cfg, 10)
        metrics = make_train_step(cfg, ts)(model, optimizer, tb, tstate, tgs)
        got[mp] = (float(metrics["loss"]),
                   {k: m / (1 - cfg.beta1) for k, m in optimizer.mu.items()})
        # the master parameters and the optimizer state stay float32
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(m.dtype == torch.float32 for m in optimizer.mu.values())

    loss, jloss = got["bf16"][0], want["bf16"][0]
    gap = abs(jloss - want["no"][0])
    assert gap > 0
    assert abs(loss - jloss) <= 0.5 * gap + 1e-5 * abs(loss)
    assert 0.5 * gap <= abs(loss - got["no"][0]) <= 2 * gap
    err2 = gap2 = 0.0
    for k, m in got["bf16"][1].items():
        g_, w = m.numpy(), want["bf16"][1][k].numpy()
        w0 = want["no"][1][k].numpy()
        assert np.abs(g_ - w).max() <= 1.5 * np.abs(w - w0).max() + 1e-7, k
        err2 += float(np.sum(np.square(g_ - w)))
        gap2 += float(np.sum(np.square(w - w0)))
    assert err2 <= 0.75 ** 2 * gap2, (err2 ** 0.5, gap2 ** 0.5)
