"""One AGM-Net train step with the LPIPS term (``lambda_lpips`` > 0)
against the JAX package's ``make_train_step``, on both routes and in
both precisions.

The same flax weights go into both packages (AGM-Net through
``models/convert``, the LPIPS through ``lpips_state_dict_from_flax`` from
a seeded flax init with random heads), on the same numpy batch; the 32²
renders and GT go to 256² through each package's resize (upsampling: no
antialias, ROADMAP C22) and through the frozen VGG.

Float32 (C18's bounds): the loss to 1e-5 relative, ``loss_lpips`` to
1e-5 relative, and the clipped gradient (the first Adam moment over
1 − b1) of every trainable tensor (the backbone frozen, as the model's
default) to 1e-4 of its largest entry plus 1e-3 relative. Measured on
the CPU: the loss and ``loss_lpips`` within 2.1e-7 relative; the largest
gradient difference 5.6e-4 (windowed) and 3.4e-4 (packed) of its
tensor's largest entry, on entries the relative term covers. The VGG's
unit normalisation ``a / (‖a‖ + 1e-10)`` has a Jacobian of ~1/‖a‖, so a
pixel whose feature norm is near zero could set the gradient gap; it
does not here: the render side's smallest feature norm is 0.156 (the
test prints it).

``mixed_precision: bf16`` (C18's bf16 bounds): the loss within 0.5 × the
JAX bf16-versus-f32 loss gap plus 1e-5 relative, the clipped gradient
per tensor within 1.5 × the gap's max |·| and over all tensors within
0.75 × its L2 norm, on the two-item batch of the C18 bf16 test (measured:
the loss 0.16 × the gap, ``loss_lpips`` 0.056 × its own gap, per tensor
≤ 1.10 ×, L2 0.49 ×). LPIPS runs in float32 in both packages. On a
one-item batch the bf16 step misses C18's loss bound (0.70 × the gap,
per tensor 1.62 ×), from the L1 term (0.53 × its gap) and not the LPIPS
term (0.50 ×): C18's bf16 bounds were sized on the two-item batch
(ROADMAP C18).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.models.agm import AGMNet as JAGMNet
from igs_tpu.ops.anchors import select_anchors as jax_select_anchors
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.train import driver as jdriver
from igs_tpu.train import lpips as jlpips
from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.models.convert import (
    load_flax_params, lpips_state_dict_from_flax, state_dict_from_flax)
from igs_tpu_torch.ops.anchors import AnchorState
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.train import lpips
from igs_tpu_torch.train.driver import (
    OptConfig, lpips_prep, make_optimizer, make_train_step)
from tests.torch_port_common import TINY, flax_params, numpy_batch, \
    to_torch_gaussians

torch.set_num_threads(2)

HW = 32
LAMBDA = 0.5


@pytest.fixture(scope="module")
def inputs():
    _, params, g = flax_params(local_ray=False)
    batch = numpy_batch(b=2, v=2, hw=HW, out_hw=(HW, HW), seed=0)
    state = jax_select_anchors(g.xyz, jnp.asarray(batch["bounding_box"][0]),
                               valid=g.valid, anchor_size=32, k=4,
                               exact_knn=True)
    lp = jlpips.LPIPS()
    dummy = jnp.zeros((1, 3, 64, 64))
    lp_params = jax.tree.map(np.asarray, lp.init(jax.random.PRNGKey(0),
                                                 dummy, dummy))
    rng = np.random.RandomState(4)
    for i in range(5):
        k = lp_params["params"][f"lin{i}"]["kernel"]
        lp_params["params"][f"lin{i}"]["kernel"] = rng.uniform(
            0, 0.1, k.shape).astype(np.float32)
    return jax.tree.map(np.asarray, params), g, batch, state, lp_params


def _settings(impl):
    kw = dict(max_pairs=1 << 13, clamp_grads=True)
    if impl == "pallas":
        kw.update(max_per_tile=128, chunk=64)
    return (JSettings(image_height=HW, image_width=HW, impl=impl,
                      pallas_interpret=True, **kw),
            RasterSettings(image_height=HW, image_width=HW, impl=impl, **kw))


def _mu(state):
    for leaf in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf.mu
    raise KeyError("no Adam state")


def _jax_step(inputs, impl, mp):
    params, g, batch, state, lp_params = inputs
    js, _ = _settings(impl)
    cfg = OptConfig(warmup_steps=3, gradient_clip=0.1, lambda_lpips=LAMBDA,
                    mixed_precision=mp)
    p = jax.tree.map(jnp.asarray, params)
    tx, _ = jdriver.make_optimizer(p, cfg, 10)
    opt_state = tx.init(p)
    step = jdriver.make_train_step(
        JAGMNet(local_ray=False, **TINY), tx, cfg, js,
        lpips_params=jax.tree.map(jnp.asarray, lp_params))
    rep = lambda x: None if x is None else jnp.stack([x] * 2)
    _, opt_state, metrics = step(
        p, opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.tree.map(rep, state), jax.tree.map(rep, g))
    mu = state_dict_from_flax(jax.tree.map(lambda x: x / (1 - cfg.beta1),
                                           _mu(opt_state)))
    return {k: float(v) for k, v in metrics.items()}, mu


def _port_step(inputs, impl, mp):
    params, g, batch, state, lp_params = inputs
    _, ts = _settings(impl)
    cfg = OptConfig(warmup_steps=3, gradient_clip=0.1, lambda_lpips=LAMBDA,
                    mixed_precision=mp)
    model = AGMNet(local_ray=False, **TINY)
    load_flax_params(model, params)
    model.train()
    lp = lpips.LPIPS()
    lp.load_state_dict(lpips_state_dict_from_flax(lp_params), strict=True)
    optimizer, _ = make_optimizer(model, cfg, 10)
    stages = []
    step = make_train_step(cfg, ts, on_stage=stages.append, lpips=lp)
    tstate = AnchorState(*(torch.tensor(np.asarray(x)).expand(
        (2,) + x.shape) for x in state))
    tgs = to_torch_gaussians(g).map(lambda x: x.expand((2,) + x.shape))
    metrics = step(model, optimizer,
                   {k: torch.from_numpy(v) for k, v in batch.items()},
                   tstate, tgs)
    # the frozen LPIPS stays out of the model and the optimizer
    assert not any(k.startswith(("net.", "lin.")) for k in
                   model.state_dict())
    assert all(p.grad is None for p in lp.parameters())
    mu = {k: m / (1 - cfg.beta1) for k, m in optimizer.mu.items()}
    return metrics, mu, stages, (model, lp, batch, tstate, tgs, ts)


@pytest.mark.parametrize("impl", ["pallas", "pallas_packed"])
def test_lpips_train_step_matches_jax(inputs, impl):
    want, want_mu = _jax_step(inputs, impl, "no")
    got, got_mu, stages, (model, lp, batch, tstate, tgs, ts) = _port_step(
        inputs, impl, "no")
    assert stages == ["start", "forward", "loss", "lpips", "lpips_backward",
                      "backward", "optimizer"]
    for k in ("loss", "loss_mse", "loss_ssim", "loss_lpips", "psnr"):
        assert float(got[k]) == pytest.approx(want[k], rel=1e-5), k
    assert want["loss_lpips"] > 0
    assert got["grad_norm"] > 0.1  # the clip binds
    worst = 0.0
    assert len(got_mu) > 10
    for k, g_ in got_mu.items():
        w, g_ = want_mu[k].numpy(), g_.numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g_, w, rtol=1e-3,
                                   atol=1e-4 * scale + 1e-7, err_msg=k)
        if scale > 0:
            worst = max(worst, float(np.abs(g_ - w).max()) / scale)
    # the render side's smallest feature norm (the normalisation's 1/‖a‖)
    with torch.no_grad():
        pred = model(batch_t := {k: torch.from_numpy(v) for k, v in
                                 batch.items()}, tstate, tgs, ts)[
            "images_pred"]
        feats = lp.net((lpips_prep(pred) - lp.shift) / lp.scale)
        least = min(float(torch.sqrt((a * a).sum(1)).min()) for a in feats)
    print(f"{impl}: gradient gap / largest entry {worst}; loss_lpips "
          f"{float(got['loss_lpips']):.7g} vs {want['loss_lpips']:.7g}; "
          f"smallest feature norm {least:.3g}")
    assert batch_t["images_output"].shape[-1] == HW


def test_lpips_bf16_step_matches_jax(inputs):
    impl = "pallas"
    want = {mp: _jax_step(inputs, impl, mp) for mp in ("no", "bf16")}
    got = {mp: _port_step(inputs, impl, mp)[:2] for mp in ("no", "bf16")}
    loss, jloss = float(got["bf16"][0]["loss"]), want["bf16"][0]["loss"]
    gap = abs(jloss - want["no"][0]["loss"])
    assert gap > 0
    assert abs(loss - jloss) <= 0.5 * gap + 1e-5 * abs(loss)
    assert float(got["bf16"][0]["loss_lpips"]) > 0
    err2 = gap2 = 0.0
    for k, m in got["bf16"][1].items():
        g_, w = m.numpy(), want["bf16"][1][k].numpy()
        w0 = want["no"][1][k].numpy()
        assert np.abs(g_ - w).max() <= 1.5 * np.abs(w - w0).max() + 1e-7, k
        err2 += float(np.sum(np.square(g_ - w)))
        gap2 += float(np.sum(np.square(w - w0)))
    print(f"bf16: loss {loss:.7g} vs {jloss:.7g} (gap {gap:.3g}); gradient "
          f"L2 error / gap {(err2 / gap2) ** 0.5:.3g}")
    assert err2 <= 0.75 ** 2 * gap2, (err2 ** 0.5, gap2 ** 0.5)
