"""Port training driver against the JAX package's: the OneCycle schedule
and one clip + AdamW update against optax, and two train steps of a tiny
AGM-Net (the ``__graft_entry__`` model, windowed route) against JAX
``make_train_step``, with the backbone trained and frozen.

Tolerances. The schedule: 1e-6 of the peak (optax evaluates in float32;
near the minimum its cos(π·pct) + 1 cancels, so a pointwise relative
error there is its own rounding). One optimizer update on the same
gradients: 1e-6 relative. The train steps run the same weights (through
``models/convert``) on the same numpy inputs; loss and metrics agree to
1e-5 relative; the clipped gradient (the first Adam moment after step 1,
over 1 − b1) to 2e-4 of each tensor's largest entry plus 1e-3 relative
(float32 reassociation through the network and the rasterizer: measured
≤ 1e-4), except in the trained backbone CNN's stem and first two stages,
whose gradients come back through every later stage's instance norm over
maps of 4×4 to 16×16 pixels: there 2e-2 (measured 1.1e-2 at most). A
1e-7 floor covers the biases an affine-free instance norm cancels (their
gradient is rounding). Updated parameters, after each step, to 2e-6
where every step so far had |g| > 1e-4 (the Adam sign trap, ROADMAP C9);
after step 2 the trained backbone to one step's learning rate
(1.12e-4): step 1 leaves its early layers ~1e-6 apart, which the
backbone's second forward carries into every later layer's gradient,
and where the two steps' gradients cancel a small gradient difference
turns Adam's second direction by up to one unit. A frozen backbone stays
bit-equal in both packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from igs_tpu.models.agm import AGMNet as JAGMNet
from igs_tpu.ops.anchors import select_anchors as jax_select_anchors
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.train import driver as jdriver
from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.models.convert import load_flax_params, state_dict_from_flax
from igs_tpu_torch.ops.anchors import AnchorState
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.train.driver import (
    OptConfig, Optimizer, make_optimizer, make_train_step, onecycle_schedule)
from tests.torch_port_common import TINY, flax_params, numpy_batch, \
    to_torch_gaussians

torch.set_num_threads(2)

HW = 32
TOTAL_STEPS = 10
# the backbone CNN's stem and first two stages: their gradients come back
# through the instance norms of every later stage
EARLY_CNN = ("backbone.backbone.conv1.", "backbone.backbone.layer1.",
             "backbone.backbone.layer2.0.")


@pytest.mark.parametrize("total,warmup", [(480, 200), (30, 3000), (7, 2),
                                          (12345, 3000)])
def test_onecycle_schedule_matches_optax(total, warmup):
    want = jdriver.onecycle_schedule(4e-4, total, warmup)
    got = onecycle_schedule(4e-4, total, warmup)
    steps = range(total + 5)
    w = np.array([float(want(jnp.int32(i))) for i in steps])
    g = np.array([got(i) for i in steps])
    assert np.abs(g - w).max() <= 1e-6 * 4e-4
    assert g.max() == pytest.approx(4e-4, rel=1e-6)


@pytest.mark.parametrize("clip", [1.0, 100.0])
@pytest.mark.parametrize("accum", [1, 2])
def test_one_update_matches_optax(clip, accum):
    """clip_by_global_norm → adamw(OneCycle), in MultiSteps when
    ``accum`` > 1, on the same parameters and gradients; the gradient
    norm passes the clip in one case and not in the other."""
    rng = np.random.RandomState(accum)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 0.3, v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2 * accum)]
    cfg = OptConfig(warmup_steps=3, gradient_clip=clip)
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.gradient_clip),
        optax.adamw(learning_rate=jdriver.onecycle_schedule(cfg.lr, 20, 3),
                    b1=cfg.beta1, b2=cfg.beta2,
                    weight_decay=cfg.weight_decay))
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = Optimizer(tp, cfg, onecycle_schedule(cfg.lr, 20, 3), accum)
    for i, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = torch.tensor(v)
        out = opt.step()
        assert out["updated"] == ((i + 1) % accum == 0)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert opt.count == len(grads) // accum


def _mu(state):
    """The Adam first moments inside an optax state, by parameter path."""
    for leaf in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf.mu
    raise KeyError("no Adam state")


def _jax_inputs():
    _, params, g = flax_params(local_ray=False)
    batches = [numpy_batch(b=2, v=2, hw=HW, out_hw=(HW, HW), seed=s)
               for s in (0, 1)]
    state = jax_select_anchors(
        g.xyz, jnp.asarray(batches[0]["bounding_box"][0]), valid=g.valid,
        anchor_size=32, k=4, exact_knn=True)
    return params, g, batches, state


def _settings():
    js = JSettings(image_height=HW, image_width=HW, impl="pallas",
                   pallas_interpret=True, max_pairs=1 << 13, max_per_tile=128,
                   chunk=64, clamp_grads=True)
    ts = RasterSettings(image_height=HW, image_width=HW, impl="pallas",
                        max_pairs=1 << 13, max_per_tile=128, chunk=64,
                        clamp_grads=True)
    return js, ts


@pytest.mark.parametrize("train_backbone", [True, False])
def test_two_train_steps_match_jax(train_backbone):
    params, g, batches, state = _jax_inputs()
    # the JAX step donates its parameters: keep a host copy for the port
    host_params = jax.tree.map(np.asarray, params)
    js, ts = _settings()
    cfg = OptConfig(warmup_steps=3, gradient_clip=0.1)
    rep = lambda x: None if x is None else jnp.stack([x] * 2)

    jmodel = JAGMNet(local_ray=False, train_backbone=train_backbone, **TINY)
    tx, _ = jdriver.make_optimizer(params, cfg, TOTAL_STEPS,
                                   train_backbone=train_backbone)
    opt_state = tx.init(params)
    step = jdriver.make_train_step(jmodel, tx, cfg, js)
    jstate, jgs = jax.tree.map(rep, state), jax.tree.map(rep, g)
    want, want_params, jparams = [], [], params
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jparams, opt_state, metrics = step(jparams, opt_state, jb, jstate,
                                           jgs)
        want.append({k: float(v) for k, v in metrics.items()})
        want_params.append(state_dict_from_flax(jparams))
        if i == 0:
            mu1 = state_dict_from_flax(jax.tree.map(
                lambda x: x / (1 - cfg.beta1), _mu(opt_state)))

    model = AGMNet(local_ray=False, train_backbone=train_backbone, **TINY)
    load_flax_params(model, host_params)
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, _ = make_optimizer(model, cfg, TOTAL_STEPS,
                                  train_backbone=train_backbone)
    tstep = make_train_step(cfg, ts)
    tstate = AnchorState(*(torch.tensor(np.asarray(x)).expand(
        (2,) + x.shape) for x in state))
    tgs = to_torch_gaussians(g).map(lambda x: x.expand((2,) + x.shape))
    got, got_params, masks = [], [], []
    for i, b in enumerate(batches):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        metrics = tstep(model, optimizer, tb, tstate, tgs)
        got.append(metrics)
        got_params.append({k: v.clone() for k, v in
                           model.state_dict().items()})
        big = {k: p.grad.abs() > 1e-4 for k, p in optimizer.params.items()
               if p.grad is not None}
        masks.append(big if i == 0 else {k: masks[-1][k] & big[k]
                                         for k in big})
        if i == 0:
            mu1_port = {k: v / (1 - cfg.beta1)
                        for k, v in optimizer.mu.items()}

    for w, m in zip(want, got):
        for k in ("loss", "loss_mse", "loss_ssim", "psnr"):
            assert float(m[k]) == pytest.approx(w[k], rel=1e-5), k
        # the 128-row window truncates dense tiles, as in the JAX step
        assert 0 < int(m["overflow_tiles"]) < 1 << 20
    assert got[0]["grad_norm"] > cfg.gradient_clip  # the clip binds

    # the clipped gradient of step 1, every trainable tensor
    trained = [k for k in mu1_port if mu1_port[k].abs().max() > 0]
    assert len(trained) > 10
    for k in mu1_port:
        w, g_ = mu1[k].numpy(), mu1_port[k].numpy()
        frac = 2e-2 if k.startswith(EARLY_CNN) else 2e-4
        np.testing.assert_allclose(g_, w, rtol=1e-3,
                                   atol=frac * float(np.abs(w).max()) + 1e-7,
                                   err_msg=k)
    for i, (sd, want_sd, mask) in enumerate(zip(got_params, want_params,
                                                masks)):
        for k, w in want_sd.items():
            if k.startswith("backbone.") and not train_backbone:
                assert torch.equal(sd[k], before[k]), k
                assert torch.equal(w, before[k]), k
                continue
            m = mask[k].numpy()
            atol = 1.2e-4 if i and k.startswith("backbone.") else 2e-6
            np.testing.assert_allclose(sd[k].numpy()[m], w.numpy()[m],
                                       rtol=0, atol=atol,
                                       err_msg=f"step {i + 1} {k}")
    if train_backbone:
        assert any(k.startswith("backbone.") for k in trained)
    else:
        assert not any(k.startswith("backbone.") for k in optimizer.params)
