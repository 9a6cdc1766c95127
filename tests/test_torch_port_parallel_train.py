"""Training over ranks: the port's data-parallel train step against the JAX
package's ``make_train_step(mesh=)``, and the data-parallel ``train_agm``
CLI at world size 2.

The port's side runs in two gloo ranks on the CPU, each on its item of a
batch of 2 (``tests/torch_port_parallel_ranks.py``); the JAX step shards
the batch over a (2, 1) mesh of the virtual CPU devices and lets its
compiler place the gradient psum. The bounds are C18's
(``test_torch_port_train.py``, frozen backbone): loss and losses to 1e-5
relative, the clipped gradient of step 1 to 2e-4 of each tensor's largest
entry plus 1e-3 relative, the parameters after each step to 2e-6 where
every step so far had |g| > 1e-4 (the Adam sign trap). The PSNR metric is
the mean of the ranks' PSNRs, not the PSNR of the mean error, so it is
only held to be finite.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from igs_tpu.models.agm import AGMNet as JAGMNet
from igs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from igs_tpu.parallel.mesh import shard_batch as jax_shard_batch
from igs_tpu.train import driver as jdriver
from igs_tpu_torch import train_agm
from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.models.convert import load_flax_params, state_dict_from_flax
from igs_tpu_torch.parallel.launch import spawn
from igs_tpu_torch.train.driver import OptConfig
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_train import _jax_inputs, _mu, _settings
from tests.torch_port_common import TINY

torch.set_num_threads(2)
JOIN_S = 120
TOTAL_STEPS = 10


def test_data_parallel_train_steps_match_jax(tmp_path):
    params, g, batches, state = _jax_inputs()
    host_params = jax.tree.map(np.asarray, params)
    js, ts = _settings()
    cfg = OptConfig(warmup_steps=3, gradient_clip=0.1)
    rep = lambda x: None if x is None else jnp.stack([x] * 2)

    mesh = jax_make_mesh(data=2, tile=1, devices=jax.devices()[:2])
    jmodel = JAGMNet(local_ray=False, **TINY)
    tx, _ = jdriver.make_optimizer(params, cfg, TOTAL_STEPS)
    opt_state = tx.init(params)
    step = jdriver.make_train_step(jmodel, tx, cfg, js, mesh=mesh)
    jstate = jax_shard_batch(mesh, jax.tree.map(rep, state))
    jgs = jax_shard_batch(mesh, jax.tree.map(rep, g))
    want, want_params, jparams = [], [], params
    for i, b in enumerate(batches):
        jb = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in b.items()})
        jparams, opt_state, metrics = step(jparams, opt_state, jb, jstate,
                                           jgs)
        want.append({k: float(v) for k, v in metrics.items()})
        want_params.append(state_dict_from_flax(jparams))
        if i == 0:
            mu1 = state_dict_from_flax(jax.tree.map(
                lambda x: x / (1 - cfg.beta1), _mu(opt_state)))

    model = AGMNet(local_ray=False, **TINY)
    load_flax_params(model, host_params)
    gfields = {k: np.stack([np.asarray(getattr(g, k))] * 2) for k in (
        "xyz", "opacity", "rotation", "scaling", "shs", "valid")}
    out = spawn(ranks.train_steps, 2,
                (model.state_dict(), dict(TINY, local_ray=False), cfg, ts,
                 batches, tuple(np.stack([np.asarray(x)] * 2) for x in state),
                 gfields, TOTAL_STEPS),
                backend="gloo", timeout_s=JOIN_S, workdir=str(tmp_path),
                threads=1)
    # the ranks hold the same parameters after every step
    for a, b in zip(out[0]["params"], out[1]["params"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got = out[0]
    for w, m in zip(want, got["metrics"]):
        for k in ("loss", "loss_mse", "loss_ssim"):
            assert abs(m[k] - w[k]) <= 1e-5 * abs(w[k]), (k, m[k], w[k])
        assert np.isfinite(m["psnr"])
        assert 0 < int(m["overflow_tiles"]) < 1 << 20
    assert got["metrics"][0]["grad_norm"] > cfg.gradient_clip
    trained = [k for k, v in got["mu1"].items() if np.abs(v).max() > 0]
    assert len(trained) > 10
    for k, g_ in got["mu1"].items():
        w = mu1[k].numpy()
        np.testing.assert_allclose(g_, w, rtol=1e-3,
                                   atol=2e-4 * float(np.abs(w).max()) + 1e-7,
                                   err_msg=k)
    for i, (sd, want_sd, mask) in enumerate(zip(got["params"], want_params,
                                                got["masks"])):
        for k, w in want_sd.items():
            if k.startswith("backbone."):  # frozen: bit-equal
                np.testing.assert_array_equal(sd[k], w.numpy(), err_msg=k)
                continue
            np.testing.assert_allclose(sd[k][mask[k]], w.numpy()[mask[k]],
                                       rtol=0, atol=2e-6,
                                       err_msg=f"step {i + 1} {k}")


def test_frame0_sweep_matches_jax(tmp_path):
    """``build_frame0.train_frames_spmd``, two 32×32 frames over two ranks
    (a frame each), against JAX's ``sweep_run``/``sweep_compress`` on both
    frames at once: 12 training steps on a schedule shortened so that
    densify fires at steps 4 and 8 and the opacity resets at 10 (a reset
    just before a densify would prune every row), the 45 % prune and 12
    fine-tune steps, the view orders of the JAX sweep's ``RandomState(0)``,
    and JAX's split draws fed to the port's densify (ROADMAP C4). The JAX
    sweep renders through its XLA tile renderer and the port through its
    packed route (C28), as their builds do: the live rows must agree after
    training, after the prune and in the exported PLY, and each exported
    view's PSNR within 0.05 dB of JAX's final render's (the rule of
    ``test_torch_port_build_frame0.py``)."""
    import build_frame0 as jax_build
    from igs_tpu.ops.rasterize import RasterSettings as JSettings
    from igs_tpu.ops.rasterize import rasterize as jax_rasterize
    from igs_tpu.stream.refine import init_refine_state as jinit
    from igs_tpu.train import frame0 as jf0
    from igs_tpu.train import frame0_sweep as jsw
    from igs_tpu_torch.data.images import load_images_nchw
    from igs_tpu_torch.data.ply import read_ply_vertices
    from igs_tpu_torch.train.frame0 import Frame0Config
    from tests.test_torch_port_build_frame0 import _write_frame

    dirs = [str(tmp_path / f"colmap_{i}") for i in range(2)]
    for i, d in enumerate(dirs):
        _write_frame(d, seed=i)
    cap, iters, ft = 96, 12, 12
    sched = dict(iterations=iters, densify_from_iter=2,
                 densification_interval=4, densify_until_iter=10,
                 opacity_reset_interval=10)
    jcfg, cfg = jf0.Frame0Config(**sched), Frame0Config(**sched)
    loaded = [jax_build._load_frame(d, "images_512", 0) for d in dirs]
    stack = lambda xs: jax.tree.map(lambda *x: jnp.stack(x), *xs)
    js = JSettings(image_height=32, image_width=32, impl="tiles",
                   max_pairs=1 << 12, max_per_tile=256, pallas_interpret=True)
    states = stack([jinit(jf0.create_from_points(p, c, cap), cap)
                    for _, _, _, p, c in loaded])
    cams = stack([stack(c) for _, c, _, _, _ in loaded])
    images = jnp.stack([jnp.asarray(im) for _, _, im, _, _ in loaded])
    spatial = jnp.asarray([float(np.linalg.norm(np.array(
        [c["position"] for c in cj]).std(0)) + 1.0) for cj, *_ in loaded])
    filts = jax.vmap(jsw.compute_3d_filter_stacked)(
        states.gaussians.xyz, states.gaussians.valid, cams)
    rng = np.random.RandomState(0)

    def orders(n):  # the JAX sweep's (build_frame0.train_frames_spmd)
        per = []
        for _ in dirs:
            o = []
            while len(o) < n:
                o.extend(rng.permutation(2).tolist())
            per.append(o[:n])
        return per

    train_orders, ft_orders = orders(iters), orders(ft)
    states, filts = jax.jit(lambda st, fl: jsw.sweep_run(
        st, cams, images, fl, jnp.asarray(train_orders), jcfg, js, spatial,
        iters))(states, filts)
    n_train = [int(v) for v in states.gaussians.valid.sum(1)]
    gs = jax.jit(lambda st, fl: jsw.sweep_compress(
        st, cams, fl, js, 0.45))(states, filts)
    n_prune = [int(v) for v in gs.valid.sum(1)]
    states = jax.vmap(lambda g: jinit(g, cap))(gs)
    states, filts = jax.jit(lambda st, fl: jsw.sweep_run(
        st, cams, images, fl, jnp.asarray(ft_orders), jcfg, js, spatial, ft,
        start_iter=iters, densify=False))(states, filts)
    # every frame's state starts from PRNGKey(0): its k-th densify splits
    # the same keys
    key, samples = jax.random.PRNGKey(0), []
    for _ in range(2):
        key, _, k2a, k2b = jax.random.split(key, 4)
        samples.append(tuple(np.asarray(jax.random.normal(k, (cap, 3)))
                             for k in (k2a, k2b)))

    out = spawn(ranks.frame0_sweep, 2,
                (dirs, cfg, samples, cap, 0.45, ft, 1 << 12),
                backend="gloo", timeout_s=JOIN_S, workdir=str(tmp_path / "r"),
                threads=1)
    got = out[0]
    assert out[1] == got  # every rank returns every frame's record
    assert [r["frame_dir"] for r in got] == dirs
    assert [r["rank"] for r in got] == [0, 1]
    assert [r["view_order"] for r in got] == [
        t + f for t, f in zip(train_orders, ft_orders)]
    assert [r["n_after_train"] for r in got] == n_train
    assert [r["n_after_prune"] for r in got] == n_prune
    assert n_train[0] > loaded[0][3].shape[0]  # densify added rows
    psnr = lambda x, im: -10 * np.log10(np.mean((np.clip(x, 0, 1) - im) ** 2))
    for f, r in enumerate(got):
        jg = jax.tree.map(lambda x: x[f], states.gaussians)
        assert r["n_final"] == int(jg.valid.sum())
        assert len(read_ply_vertices(r["export"]["ply"])) == r["n_final"]
        jscales, jop = jf0.fused_render_args(jg, filts[f])
        for v, (jcam, im) in enumerate(zip(loaded[f][1], loaded[f][2])):
            want = np.asarray(jax_rasterize(
                means3d=jg.xyz, opacity=jop, scaling=jscales,
                rotation=jg.get_rotation, camera=jcam, shs=jg.shs,
                valid=jg.valid, settings=js)["color"])
            exported = load_images_nchw([os.path.join(
                r["export"]["train_dir"], "gt", f"{v:05d}.png")], 32, 32)[0]
            assert abs(psnr(exported, im) - psnr(want, im)) < 0.05, (f, v)


def test_bench_scaling_at_one_and_two_ranks(tmp_path):
    """``python -m igs_tpu_torch.bench_scaling`` on the CPU, shrunk: both
    measurements at 1 and 2 gloo ranks, in the JAX script's JSON schema."""
    from igs_tpu_torch import bench_scaling

    out = str(tmp_path / "bench_scaling.json")
    bench_scaling.main(["--what", "all", "--hw", "32", "--n-gaussians",
                        "256", "--anchors", "16", "--iters", "1",
                        "--max-ranks", "2", "--device", "cpu", "--backend",
                        "gloo", "--out", out])
    with open(out) as f:
        res = json.load(f)
    assert sorted(res) == ["1", "2", "refine_1", "refine_2"]
    for c in ("1", "2"):
        assert set(res[c]) == {"sec_per_step", "scenes_per_sec",
                               "per_device", "efficiency"}
        assert res[c]["scenes_per_sec"] == float(c) / res[c]["sec_per_step"]
    assert res["1"]["efficiency"] == res["refine_1"]["speedup"] == 1.0
    assert all(np.isfinite(v) and v > 0 for r in res.values()
               for v in r.values())
