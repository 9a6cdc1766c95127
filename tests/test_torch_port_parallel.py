"""The port's strip rendering, its process groups and its strip-sharded
key-frame refine, against the JAX package.

  * ``rasterize(strip_row0=)`` at 2 and 4 strips against JAX's, each
    strip's maps (``test_torch_port_raster.py``'s 1e-4) and the gradients
    of a loss over the joined strips (``…_raster_grads.py``'s atol 2e-5,
    rtol 1e-3); the joined strips equal the full render bit for bit;
  * the raises: ``strip_row0`` with ``clamp_grads`` or ``pairs_override``
    (as JAX), and a height that is not a multiple of 16·n (ROADMAP C30);
  * ``parallel/distributed.py`` over two gloo ranks, as
    ``tests/test_multihost.py`` covers JAX's: the mesh, the sum,
    ``local_batch_slice``, ``all_processes_mean``;
  * ``refine_run_sharded`` on two ranks against JAX's sharded step on a
    (1, 2) mesh of the virtual CPU devices, densify firing with JAX's split
    draws fed to the port (ROADMAP C4): per-step loss within 1e-3
    relative, the same live rows, final PSNR within 0.05 dB a view (the
    rules of ``test_torch_port_refine.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.core.camera import Camera as JCamera
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.ops.rasterize import rasterize as jax_rasterize
from igs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from igs_tpu.stream import refine as jref
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.ops.rasterize import (
    RasterSettings, build_pairs_packed, rasterize)
from igs_tpu_torch.parallel import distributed as D
from igs_tpu_torch.parallel.launch import rank_plan, spawn
from igs_tpu_torch.stream import refine as tref
from tests import torch_port_parallel_ranks as ranks
from tests.conftest import random_gaussians
from tests.torch_port_common import to_torch_gaussians

torch.set_num_threads(2)
JOIN_S = 120
BG = np.float32([0.1, 0.2, 0.3])
MAPS = ("color", "alpha", "depth", "mdepth", "coord", "mcoord", "normal",
        "n_contrib")
PARAMS = ("xyz", "opacity", "scaling", "rotation", "shs")


def _w2c(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    w2c[2, 3] = 4.0
    return w2c


@pytest.mark.parametrize("nsh", [2, 4])
def test_strip_render_matches_jax(nsh):
    h, w = 64, 32
    jg = random_gaussians(n=128, seed=2).pad_to(144)
    tg = to_torch_gaussians(jg)
    jcam = JCamera.from_w2c(_w2c(0.1), 0.8, 0.8, h, w)
    tcam = Camera.from_w2c(_w2c(0.1), 0.8, 0.8, h, w, device="cpu")
    hs = h // nsh
    js = JSettings(image_height=hs, image_width=w, impl="pallas_packed",
                   pallas_interpret=True, max_pairs=1 << 12)
    ts = RasterSettings(image_height=hs, image_width=w, max_pairs=1 << 12)
    target = np.random.RandomState(3).uniform(0, 1, (3, h, w)).astype(
        np.float32)
    n = jg.xyz.shape[0]

    def jstrips(args, m2o, outputs):
        xyz, op, sc, ro, shs = args
        return [jax_rasterize(
            means3d=xyz, opacity=jax.nn.sigmoid(op), scaling=jnp.exp(sc),
            rotation=ro / jnp.linalg.norm(ro, axis=-1, keepdims=True),
            camera=jcam, shs=shs, bg=jnp.asarray(BG), means2d_offset=m2o,
            valid=jg.valid, settings=js._replace(outputs=outputs),
            strip_row0=jnp.int32(i * hs // 16)) for i in range(nsh)]

    def tstrips(args, m2o, outputs):
        xyz, op, sc, ro, shs = args
        return [rasterize(
            xyz, torch.sigmoid(op), torch.exp(sc),
            ro / torch.linalg.norm(ro, dim=-1, keepdim=True), tcam, shs=shs,
            bg=torch.from_numpy(BG), means2d_offset=m2o, valid=tg.valid,
            settings=ts._replace(outputs=outputs), strip_row0=i * hs // 16)
            for i in range(nsh)]

    jargs = tuple(getattr(jg, k) for k in PARAMS)
    targs = [getattr(tg, k).clone() for k in PARAMS]
    zeros = jnp.zeros((n, 2))
    want = jax.jit(lambda a: jstrips(a, zeros, "full"))(jargs)
    with torch.no_grad():
        got = tstrips(targs, torch.zeros((n, 2)), "full")
        full = rasterize(
            targs[0], torch.sigmoid(targs[1]), torch.exp(targs[2]),
            targs[3] / torch.linalg.norm(targs[3], dim=-1, keepdim=True),
            tcam, shs=targs[4], bg=torch.from_numpy(BG), valid=tg.valid,
            settings=ts._replace(image_height=h, outputs="color"))["color"]
    for i in range(nsh):
        for k in MAPS:
            np.testing.assert_allclose(got[i][k].numpy(),
                                       np.asarray(want[i][k]), atol=1e-4,
                                       rtol=1e-4, err_msg=f"strip {i} {k}")
    joined = torch.cat([s["color"] for s in got], dim=-2)
    torch.testing.assert_close(joined, full, atol=0, rtol=0)

    def jloss(a, m2o):
        img = jnp.concatenate([s["color"] for s in jstrips(a, m2o, "color")],
                              axis=-2)
        return jnp.mean(jnp.abs(img - target))

    wgrads = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jargs, zeros)
    targs = [a.requires_grad_(True) for a in targs]
    m2o = torch.zeros((n, 2), requires_grad=True)
    img = torch.cat([s["color"] for s in tstrips(targs, m2o, "color")], -2)
    loss = (img - torch.from_numpy(target)).abs().mean()
    ggrads = torch.autograd.grad(loss, targs + [m2o])
    for name, g_, w_ in zip(PARAMS + ("means2d_offset",), ggrads,
                            list(wgrads[0]) + [wgrads[1]]):
        assert np.isfinite(g_.numpy()).all(), name
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=2e-5,
                                   rtol=1e-3, err_msg=f"grad {name}")
    assert float(ggrads[-1].abs().sum()) > 0


def test_strip_raises_as_jax():
    g = to_torch_gaussians(random_gaussians(n=32, seed=0))
    cam = Camera.from_w2c(_w2c(0.0), 0.8, 0.8, 64, 32, device="cpu")
    s = RasterSettings(image_height=32, image_width=32, max_pairs=1 << 12)
    args = (g.xyz, g.get_opacity, g.get_scaling, g.get_rotation, cam)
    with pytest.raises(NotImplementedError, match="clamp_grads"):
        rasterize(*args, shs=g.shs, settings=s._replace(clamp_grads=True),
                  strip_row0=0)
    pairs = build_pairs_packed(*args, settings=s._replace(image_height=64))
    with pytest.raises(NotImplementedError, match="strip_row0"):
        rasterize(*args, shs=g.shs, settings=s, strip_row0=0,
                  pairs_override=pairs)
    with pytest.raises(ValueError, match="whole tiles"):
        rasterize(*args, shs=g.shs, settings=s, strip_row0=3)
    # the JAX package raises in the same two cases
    jg = random_gaussians(n=32, seed=0)
    jcam = JCamera.from_w2c(_w2c(0.0), 0.8, 0.8, 64, 32)
    js = JSettings(image_height=32, image_width=32, max_pairs=1 << 12,
                   impl="pallas_packed", pallas_interpret=True)
    jargs = dict(means3d=jg.xyz, opacity=jg.get_opacity,
                 scaling=jg.get_scaling, rotation=jg.get_rotation,
                 camera=jcam, shs=jg.shs, strip_row0=jnp.int32(0))
    with pytest.raises(NotImplementedError, match="clamp_grads"):
        jax_rasterize(**jargs, settings=js._replace(clamp_grads=True))
    with pytest.raises(NotImplementedError, match="strip_row0"):
        jax_rasterize(**jargs, settings=js, pairs_override=object())


@pytest.mark.parametrize("nsh", [2, 3, 4])
def test_strip_height_must_split_into_whole_tiles(nsh):
    """ROADMAP C30: at the N3DV height of 1014 (63 tile rows and 6 rows
    over) the port refuses every split by name. JAX refuses 2 and 4 strips
    (63 rows do not divide) and takes 3, dropping the last 6 rows."""
    s = RasterSettings(image_height=1014, image_width=1352)
    match = "not divisible" if 63 % nsh else "not a multiple of 16"
    with pytest.raises(ValueError, match=match):
        tref.strip_settings(s, nsh)
    mesh = jax_make_mesh(data=1, tile=nsh, devices=jax.devices()[:nsh])
    js = JSettings(image_height=1014, image_width=1352)
    if 63 % nsh:
        with pytest.raises(ValueError, match="not divisible"):
            jref.refine_run_sharded(None, None, None, None, None, None, js,
                                    1.0, 1, mesh)
    # the smoke's 1024 rows (64 tile rows) split in 2 and 4, not in 3
    s = s._replace(image_height=1024)
    if 64 % nsh:
        with pytest.raises(ValueError, match="not divisible"):
            tref.strip_settings(s, nsh)
    else:
        assert tref.strip_settings(s, nsh).image_height == 1024 // nsh


def test_process_groups_are_jax_free_no_ops_alone():
    """Without a cluster ``init_distributed`` does nothing (as JAX's);
    ``nccl`` without CUDA and layouts the cards cannot hold raise by
    name, and no backend is switched quietly."""
    assert D.init_distributed() is False
    assert not D.is_initialized() and D.process_count() == 1
    assert D.local_batch_slice(8) == slice(0, 8)
    assert D.all_processes_mean(3) == 3.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl"):
            D.init_distributed("file:///nonexistent/store", 1, 0)
        with pytest.raises(ValueError, match="cards"):
            rank_plan(2, None, None)
    with pytest.raises(ValueError, match="gloo"):
        rank_plan(2, "cpu", None)
    with pytest.raises(ValueError, match="gloo"):
        rank_plan(2, "cuda", "nccl", share_card=True)
    assert rank_plan(2, "cpu", "gloo") == ("gloo", ["cpu", "cpu"])
    assert rank_plan(3, "cuda:0", "gloo", share_card=True) == (
        "gloo", ["cuda:0"] * 3)


def test_init_reads_torchrun_environment(tmp_path, monkeypatch):
    """``WORLD_SIZE``/``RANK`` from the environment (as torchrun sets
    them) and a ``file://`` coordinator: a group of one, so False; the
    timeout reaches the group's subgroups."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert D.init_distributed(f"file://{tmp_path}/store",
                                  backend="gloo", timeout_s=60) is False
        assert D.is_initialized() and D.process_count() == 1
        assert torch.distributed.get_backend() == "gloo"
        assert D.group_timeout().total_seconds() == 60
        np.testing.assert_array_equal(D.all_gather(torch.arange(3)),
                                      [[0, 1, 2]])
    finally:
        D.shutdown()
    assert not D.is_initialized()


def test_collectives_over_two_processes(tmp_path):
    out = spawn(ranks.collectives, 2, backend="gloo", timeout_s=JOIN_S,
                workdir=str(tmp_path), threads=1)
    for r, o in enumerate(out):
        assert (o["count"], o["index"]) == (2, r)
        assert o["shape"] == {"data": 2, "tile": 1}
        assert o["coords"] == (r, 0)
        # ranks hold 10r + [0, 1, 2, 3]
        np.testing.assert_array_equal(o["sum"], [10, 12, 14, 16])
        np.testing.assert_array_equal(o["tile_sum"], [10, 12, 14, 16])
        np.testing.assert_array_equal(o["tile_max"], [10, 11, 12, 13])
        np.testing.assert_array_equal(o["gather"], [[True], [False]])
        assert o["slice"] == slice(4 * r, 4 * r + 4)
        assert o["mean"] == 1.5
        np.testing.assert_array_equal(o["given"], [7.0] * 3)


def _jax_sharded_step(mesh, cfg, settings, rows_local):
    """JAX's sharded refine step (``refine_run_sharded``'s loop body) as
    one shard_map'd program, so its per-step loss can be read."""
    from jax.sharding import PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    def local(st, cam, gt, bg):
        row0 = (jax.lax.axis_index("tile") * rows_local).astype(jnp.int32)
        return jref.refine_step(st, cam, gt, bg, cfg, settings,
                                strip_row0=row0, axis_name="tile")

    kw = dict(mesh=mesh, in_specs=(P(),) * 4, out_specs=P())
    try:
        fn = shard_map(local, check_vma=False, **kw)
    except TypeError:  # pragma: no cover
        fn = shard_map(local, check_rep=False, **kw)
    return jax.jit(fn)


def test_refine_run_sharded_matches_jax(tmp_path):
    hw, iters, cap = 64, 9, 320
    jg = random_gaussians(n=200, seed=4).pad_to(cap)
    tg = to_torch_gaussians(jg)
    yaws = (-0.25, 0.0, 0.3)
    jcams = [JCamera.from_w2c(_w2c(y), 0.8, 0.8, hw, hw) for y in yaws]
    rng = np.random.RandomState(5)
    ts = RasterSettings(image_height=hw, image_width=hw, outputs="color",
                        max_pairs=1 << 13)
    tcam = Camera.stack([Camera.from_w2c(_w2c(y), 0.8, 0.8, hw, hw,
                                         device="cpu") for y in yaws])
    shift = torch.from_numpy(rng.normal(0, 0.03, (cap, 3)).astype(np.float32))
    gts = np.stack([np.clip(rasterize(
        tg.get_xyz + shift, tg.get_opacity, tg.get_scaling, tg.get_rotation,
        tcam.view(i), shs=tg.shs, bg=torch.from_numpy(BG), valid=tg.valid,
        settings=ts)["color"].numpy(), 0, 1) for i in range(3)])
    order = (list(np.random.RandomState(1).permutation(3)) * 4)[:iters]
    cfg_kw = dict(densification_interval=4, densify_grad_threshold=3e-3)
    cfg, jcfg = tref.RefineConfig(**cfg_kw), jref.RefineConfig(**cfg_kw)

    mesh = jax_make_mesh(data=1, tile=2, devices=jax.devices()[:2])
    js = JSettings(image_height=hw // 2, image_width=hw, outputs="color",
                   impl="pallas_packed", pallas_interpret=True,
                   max_pairs=1 << 13)
    step = _jax_sharded_step(mesh, jcfg, js, hw // 32)
    densify = jax.jit(lambda st: jref.densify_and_prune(st, jcfg,
                                                        jnp.float32(1.0)))
    jstate = jref.init_refine_state(jg, capacity=cap)
    want, samples, live = [], [], []
    for it, v in enumerate(order):
        jstate, m = step(jstate, jcams[v], jnp.asarray(gts[v]),
                         jnp.asarray(BG))
        want.append(float(m["loss"]))
        if tref._densify_now(cfg, it):
            _, _, k2a, k2b = jax.random.split(jstate.rng, 4)
            samples.append(tuple(np.asarray(jax.random.normal(k, (cap, 3)))
                                 for k in (k2a, k2b)))
            live.append(int(jstate.gaussians.valid.sum()))
            jstate = densify(jstate)
    assert len(samples) == 2 and live[0] < int(jstate.gaussians.valid.sum())

    scene = {"gaussians": ranks.gaussians_numpy(tg), "w2c": [
        _w2c(y) for y in yaws], "hw": (hw, hw), "gts": gts, "bg": BG,
        "settings": ts}
    out = spawn(ranks.refine_sharded, 2,
                (scene, cfg_kw, order, iters, samples), backend="gloo",
                timeout_s=JOIN_S, workdir=str(tmp_path), threads=1)
    for k, v in out[0]["gaussians"].items():  # the state stays replicated
        np.testing.assert_array_equal(v, out[1]["gaussians"][k], err_msg=k)
    np.testing.assert_allclose(out[0]["losses"], want, rtol=1e-3)
    got = out[0]["gaussians"]
    np.testing.assert_array_equal(got["valid"],
                                  np.asarray(jstate.gaussians.valid))
    tgs, jgs = ranks.gaussians_from(got), jstate.gaussians
    for v in range(3):
        w_img = jax_rasterize(
            means3d=jgs.get_xyz, opacity=jgs.get_opacity,
            scaling=jgs.get_scaling, rotation=jgs.get_rotation,
            camera=jcams[v], shs=jgs.shs, bg=jnp.asarray(BG),
            valid=jgs.valid, settings=js._replace(image_height=hw))["color"]
        g_img = rasterize(tgs.get_xyz, tgs.get_opacity, tgs.get_scaling,
                          tgs.get_rotation, tcam.view(v), shs=tgs.shs,
                          bg=torch.from_numpy(BG), valid=tgs.valid,
                          settings=ts)["color"].numpy()
        psnr = lambda x: -10 * np.log10(np.mean((x - gts[v]) ** 2))
        assert abs(psnr(g_img) - psnr(np.asarray(w_img))) < 0.05
