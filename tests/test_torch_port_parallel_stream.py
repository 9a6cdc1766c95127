"""The streaming window over ranks: the port's data-parallel AGM forward and
its pipeline with ``data_parallel`` and ``refine_parallel`` at 2, against
the JAX package's on the virtual CPU mesh.

The port's side runs in two gloo ranks on the CPU (``parallel/launch.
spawn``, a FileStore under ``tmp_path``; the ranks' code is in
``tests/torch_port_parallel_ranks.py``). Tolerances are those of the
single-process tests: ``test_torch_port_agm.py`` for the forward (images
1e-3, deformed means 1e-5), ``test_torch_port_pipeline.py`` for the
stream (PSNR 0.01 dB a frame, 0.05 dB on the refined frames, equal
carried counts).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from igs_tpu.ops.anchors import select_anchors as jax_select_anchors
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from igs_tpu.parallel.spmd import sharded_agm_apply as jax_sharded_apply
from igs_tpu.stream.pipeline import StreamConfig as JStreamConfig
from igs_tpu.stream.pipeline import StreamingPipeline as JPipeline
from igs_tpu.stream.refine import RefineConfig as JRefineConfig
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.ops.rasterize import RasterSettings, rasterize
from igs_tpu_torch.parallel.launch import spawn
from tests import torch_port_parallel_ranks as ranks
from tests.torch_port_common import (
    TINY, MemoryStream, flax_params, numpy_batch, port_model, stream_items,
    to_torch_gaussians)

torch.set_num_threads(2)
JOIN_S = 120


def _run(fn, tmp_path, *args, n=2):
    return spawn(fn, n, args, backend="gloo", timeout_s=JOIN_S,
                 workdir=str(tmp_path / "ranks"), threads=1)


def test_sharded_agm_apply_matches_jax(tmp_path):
    """Four candidates over two ranks, the shared key frame and shared
    eval pairs applying per shard, as JAX's ``shard_map`` applies them."""
    b, out_hw = 4, (40, 48)
    jmodel, params, g = flax_params()
    batch = numpy_batch(b=b, out_hw=out_hw)
    js = JSettings(image_height=out_hw[0], image_width=out_hw[1],
                   impl="pallas_packed", pallas_interpret=True,
                   outputs="color", max_pairs=1 << 14, clamp_grads=True)
    jds = js._replace(image_height=16, image_width=16, outputs="color_depth")
    jstate = jax_select_anchors(g.xyz, jnp.asarray(batch["bounding_box"][0]),
                                valid=g.valid, anchor_size=32, k=4,
                                exact_knn=True)
    rep = lambda x: None if x is None else jnp.stack([x] * b)
    state, gs = jax.tree.map(rep, jstate), jax.tree.map(rep, g)
    mesh = jax_make_mesh(data=2, tile=1, devices=jax.devices()[:2])
    kw = dict(shared_cur=True, shared_window_pairs=True)
    want = jax_sharded_apply(jmodel, js, jds, mesh, **kw)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, state, gs)

    ts = RasterSettings(image_height=out_hw[0], image_width=out_hw[1],
                        outputs="color", max_pairs=1 << 14, clamp_grads=True)
    tds = ts._replace(image_height=16, image_width=16, outputs="color_depth")
    npy = lambda t: jax.tree.map(np.asarray, t)
    gfields = {k: np.asarray(getattr(gs, k)) for k in (
        "xyz", "opacity", "rotation", "scaling", "shs", "valid")}
    got = _run(ranks.agm_sharded, tmp_path,
               port_model(params).state_dict(), TINY, batch,
               tuple(npy(x) for x in state), gfields, ts, tds, kw)
    for k in got[0]:  # the gathered outputs are the same on both ranks
        for a, c in zip(jax.tree.leaves(got[0][k]), jax.tree.leaves(got[1][k])):
            np.testing.assert_array_equal(a, c, err_msg=k)
    got = got[0]
    np.testing.assert_allclose(got["3dgs"]["xyz"],
                               np.asarray(want["3dgs"].xyz), atol=1e-5)
    np.testing.assert_allclose(got["3dgs"]["rotation"],
                               np.asarray(want["3dgs"].rotation), atol=1e-5)
    for k in ("images_pred", "depth_pred"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-3,
                                   err_msg=k)
    np.testing.assert_allclose(got["pair_drift_frac"],
                               np.asarray(want["pair_drift_frac"]))
    np.testing.assert_array_equal(got["overflow_tiles"],
                                  np.asarray(want["overflow_tiles"]))


OUT_HW = (64, 48)  # four tile rows: two a strip


def _frame_view(tg, frame, c2w, fov):
    cam = Camera.from_c2w(c2w, (fov[0], fov[1]), OUT_HW, device="cpu")
    s = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                       outputs="color", max_pairs=1 << 14)
    shift = torch.tensor([0.01 * frame, 0.0, 0.0])
    return np.clip(rasterize(tg.xyz + shift, tg.get_opacity, tg.get_scaling,
                             tg.get_rotation, cam, shs=tg.shs, valid=tg.valid,
                             settings=s)["color"].numpy(), 0, 1)


def test_parallel_pipeline_matches_jax(tmp_path):
    """Two windows of B=2 with ``data_parallel`` 2 and ``refine_parallel``
    2 (three refine steps at keys 2 and 4, each rank rendering a strip of
    two tile rows), against the JAX pipeline with the same two settings;
    both ranks hold the same results and only rank 0 writes."""
    jmodel, params, g = flax_params()
    tg = to_torch_gaussians(g)
    first = stream_items(n_items=1, out_hw=OUT_HW)[0]
    c2w, fov = first["c2w_output"][0], first["FOV"]
    items = stream_items(n_items=4, out_hw=OUT_HW, gt_images=[
        _frame_view(tg, i + 1, c2w, fov) for i in range(4)])
    for it in items:
        it["radius"] = np.float32(4.4)
    refine = {k: {"images": [_frame_view(tg, k, c, fov)
                             for c in first["c2w_input"]],
                  "c2ws": list(first["c2w_input"]), "FOV": fov,
                  "bg": np.zeros(3, np.float32)} for k in (2, 4)}
    base = dict(eval_batch_size=2, refine_gs=True, refine_iterations=3,
                max_num=320, anchor_size=32, neighbor_k=4, save_images=False,
                depth_view_res=16, data_parallel=2, refine_parallel=2)
    js = JSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                   impl="pallas_packed", pallas_interpret=True,
                   max_pairs=1 << 14)
    jcfg = JStreamConfig(exact_knn=True, workspace=str(tmp_path / "jax"),
                         **base)
    want = JPipeline(jmodel, params, MemoryStream(items, g, refine), jcfg,
                     JRefineConfig(), js).run(max_batches=2)

    ts = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                        max_pairs=1 << 14)
    gfields = {k: np.asarray(getattr(g, k)) for k in (
        "xyz", "opacity", "rotation", "scaling", "shs", "valid")}
    out = _run(ranks.stream_run, tmp_path, port_model(params).state_dict(),
               TINY, items, gfields, refine, base, ts,
               str(tmp_path / "port"))
    assert [o["writer"] for o in out] == [True, False]
    assert (tmp_path / "port" / "results.json").exists()
    assert out[0]["results"]["psnr"] == out[1]["results"]["psnr"]
    got = out[0]["results"]
    assert list(got["psnr"]) == list(want["psnr"]) == [
        f"frame_{i}" for i in range(4)]
    for i, (k, w) in enumerate(want["psnr"].items()):
        tol = 0.05 if i % 2 else 0.01  # frames 1 and 3 are re-rendered
        assert abs(got["psnr"][k] - w) < tol, (got["psnr"], want["psnr"])
    assert got["points_num"] == want["points_num"]
    assert got["mask_num"] == want["mask_num"]
    assert got["overflow_events"] == want["overflow_events"] == []
    logs = out[0]["refine_log"]
    assert len(logs) == 2 and all(len(r["losses"]) == 3 for r in logs)
    assert [r["losses"] for r in logs] == [
        r["losses"] for r in out[1]["refine_log"]]
