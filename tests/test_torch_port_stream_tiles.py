"""A stream window with its key-frame refine on ``impl="tiles"``: the
port's ``StreamingPipeline`` against the JAX one on the same route (the
JAX CLI's default off a TPU), same converted weights, same in-memory
stream."""

import numpy as np
import torch

from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.stream.pipeline import StreamConfig as JStreamConfig
from igs_tpu.stream.pipeline import StreamingPipeline as JPipeline
from igs_tpu.stream.refine import RefineConfig as JRefineConfig
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.stream.pipeline import StreamConfig, StreamingPipeline
from igs_tpu_torch.stream.refine import RefineConfig
from tests.torch_port_common import (
    MemoryStream, flax_params, port_model, stream_items, to_torch_gaussians)

torch.set_num_threads(2)


def test_stream_window_on_tiles_matches_jax(tmp_path):
    """Two windows (B=2) with a three-step key-frame refine after each, on
    ``impl="tiles"`` in both packages: the AGM renders and the depth carry
    ask for full outputs, the refine renders full through autograd, and
    the pair budgets are not calibrated (the JAX package calibrates the
    kernel routes only). PSNR within 0.05 dB, as the packed stream's."""
    hw = (40, 48)
    jmodel, params, g = flax_params()
    tg = to_torch_gaussians(g)
    items = stream_items(n_items=4, out_hw=hw)
    rng = np.random.RandomState(3)
    refine = {k: {"images": list(rng.uniform(0, 1, (4, 3) + hw).astype(
                      np.float32)),
                  "c2ws": list(items[0]["c2w_input"]),
                  "FOV": items[0]["FOV"], "bg": np.zeros(3, np.float32)}
              for k in (2, 4)}
    for it in items:
        it["radius"] = np.float32(4.4)
    base = dict(eval_batch_size=2, refine_gs=True, refine_iterations=3,
                max_num=320, anchor_size=32, neighbor_k=4, save_images=False,
                depth_view_res=16)
    s = dict(image_height=hw[0], image_width=hw[1], impl="tiles",
             max_pairs=1 << 14, max_per_tile=256, chunk=64)
    jpipe = JPipeline(jmodel, params, MemoryStream(items, g, refine),
                      JStreamConfig(exact_knn=True,
                                    workspace=str(tmp_path / "jax"), **base),
                      JRefineConfig(), JSettings(**s))
    want = jpipe.run(max_batches=2)
    pipe = StreamingPipeline(port_model(params),
                             MemoryStream(items, tg, refine),
                             StreamConfig(workspace=str(tmp_path / "port"),
                                          **base),
                             RefineConfig(), RasterSettings(**s),
                             device="cpu")
    got = pipe.run(max_batches=2)

    for ours, theirs in ((pipe.agm_settings, jpipe.agm_settings),
                         (pipe.depth_settings, jpipe.depth_settings),
                         (pipe.refine_settings, jpipe.refine_settings)):
        assert ours.outputs == theirs.outputs == "full"
        assert (ours.max_pairs, ours.max_per_tile) == (
            theirs.max_pairs, theirs.max_per_tile)
    for k in want["psnr"]:
        assert abs(got["psnr"][k] - want["psnr"][k]) < 0.05, (
            got["psnr"], want["psnr"])
    assert got["points_num"] == want["points_num"]
    assert got["overflow_events"] == want["overflow_events"]
    assert [r["key"] for r in pipe.refine_log] == [2, 4]
