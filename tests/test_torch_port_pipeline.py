"""The slice as a whole: the port's StreamingPipeline against the JAX one.

Both run two windows (B=2) of the same in-memory stream with the same
converted weights and ``refine_gs=False``; the JAX side uses the exact
top-k and the packed kernel in interpret mode. Per-frame PSNR must agree
within 0.01 dB and the carried Gaussian counts exactly.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.stream.pipeline import StreamConfig as JStreamConfig
from igs_tpu.stream.pipeline import StreamingPipeline as JPipeline
from igs_tpu.stream.refine import RefineConfig
from igs_tpu_torch.builders import (
    build_model, build_raster_settings, build_stream_configs)
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.ops.rasterize import (
    RasterSettings, build_pairs_packed, rasterize)
from igs_tpu_torch.stream.pipeline import StreamConfig, StreamingPipeline
from tests.torch_port_common import (
    MemoryStream, flax_params, port_model, stream_items, to_torch_gaussians)

torch.set_num_threads(2)

OUT_HW = (40, 48)
BASE = dict(eval_batch_size=2, refine_gs=False, max_num=320, anchor_size=32,
            neighbor_k=4, save_images=False, depth_view_res=16)


def _gt_images(tg, n):
    """Eval views of the start Gaussians drifting along x: frames 1..n."""
    items = stream_items(n_items=1, out_hw=OUT_HW)
    c2w, fov = items[0]["c2w_output"][0], items[0]["FOV"]
    cam = Camera.from_c2w(c2w, (fov[0], fov[1]), OUT_HW, device="cpu")
    s = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                       outputs="color", max_pairs=1 << 14)
    out = []
    for i in range(n):
        shift = torch.tensor([0.01 * (i + 1), 0.0, 0.0])
        img = rasterize(tg.xyz + shift, tg.get_opacity, tg.get_scaling,
                        tg.get_rotation, cam, shs=tg.shs, valid=tg.valid,
                        settings=s)["color"]
        out.append(np.clip(img.numpy(), 0, 1))
    return out


def test_streaming_pipeline_matches_jax(tmp_path):
    jmodel, params, g = flax_params()
    tg = to_torch_gaussians(g)
    items = stream_items(n_items=4, out_hw=OUT_HW,
                         gt_images=_gt_images(tg, 4))

    js = JSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                   impl="pallas_packed", pallas_interpret=True,
                   max_pairs=1 << 14)
    jcfg = JStreamConfig(exact_knn=True, workspace=str(tmp_path / "jax"),
                         **BASE)
    want = JPipeline(jmodel, params, MemoryStream(items, g), jcfg,
                     RefineConfig(), js).run(max_batches=2)

    cfg = StreamConfig(workspace=str(tmp_path / "port"), **BASE)
    ts = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                        max_pairs=1 << 14)
    pipe = StreamingPipeline(port_model(params), MemoryStream(items, tg),
                             cfg, ts, device="cpu")
    got = pipe.run(max_batches=2)

    assert list(got["psnr"]) == list(want["psnr"]) == [
        f"frame_{i}" for i in range(4)]
    for k in want["psnr"]:
        assert np.isfinite(got["psnr"][k])
        assert abs(got["psnr"][k] - want["psnr"][k]) < 0.01, (
            got["psnr"], want["psnr"])
    assert got["points_num"] == want["points_num"]
    assert got["mask_num"] == want["mask_num"]
    assert got["overflow_events"] == want["overflow_events"] == []
    with open(os.path.join(cfg.workspace, "results.json")) as f:
        saved = json.load(f)
    assert set(saved) == set(want)


def test_frame0_calibrates_eval_and_depth_carry_budgets(tmp_path):
    """12 000 Gaussians in front of every camera give ≥ 12 000 pairs per
    view, past the 2^14 eval budget and the 2^14 depth-carry budget of a
    16² view: both grow to the next power of two over 1.5× the densest
    view, and the grown budgets render without overflow."""
    rng = np.random.RandomState(0)
    n = 12_000
    g = Gaussians.create(
        rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        np.full((n, 1), 2.0, np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        np.full((n, 3), -4.0, np.float32), np.zeros((n, 16, 3), np.float32),
        device="cpu")
    items = stream_items(n_items=2, out_hw=OUT_HW)
    batch = MemoryStream(items, g).collate(items)
    ts = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                        max_pairs=1 << 14)
    cfg = StreamConfig(workspace=str(tmp_path), **BASE)
    model = build_model({"backbone": {"feature_channels": 32}}, device="cpu")
    pipe = StreamingPipeline(model, None, cfg, ts, device="cpu")
    assert pipe.depth_settings.max_pairs == 1 << 14
    pipe._maybe_calibrate_budget(g, batch)

    for s, c2ws in ((pipe.agm_settings, batch["c2w_output"][0, :1]),
                    (pipe.depth_settings, batch["c2w_output"][0, 1:])):
        cams = Camera.stack([
            Camera.from_c2w(c2w, (0.8, 0.8), (s.image_height, s.image_width),
                            device="cpu") for c2w in c2ws])
        pairs = build_pairs_packed(g.get_xyz, g.get_opacity, g.get_scaling,
                                   g.get_rotation, cams, valid=g.valid,
                                   settings=s)
        densest = int(pairs.num_pairs.max())
        assert densest >= n and not bool(pairs.overflowed.any())
        assert s.max_pairs == 1 << math.ceil(math.log2(densest * 1.5))


def test_builders_take_the_yaml_sections():
    system = {"backbone": {"feature_channels": 32,
                           "transformer": {"num_layers": 1}},
              "triplane_encoder": {"unet": {"num_attention_heads": 2,
                                            "attention_head_dim": 16,
                                            "num_layers": 1}}}
    a = build_model(system, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    b = build_model(system, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.backbone.transformer.layers[0].self_attn.q_proj.weight.shape == (
        32, 32)
    with pytest.raises(NotImplementedError, match="bf16"):
        build_model({"ft_bf16": True}, device="cpu")
    s = build_raster_settings(1014, 1352)
    assert s.max_pairs == 1 << 21
    cfg = build_stream_configs({"refine_gs": False, "max_num": 1000})
    assert cfg.max_num == 1000 and not cfg.refine_gs
    with pytest.raises(NotImplementedError):
        build_stream_configs({"free_view": True})
    with pytest.raises(NotImplementedError, match="refine"):
        StreamingPipeline(a, None, StreamConfig(), s, device="cpu")
