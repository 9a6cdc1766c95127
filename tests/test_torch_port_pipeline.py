"""The slices as a whole: the port's StreamingPipeline against the JAX one.

Both run two windows (B=2) of the same in-memory stream with the same
converted weights; the JAX side uses the exact top-k and the packed
kernels in interpret mode. Without the refine, per-frame PSNR must agree
within 0.01 dB and the carried Gaussian counts exactly; with the
key-frame refine (keys 2 and 4, a few Adam steps each) within 0.05 dB.
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
from igs_tpu.stream.refine import RefineConfig as JRefineConfig
from igs_tpu_torch.builders import (
    build_model, build_raster_settings, build_stream_configs)
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.ops.rasterize import (
    RasterSettings, build_pairs_packed, rasterize)
from igs_tpu_torch.stream.pipeline import StreamConfig, StreamingPipeline
from igs_tpu_torch.stream.refine import RefineConfig
from tests.torch_port_common import (
    MemoryStream, flax_params, port_model, stream_items, to_torch_gaussians)

torch.set_num_threads(2)

OUT_HW = (40, 48)
BASE = dict(eval_batch_size=2, refine_gs=False, max_num=320, anchor_size=32,
            neighbor_k=4, save_images=False, depth_view_res=16)


def _frame_view(tg, frame, c2w, fov):
    """View ``c2w`` of the start Gaussians drifted along x to ``frame``."""
    cam = Camera.from_c2w(c2w, (fov[0], fov[1]), OUT_HW, device="cpu")
    s = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                       outputs="color", max_pairs=1 << 14)
    shift = torch.tensor([0.01 * frame, 0.0, 0.0])
    img = rasterize(tg.xyz + shift, tg.get_opacity, tg.get_scaling,
                    tg.get_rotation, cam, shs=tg.shs, valid=tg.valid,
                    settings=s)["color"]
    return np.clip(img.numpy(), 0, 1)


def _gt_images(tg, n):
    """Eval views of the start Gaussians drifting along x: frames 1..n."""
    items = stream_items(n_items=1, out_hw=OUT_HW)
    c2w, fov = items[0]["c2w_output"][0], items[0]["FOV"]
    return [_frame_view(tg, i + 1, c2w, fov) for i in range(n)]


def _refine_data(tg, items, keys):
    """Refine data of each key frame: its four input views."""
    it = items[0]
    return {k: {"images": [_frame_view(tg, k, c2w, it["FOV"])
                           for c2w in it["c2w_input"]],
                "c2ws": list(it["c2w_input"]), "FOV": it["FOV"],
                "bg": np.zeros(3, np.float32)} for k in keys}


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
                     JRefineConfig(), js).run(max_batches=2)

    cfg = StreamConfig(workspace=str(tmp_path / "port"), **BASE)
    ts = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                        max_pairs=1 << 14)
    pipe = StreamingPipeline(port_model(params), MemoryStream(items, tg),
                             cfg, RefineConfig(), ts, device="cpu")
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


def test_streaming_pipeline_with_refine_matches_jax(tmp_path):
    """refine_gs=True: after windows 1 and 2 (keys 2 and 4) the carried
    Gaussians take three refine steps on the key frame's four views, and
    the window's last PSNR comes from the refined Gaussians."""
    jmodel, params, g = flax_params()
    tg = to_torch_gaussians(g)
    items = stream_items(n_items=4, out_hw=OUT_HW,
                         gt_images=_gt_images(tg, 4))
    refine = _refine_data(tg, items, (2, 4))
    for it in items:
        it["radius"] = np.float32(4.4)  # the rig's radius: densify's extent
    base = dict(BASE, refine_gs=True, refine_iterations=3)

    js = JSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                   impl="pallas_packed", pallas_interpret=True,
                   max_pairs=1 << 14)
    jcfg = JStreamConfig(exact_knn=True, workspace=str(tmp_path / "jax"),
                         **base)
    want = JPipeline(jmodel, params, MemoryStream(items, g, refine), jcfg,
                     JRefineConfig(), js).run(max_batches=2)

    cfg = StreamConfig(workspace=str(tmp_path / "port"), **base)
    ts = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                        max_pairs=1 << 14)
    pipe = StreamingPipeline(port_model(params),
                             MemoryStream(items, tg, refine), cfg,
                             RefineConfig(), ts, device="cpu")
    got = pipe.run(max_batches=2)

    for k in want["psnr"]:
        assert np.isfinite(got["psnr"][k])
        assert abs(got["psnr"][k] - want["psnr"][k]) < 0.05, (
            got["psnr"], want["psnr"])
    assert got["points_num"] == want["points_num"]
    assert got["overflow_events"] == want["overflow_events"] == []
    assert [r["key"] for r in pipe.refine_log] == [2, 4]
    for r in pipe.refine_log:
        assert len(r["losses"]) == 3 and r["losses"][-1] < r["losses"][0]


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
    pipe = StreamingPipeline(model, None, cfg, RefineConfig(), ts,
                             device="cpu")
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
    # the bf16 compute flags, with the JAX precedence:
    # a flag the section sets wins over ``bf16_default``
    layer = lambda m: m.backbone.transformer.layers[0].self_attn.q_proj
    flags = lambda m: (m.backbone.backbone.conv1.compute_dtype,
                       layer(m).compute_dtype,
                       m.triplane_encoder.conv.transformer_blocks[0]
                       .attn1.dtype)
    bf16 = torch.bfloat16
    assert flags(build_model(system, device="cpu")) == (None,) * 3
    assert flags(build_model(dict(system, ft_bf16=True), device="cpu")) == (
        None, bf16, None)
    assert flags(build_model(system, device="cpu", bf16_default=True)) == (
        bf16,) * 3
    m = build_model(dict(system, cnn_bf16=False), device="cpu",
                    bf16_default=True)
    assert flags(m) == (None, bf16, bf16)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    s = build_raster_settings(1014, 1352)
    assert s.max_pairs == 1 << 21
    cfg, rcfg = build_stream_configs({"refine_gs": False, "max_num": 1000})
    assert cfg.max_num == 1000 and not cfg.refine_gs
    assert rcfg == RefineConfig()
    # every refine key that igs_tpu/builders.py reads is read
    opt = {"refine_iterations": 7, "use_densify": False,
           "training_lr": {"position_lr_init": 1e-3, "feature_lr": 2e-3,
                           "opacity_lr": 3e-2, "scaling_lr": 4e-3,
                           "rotation_lr": 5e-3},
           "lambda_l1": 0.7,
           "refine_item": {"no_shs": True, "no_opacity": True,
                           "no_scaling": True, "use_mask": True,
                           "use_new_shs": True},
           "densify_until_iter": 40, "densify_from_iter": 2,
           "densification_interval": 9, "densify_grad_threshold": 3e-4,
           "rebin_every": 4}
    cfg, rcfg = build_stream_configs(opt)
    assert cfg.refine_iterations == 7
    # densify is the refine's setting alone (JAX's StreamConfig.use_densify
    # is read by nothing)
    assert not hasattr(cfg, "use_densify")
    assert rcfg == RefineConfig(
        position_lr=1e-3, feature_lr=2e-3, opacity_lr=3e-2, scaling_lr=4e-3,
        rotation_lr=5e-3, lambda_l1=0.7, no_shs=True, no_opacity=True,
        no_scaling=True, use_mask=True, use_new_shs=True, use_densify=False,
        densify_until_iter=40, densify_from_iter=2, densification_interval=9,
        densify_grad_threshold=3e-4, rebin_every=4)
    assert not cfg.free_view
    assert build_stream_configs({"free_view": True})[0].free_view
    for key, value in (("refine_parallel", 2), ("data_parallel", 2)):
        with pytest.raises(NotImplementedError, match=key):
            build_stream_configs({key: value})


def test_eval_images_are_written_without_pil(tmp_path, monkeypatch):
    """``save_images``: the eval views go to ``eval_pred/*.png`` through
    the port's codec with PIL unavailable (the card's machine has none),
    and decode to the uint8 pixels the JAX pipeline's PIL writer makes of
    the same images."""
    import sys

    from PIL import Image

    from igs_tpu_torch.data.images import read_png
    from igs_tpu_torch.stream import pipeline as pipeline_mod

    _, params, g = flax_params()
    items = stream_items(n_items=4, out_hw=OUT_HW)
    cfg = StreamConfig(workspace=str(tmp_path), **dict(BASE,
                                                       save_images=True))
    ts = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                        max_pairs=1 << 14)
    written = {}
    save_image = pipeline_mod.save_image

    def record(path, img):
        written[os.path.basename(path)] = np.array(img)
        save_image(path, img)

    monkeypatch.setattr(pipeline_mod, "save_image", record)
    monkeypatch.setitem(sys.modules, "PIL", None)
    pipe = StreamingPipeline(port_model(params),
                             MemoryStream(items, to_torch_gaussians(g)),
                             cfg, RefineConfig(), ts, device="cpu")
    pipe.run(max_batches=2)
    monkeypatch.delitem(sys.modules, "PIL")
    names = sorted(os.listdir(tmp_path / "eval_pred"))
    assert names == [f"{i:05d}.png" for i in range(4)] == sorted(written)
    for name in names:
        # the JAX pipeline's expression on the same float image
        want = (written[name].transpose(1, 2, 0) * 255).astype(np.uint8)
        jax_png = str(tmp_path / f"pil_{name}")
        Image.fromarray(want).save(jax_png)
        got = read_png(str(tmp_path / "eval_pred" / name))
        assert got.shape == OUT_HW + (3,) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.asarray(Image.open(jax_png)), got)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "eval_pred" / name)), want)
