"""The measurement path against the JAX package: ``calibrate_pair_budget``
and ``pairs_to_idx_table`` exactly, ``utils/profiling`` file for file, and
``bench``, ``roofline.run``, ``profile_stages.run`` and the two segscan
tools on the CPU at tiny sizes, emitting the JAX programs' keys and
lines. Stage timings of roofline and profile_stages use
``timeit_device`` with K=0 and one timed round, so every stage runs with
its salted arguments but briefly."""

import json
import os
import pathlib
import re
import threading

import numpy as np
import pytest
import torch

from igs_tpu.ops.binning import build_tile_pairs as jax_build_pairs
from igs_tpu.ops.projection import project as jax_project
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.ops.rasterize import calibrate_pair_budget as jax_calibrate
from igs_tpu.ops.render_tiles import pairs_to_idx_table as jax_idx_table
from igs_tpu.utils import profiling as jax_profiling
from igs_tpu_torch import bench, profile_stages, roofline
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.ops.binning import build_tile_pairs
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.ops.rasterize import (
    RasterSettings, calibrate_pair_budget)
from igs_tpu_torch.ops.render_tiles import pairs_to_idx_table
from igs_tpu_torch.tools import bench_segscan_fold, bench_segscan_kernel
from igs_tpu_torch.utils import devtime, profiling
from tests.conftest import make_camera
from tests.test_torch_port_raster import H, W, _args, _scene

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY_SYSTEM = {
    "backbone": {"feature_channels": 32, "transformer": {"num_layers": 1}},
    "transformer": {"num_layers": 1},
    "triplane_encoder": {"unet": {"num_attention_heads": 2,
                                  "attention_head_dim": 16,
                                  "num_layers": 1}},
}


def _jax_keys(script):
    """The result keys a JAX script writes (``results["..."] =``)."""
    text = (ROOT / script).read_text()
    return set(re.findall(r'results\["([\w/]+)"\]\s*=', text))


def _jax_labels(script):
    """The labels of a JAX tool's printed lines, lane counts filled in."""
    text = (ROOT / script).read_text()
    labels = re.findall(
        r'print\(f"([^:{]+(?:\{lanes\})?[^:{]*): \{t\*1e3', text)
    return {lab.replace("{lanes}", str(n)) for lab in labels
            for n in ((16, 32) if "{lanes}" in lab else (None,))}


@pytest.fixture
def brief_timer(monkeypatch):
    def brief(fn, *args, K=8, iters=3, salt_scale=1e-9, reducer="median"):
        return devtime.timeit_device(fn, *args, K=0, iters=1,
                                     salt_scale=salt_scale)

    for mod in (roofline, profile_stages):
        monkeypatch.setattr(mod, "timeit_device", brief)


# -- calibrate_pair_budget, pairs_to_idx_table ---------------------------


@pytest.mark.parametrize("max_pairs,quantum", [(1 << 14, 32768),
                                               (1 << 14, 64), (256, 64)])
def test_calibrate_pair_budget_matches_jax(max_pairs, quantum):
    """64² view of a seeded scene: the same (max_pairs, measured) with
    the cap binding or not and the quantum coarse or fine."""
    jg, tg, _, _ = _scene(seed=5, n=400)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 4.0
    jcam = make_camera(64, 64)
    tcam = Camera.from_w2c(w2c, 0.8, 0.8, height=64, width=64, device="cpu")
    js, jm = jax_calibrate(
        jg.get_xyz, jg.get_opacity, jg.get_scaling, jg.get_rotation, jcam,
        valid=jg.valid, quantum=quantum,
        settings=JSettings(image_height=64, image_width=64,
                           impl="pallas_packed", max_pairs=max_pairs))
    ts, tm = calibrate_pair_budget(
        tg.get_xyz, tg.get_opacity, tg.get_scaling, tg.get_rotation, tcam,
        valid=tg.valid, quantum=quantum,
        settings=RasterSettings(image_height=64, image_width=64,
                                max_pairs=max_pairs))
    assert (ts.max_pairs, tm) == (js.max_pairs, jm)
    assert tm > 0


@pytest.mark.parametrize("max_per_tile", [4, 64])
def test_pairs_to_idx_table_matches_jax(max_per_tile):
    """On the same pairs (binning is exact), truncating tiles or not."""
    jg, tg, jcam, tcam = _scene(seed=3)
    jp = jax_project(**_args(jg), camera=jcam, shs=jg.shs, valid=jg.valid)
    tp = project(tg.get_xyz, tg.get_scaling, tg.get_rotation,
                 tg.get_opacity, tcam, shs=tg.shs, valid=tg.valid)
    gx, gy = (W + 15) // 16, (H + 15) // 16
    want = jax_idx_table(jax_build_pairs(jp, gx, gy, 1 << 14), max_per_tile)
    got = pairs_to_idx_table(build_tile_pairs(tp, gx, gy, 1 << 14),
                             max_per_tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- utils/profiling ------------------------------------------------------


def test_jsonl_logger_writes_the_jax_lines(tmp_path):
    for mod, name in ((jax_profiling, "jax"), (profiling, "port")):
        log = mod.JsonlLogger(str(tmp_path / name / "log.jsonl"))
        log.log(1, loss=0.5, psnr=np.float32(20.25))
        log.log(2, loss=torch.tensor(0.25) if mod is profiling else 0.25)
    assert ((tmp_path / "port" / "log.jsonl").read_text()
            == (tmp_path / "jax" / "log.jsonl").read_text())


def test_step_timer_summary_keys_match_jax():
    timers = (jax_profiling.StepTimer(), profiling.StepTimer())
    assert timers[0].summary().keys() == timers[1].summary().keys()
    for t in timers:
        for _ in range(3):
            with t.measure() as out:
                out["result"] = torch.ones(2) if t is timers[1] else None
    s0, s1 = (t.summary() for t in timers)
    assert s0.keys() == s1.keys() and s1["count"] == 3
    assert s1["total_s"] >= s1["median_s"] >= 0


def test_nonfinite_dump_writes_the_jax_npz(tmp_path):
    arrays = {"a": np.float32([1.0, np.nan]), "ids": np.int32([1, 2])}
    assert jax_profiling.debug_dump_on_nonfinite(str(tmp_path / "jax"), "t",
                                                 **arrays)
    assert profiling.debug_dump_on_nonfinite(
        str(tmp_path / "port"), "t",
        **{k: torch.from_numpy(v) for k, v in arrays.items()})
    want = np.load(tmp_path / "jax" / "snapshot_t.npz")
    got = np.load(tmp_path / "port" / "snapshot_t.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
    assert not profiling.debug_dump_on_nonfinite(
        str(tmp_path / "finite"), "t", a=torch.ones(2))
    assert not (tmp_path / "finite").exists()


def test_trace_memory_stats_and_launch_counts(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    # no card here: neither package reports a device
    assert profiling.device_memory_stats() == {}
    assert jax_profiling.device_memory_stats() == {}
    launches = profiling.kernel_launches()
    assert {"blend_fwd_packed/color", "blend_bwd_packed/full",
            "blend_fwd_win/full", "segmented_scan",
            "count_contributions_packed", "segscan_fold/copy_folded",
            "segscan_fold/copy_padded", "segscan_fold/reshape",
            "attention_fwd", "attention_bwd"} <= set(
                launches)
    assert all(isinstance(v, int) for v in launches.values())


# -- the programs, tiny, on the CPU ----------------------------------------


def test_bench_emits_the_jax_line_and_cancels_its_watchdog(monkeypatch):
    res = bench.run("cpu", n=300, hw=32, K=1, iters=1)
    assert {"metric", "value", "unit", "vs_baseline"} <= set(res)
    assert res["metric"] == "rasterize_fwd_bwd_mpix_per_s_32"
    assert res["device"] == "cpu" and res["value"] > 0
    assert res["max_pairs"] == 32768 and res["measured_pairs"] > 0
    assert bench.metric_name(512) == "rasterize_fwd_bwd_mpix_per_s_512"

    def fail(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(bench, "run", fail)
    with pytest.raises(RuntimeError, match="boom"):
        bench.main(["--device", "cpu"])
    for t in threading.enumerate():
        if isinstance(t, threading.Timer):
            t.join(timeout=5)
            assert not t.is_alive()


def test_roofline_run_emits_the_jax_keys(brief_timer):
    res = roofline.run(n_gaussians=300, anchors=32, res=32, batch=2,
                       refine_iters=3, depth_res=16, f32=True, device="cpu",
                       hw=32, system=TINY_SYSTEM)
    want = _jax_keys("roofline.py") - {"config"}
    assert want <= set(res), want - set(res)
    assert res["device"] == "cpu"
    for k in want:
        assert np.isfinite(res[k]) and res[k] > 0, k
    assert res["stream_fps"] == pytest.approx(2 / (
        res["anchors_s"] + res["agm_forward_s"] + res["refine_loop_s"]))


def test_roofline_runs_on_the_tiles_route(brief_timer):
    """``--impl tiles``, as the JAX script takes it: every stage renders
    through the oracle (the refine and the AGM renders in color mode,
    whose planes the tiles route reads as zeros)."""
    res = roofline.run(n_gaussians=300, anchors=32, res=32, batch=2,
                       refine_iters=2, depth_res=16, f32=True, device="cpu",
                       hw=32, system=TINY_SYSTEM, impl="tiles")
    for k in _jax_keys("roofline.py") - {"config"}:
        assert np.isfinite(res[k]) and res[k] > 0, k


def test_roofline_refuses_bf16_and_the_tpu_file(brief_timer):
    # bf16 is roofline's default, as in the JAX script; only
    # the TPU's file is refused
    res = roofline.run(n_gaussians=300, anchors=32, res=32, batch=2,
                       refine_iters=2, depth_res=16, device="cpu", hw=32,
                       system=TINY_SYSTEM)
    assert np.isfinite(res["agm_forward_s"]) and res["agm_forward_s"] > 0
    with pytest.raises(SystemExit):
        roofline.main(["--f32", "--device", "cpu", "--out",
                       str(ROOT / "roofline.json")])
    assert roofline.DEFAULT_OUT.startswith(os.path.join("logs",
                                                        "igs_tpu_torch"))


def test_profile_stages_emits_the_jax_keys(brief_timer):
    res = profile_stages.run(n_gaussians=300, res=32, batch=2, device="cpu",
                             hw=32, anchors=32, depth_res=16,
                             system=TINY_SYSTEM)
    want = _jax_keys("profile_stages.py")
    assert set(res) == want
    assert all(np.isfinite(v) and v > 0 for v in res.values())
    # --cnn-bf16: the same keys
    res = profile_stages.run(what="agm", n_gaussians=300, res=32, batch=2,
                             device="cpu", hw=32, anchors=32, depth_res=16,
                             system=TINY_SYSTEM, cnn_bf16=True)
    assert set(res) == {k for k in want if k.startswith("agm/")}


def test_segscan_tools_print_the_jax_lines(capsys):
    fold = bench_segscan_fold.run("cpu", mp=4096, K=1, iters=1)
    kern = bench_segscan_kernel.run("cpu", n=300, mp=1024, K=1, iters=1)
    assert _jax_labels("tools/tools_bench_segscan_fold.py") | {
        "torch.mul(x, 2.0)"} == set(fold)
    assert _jax_labels("tools/tools_bench_segscan_kernel.py") == set(kern)
    printed = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in printed] == list(fold) + list(
        kern)
    assert all(v > 0 for v in list(fold.values()) + list(kern.values()))


def test_roofline_reports_the_calibrated_depth_carry_forward(brief_timer):
    """ROADMAP C6: at a 16² depth-carry view the JAX formula's budget is
    2^14 pairs, which 40 000 Gaussians overflow; the forward at the
    budget the pipeline's frame-0 calibration chooses does not."""
    res = roofline.run(n_gaussians=40_000, anchors=32, res=32, batch=2,
                       refine_iters=1, depth_res=16, f32=True, device="cpu",
                       hw=32, system=TINY_SYSTEM)
    assert res["depth_max_pairs"] == 1 << 14
    assert res["agm_overflow_tiles"] > 0
    assert res["depth_max_pairs_calibrated"] > res["depth_max_pairs"]
    assert res["agm_overflow_tiles_calibrated"] == 0
    assert np.isfinite(res["agm_forward_calibrated_s"])
    assert res["agm_forward_calibrated_s"] > 0
