"""The rasterizer, refine and AGM-Net probes of ``igs_tpu_torch/tools/``
(the counterparts of the JAX package's ``tools/`` probes), each run
through its ``main([...])`` on the CPU at a tiny shape (the plain
versions; a few hundred to 2 000 Gaussians, at most 32² renders or 64²
AGM inputs at 32 channels, 80-token attention, at most two steps or
timing calls, two threads), reading back the JSON it writes: its keys,
finite timings, no kernel launch on the CPU, and the checks the probe
holds.
Also: the binning probes' composition of ``ops/binning.py``'s stages
gives ``build_tile_pairs``'s pairs exactly, and the bench_expand
constructions agree where the JAX probe says they do."""

import json
import math
import pathlib

import numpy as np
import pytest
import torch

from igs_tpu_torch.bench import camera, scene
from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
from igs_tpu_torch.tools import (bench_agm_bf16, bench_agm_plucker,
                                 bench_attn, bench_attn2, bench_binning,
                                 bench_blend, bench_expand, bench_parts,
                                 bench_segred, bench_segred_ab,
                                 bench_segred_loop, bench_binning2,
                                 bench_binning3, bench_refine_loop,
                                 bench_swin, packed_test, precision_check,
                                 profile_agm_diff, profile_bin_ablate,
                                 profile_raster, profile_refine_ablate,
                                 sweep)



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for this file's probes only; the count the
    session had is put back after them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


SMALL = ["--device", "cpu", "--n", "600", "--res", "32"]
TIMED = ["--K", "1", "--iters", "1"]
LOOP = ["--device", "cpu", "--n", "400", "--res", "32", "--steps", "2",
        "--views", "2", "--max-pairs", "2048", *TIMED]
ATTN = ["--device", "cpu", "--shape", "1", "2", "80", "32", *TIMED]
# the AGM-Net probes: a 32-channel network, 2 heads of 16, 64² inputs
AGM = ["--device", "cpu", "--n", "600", "--anchors", "64", "--res", "64",
       "--depth-res", "32", "--batch", "2", "--channels", "32", "--heads",
       "2", "--head-dim", "16", *TIMED]

CASES = {
    "packed_test": (packed_test, SMALL + ["--max-pairs", "4096", "--what",
                                          "bwd"],
                    ["fwd_sum", "grad_sum", "fwd_max_abs_err",
                     "bwd_max_rel_err", "ok"]),
    "precision_check": (precision_check, SMALL + ["--max-per-tile", "1024",
                                                  "--max-pairs", "4096"],
                        ["color", "full", "ok"]),
    "bench_blend": (bench_blend, SMALL + TIMED + ["--maxpt", "64",
                                                  "--max-pairs", "4096"],
                    ["packed", "windowed maxpt=64"]),
    "profile_raster": (profile_raster, SMALL + TIMED
                       + ["--max-pairs", "4096"],
                       ["project_fwd", "binning", "pair_gather_T",
                        "blend_fwd_kernel", "raw_to_outputs",
                        "blend_bwd_kernel", "segred_chain", "scatter_add_T",
                        "project_bwd", "trace", "top_ops"]),
    "bench_parts": (bench_parts, SMALL + TIMED + [
        "--max-pairs", "4096", "--maxpt", "64", "--attn", "1", "2", "512",
        "16", "--attn-K", "1"],
        ["tile_counts", "blend fwd kernel", "blend fwd+bwd kernels",
         "window gather fwd", "window gather fwd+bwd",
         "projection+pack fwd+bwd", "attn kernel", "attn chunked",
         "attn math"]),
    "bench_attn": (bench_attn, ATTN,
                   ["chunked f32 baseline", "kernel f32 64x64",
                    "kernel f32 128x64", "kernel f32 128x128",
                    "kernel bf16 64x64", "chunked kv-bf16 f32-softmax",
                    "kernel f32 fwd+bwd 128x64",
                    "kernel bf16 fwd+bwd 128x64"]),
    "bench_attn2": (bench_attn2, ATTN,
                    ["f32 64x64", "f32 128x64", "f32 128x128", "bf16 64x64",
                     "bf16 128x64", "bf16 128x128"]),
    "bench_swin": (bench_swin, ["--device", "cpu", "--shape", "2", "32",
                                "16", "16", "--layers", "2", *TIMED],
                   ["kernel", "plain", "max|d|/max|x|", "ok"]),
    "bench_agm_bf16": (bench_agm_bf16, AGM,
                       [name for name, _ in bench_agm_bf16.FLAG_SETS]),
    "profile_agm_diff": (profile_agm_diff, AGM,
                         ["motion+cond", "..+triplane", "..+interp_decode",
                          "full fwd"]),
    "bench_agm_plucker": (bench_agm_plucker, AGM,
                          ["local_ray=True", "local_ray=False"]),
    "bench_binning": (bench_binning, SMALL + TIMED
                      + ["--max-pairs", "4096"],
                      [f"upto {s}" for s in bench_binning.STAGES]),
    "bench_binning2": (bench_binning2, SMALL + TIMED
                       + ["--max-pairs", "4096", "--mpt", "128"],
                       ["pairs only", "pairs+idx_table", "pairs+idx+gather",
                        "compact lists", "compact+gather", "budget"]),
    "bench_binning3": (bench_binning3, SMALL + TIMED
                       + ["--max-pairs", "4096"],
                       ["argsort_depth", "repeat_expand", "histogram",
                        "transpose+scatter",
                        "perm-gather+segment_sum_sorted"]),
    "profile_bin_ablate": (profile_bin_ablate, LOOP,
                           [f"upto {u}" for u in profile_bin_ablate.UPTO]),
    "bench_expand": (bench_expand, ["--device", "cpu", "--n", "2000",
                                    "--max-pairs", "8192", *TIMED],
                     ["repeat_interleave", "scatter+cummax",
                      "index_add+cumsum"]),
    "bench_segred": (bench_segred, ["--device", "cpu", "--n", "2000",
                                    "--max-pairs", "4096", *TIMED],
                     ["scatter-add (16,MP)->(16,N)",
                      "segmented scan (16,MP)"]),
    "bench_segred_ab": (bench_segred_ab, SMALL + TIMED
                        + ["--max-pairs", "4096"],
                        ["color", "full"]),
    "bench_segred_loop": (bench_segred_loop, LOOP, ["scatter", "segred"]),
    "bench_refine_loop": (bench_refine_loop, LOOP,
                          ["densify=True", "densify=False"]),
    "profile_refine_ablate": (profile_refine_ablate, LOOP
                              + ["--rebin-every", "2"],
                              ["full", "no_ssim", "no_stats", "no_adam",
                               "fwd_l1", "fwd_only", "bin_only", "rebin",
                               "differential_step_ms"]),
    "sweep": (sweep, ["--device", "cpu", "--only", "refine_loop", "--args",
                      "refine_loop", " ".join(LOOP[2:])],
              ["refine_loop"]),
}


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    if isinstance(x, float):
        return math.isfinite(x)
    return True


@pytest.mark.parametrize("name", list(CASES))
def test_probe_runs_and_writes_its_json(tmp_path, monkeypatch, name):
    module, argv, keys = CASES[name]
    monkeypatch.chdir(tmp_path)  # the sweep's program writes its default
    out = tmp_path / f"{name}.json"
    assert module.main([*argv, "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["probe"] == name and doc["device"] == "cpu"
    assert doc["launches"] == {}  # no kernel runs on the CPU
    res = doc["results"]
    assert set(keys) <= set(res), set(keys) - set(res)
    assert _finite(res)
    if "ok" in res:
        assert res["ok"] is True
    if name == "sweep":
        assert res["refine_loop"]["rc"] == 0
        assert (tmp_path / "logs" / "igs_tpu_torch" / "tools"
                / "bench_refine_loop.json").exists()
    if name == "bench_expand":
        assert res["scatter+cummax"]["matches_repeat"] is True
    if name == "bench_binning3":
        assert res["segment_sum_vs_index_add_max_abs"] < 1e-4
    if name == "bench_segred_ab":
        for mode in ("color", "full"):
            assert max(res[mode]["grad_rel_err"].values()) < 1e-5
    if name in ("bench_attn", "bench_attn2"):
        # on the CPU every kernel line is the plain version: f32 exact
        # against the baseline, bf16 within its rounding
        for key, val in res.items():
            if isinstance(val, dict) and "max_abs_err" in val:
                bound = 0.0 if "f32" in key and "kv" not in key else 2e-2
                assert val["max_abs_err"] <= bound, key
    if name == "bench_agm_bf16":
        assert res["f32 baseline"]["max|dimg|"] == 0.0


@pytest.mark.parametrize("max_pairs", [1 << 13, 1000])
@pytest.mark.parametrize("views", [1, 3])
def test_composed_stages_equal_build_tile_pairs(max_pairs, views):
    """``bench_binning.compose`` (the five public stages) gives
    ``build_tile_pairs``'s pairs, with and without the aux, also when
    the budget truncates and for several views."""
    g = scene(1500, "cpu")
    cams = [camera(48, "cpu") for _ in range(views)]
    from igs_tpu_torch.core.camera import Camera
    proj = bench_binning.project_plain(g, Camera.stack(cams))
    gx, gy = image_tile_grid(48, 48)
    for upto, aux in (("ranges", False), ("aux", True)):
        got = bench_binning.compose(proj, gx, gy, max_pairs, upto)
        want = build_tile_pairs(proj, gx, gy, max_pairs, segred_aux=aux)
        for field in want._fields:
            assert torch.equal(getattr(got, field), getattr(want, field)), \
                field
    if max_pairs == 1000:
        assert bool(want.overflowed.any())


@pytest.mark.parametrize("name", ["tpu_sweep.json", "roofline.json"])
def test_probes_refuse_the_tpu_files(name):
    """The repo-root files that hold the TPU's numbers are never written
    (refused before anything runs)."""
    path = str(pathlib.Path(__file__).resolve().parents[1] / name)
    for module in (sweep, bench_expand):
        with pytest.raises(ValueError, match="TPU"):
            module.main(["--device", "cpu", "--out", path])


def test_expand_constructions_agree():
    rng = np.random.RandomState(1)
    t = torch.from_numpy(np.clip(rng.poisson(2.85, 300), 0, 40))
    p = torch.from_numpy(rng.randint(0, 1 << 20, (300, 5)).astype(np.int32))
    s = torch.zeros(())
    total = int(t.sum())
    ref = bench_expand.via_repeat(s, p, t, 2048)
    assert torch.equal(ref[:total], torch.repeat_interleave(p, t, 0))
    got = bench_expand.via_scatter_cummax(s, p, t, 2048)
    assert torch.equal(got[:total], ref[:total])


def test_precision_check_fails_when_the_window_overflows(tmp_path):
    """Tiles over ``max_per_tile`` pairs make the two routes render
    different pair sets, so the check fails even where the errors stay
    inside the envelope."""
    out = tmp_path / "precision_check.json"
    assert precision_check.main([*SMALL, "--max-per-tile", "128",
                                 "--max-pairs", "4096",
                                 "--out", str(out)]) == 1
    res = json.loads(out.read_text())["results"]
    assert res["color"]["windowed_overflow_tiles"] > 0
    assert res["color"]["ok"] is False and res["ok"] is False
