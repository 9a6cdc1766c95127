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
constructions agree where the JAX probe says they do. The rejected
probes' reductions and index tables against the JAX package's on the
same seeded inputs; the strip sweep over gloo ranks (one strip bit-equal
to the single-process loop, two within the JAX probe's 5e-4); the
ladder's two rungs on a scene and a checkpoint the port trains in
``tmp_path``, its repairs (ROADMAP C44), and the 256² configs read as
the JAX builders read them."""

import dataclasses
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from igs_tpu import builders as jax_builders
from igs_tpu.config import load_config as jax_load_config
from igs_tpu.ops.binning import TilePairs as JTilePairs
from igs_tpu.ops.render_tiles import pairs_to_idx_table as jax_idx_table
from igs_tpu_torch import builders
from igs_tpu_torch.bench import camera, scene
from igs_tpu_torch.config import load_config
from igs_tpu_torch.ops.binning import TilePairs
from igs_tpu_torch.ops.render_tiles import pairs_to_idx_table
from igs_tpu_torch.ops.binning import build_tile_pairs, image_tile_grid
from igs_tpu_torch.tools import (bench_agm_bf16, bench_agm_plucker,
                                 bench_attn, bench_attn2, bench_binning,
                                 bench_blend, bench_expand, bench_parts,
                                 bench_segred, bench_segred_ab,
                                 bench_segred_loop, bench_binning2,
                                 bench_binning3, bench_gatherad,
                                 bench_idxtable, bench_rebin, bench_rebin2,
                                 bench_rebin3, bench_refine_loop,
                                 bench_scatter, bench_swin, gates_256,
                                 ladder_checkpoint, packed_test,
                                 precision_check, profile_agm_diff,
                                 profile_bin_ablate, profile_raster,
                                 profile_refine_ablate,
                                 refine_parallel_sweep, sweep)



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
    "bench_rebin": (bench_rebin, LOOP,
                    [f"rebin_every={k}" for k in (1, 2, 4, 8)]),
    "bench_rebin2": (bench_rebin2, LOOP, ["exact", "frozen", "proj_only"]),
    "bench_rebin3": (bench_rebin3, LOOP, list(bench_rebin3.MODES)),
    "bench_scatter": (bench_scatter, ["--device", "cpu", "--n", "500",
                                      "--pairs", "3000", *TIMED],
                      [*bench_scatter.SCATTER, "segsum sorted ids",
                       "cumsum+boundaries", "max_abs_vs_16", "kernel"]),
    "bench_gatherad": (bench_gatherad, ["--device", "cpu", "--n", "500",
                                        "--pairs", "2000", *TIMED],
                       ["gather fwd", "gather fwd+AD", "sorted segsum",
                        "kernel"]),
    "bench_idxtable": (bench_idxtable, SMALL + TIMED
                       + ["--max-pairs", "4096", "--mpt", "64"],
                       ["A gather idx_table", "B scatter searchsorted",
                        "C scatter start-gather", "D fused feats scatter",
                        "E dyn-slice windows", "checks", "ok", "kernel"]),
    # the JAX probe's inputs at 64², 1 and 2 strips over gloo, 10 steps
    "refine_parallel_sweep": (refine_parallel_sweep, [
        "--device", "cpu", "--res", "64", "--strips", "1", "2", "--steps",
        "10"], ["results", "all_equivalent"]),
    # two rungs of the ladder, one batch each, on the ``ladder`` fixture's
    # scene and checkpoint (the argv is made from it)
    "gates_256": (gates_256, lambda lad: [
        lad["checkpoint"], *lad["overrides"], "--only", "exact_all",
        "production", "--max-batches", "1", "--device", "cpu",
        "--workspace", lad["workspace"]], ["what", "checkpoint",
                                           "results"]),
    # the fixture's own run (its JSON is read, not made again)
    "ladder_checkpoint": (ladder_checkpoint, None,
                          ["scene_s", "steps", "train_s", "sec/step",
                           "first", "last", "eval", "checkpoint",
                           "start_gs_path"]),
}

# the ladder's scene and network cut to a CPU test: 6 frames at 32², 192
# Gaussians, a 32-channel network of one layer a stage, two refine steps
TINY_SCENE = {"n_frames": 6, "n_gaussians": 192, "height": 32, "width": 32}
TINY_DATA = [f"data.data.{k}=32" for k in ("input_height", "input_width",
                                           "output_height", "output_width")]
TINY_SYSTEM = ["system.backbone.feature_channels=32",
               "system.backbone.transformer.num_layers=1",
               "system.triplane_encoder.unet.num_attention_heads=2",
               "system.triplane_encoder.unet.attention_head_dim=16",
               "system.triplane_encoder.unet.num_layers=1"]


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """``ladder_checkpoint`` at a tiny size (two training steps on the
    overfit config, seeded) and the overrides that point the stream
    config at its scene."""
    base = tmp_path_factory.mktemp("ladder")
    root, ws = str(base / "scene"), str(base / "train")
    out = str(base / "ladder_checkpoint.json")
    assert ladder_checkpoint.main([
        "--root", root, "--workspace", ws, "--max-steps", "2", "--device",
        "cpu", "--recipe", json.dumps(TINY_SCENE), *TINY_DATA, *TINY_SYSTEM,
        "--out", out]) == 0
    res = json.loads(pathlib.Path(out).read_text())["results"]
    return {"json": out, "checkpoint": res["checkpoint"],
            "workspace": str(base / "gates"),
            "overrides": [f"data.data.root_dir={root}",
                          f"data.data.start_gs_path={res['start_gs_path']}",
                          *TINY_DATA, *TINY_SYSTEM,
                          "opt.refine_iterations=2", "opt.max_num=256"]}


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    if isinstance(x, float):
        return math.isfinite(x)
    return True


@pytest.mark.parametrize("name", list(CASES))
def test_probe_runs_and_writes_its_json(tmp_path, monkeypatch, request, name):
    module, argv, keys = CASES[name]
    monkeypatch.chdir(tmp_path)  # the sweep's program writes its default
    out = tmp_path / f"{name}.json"
    if name in ("gates_256", "ladder_checkpoint"):
        lad = request.getfixturevalue("ladder")
        if argv is None:
            out = pathlib.Path(lad["json"])
        else:
            argv = argv(lad)
    if argv is not None:
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
    if name == "bench_idxtable":
        assert all(res["checks"].values())
    if name == "bench_scatter":
        assert max(res["max_abs_vs_16"].values()) < 1e-5
    if name == "refine_parallel_sweep":
        # the JAX artifact's pattern: densify fired, capacity bound, one
        # strip bit-equal, two within 5e-4 with equal live counts
        one, two = res["results"]
        assert (one["n_strips"], two["n_strips"]) == (1, 2)
        for rec in (one, two):
            assert rec["densify_fired"] and rec["equivalent"]
            assert rec["rows_over_tol"] == {}
            assert rec["ref_valid"] == rec["shd_valid"] == 768
            assert rec["rank_launches"] == [{}] * rec["n_strips"]
        assert max(one["max_abs_dev"].values()) == 0.0
        assert max(two["max_abs_dev"].values()) < 5e-4
        assert res["all_equivalent"] is True
    if name == "gates_256":
        rungs = res["results"]
        assert list(rungs) == ["exact_all", "production"]
        for rung in rungs.values():
            assert math.isfinite(rung["avg"])
            assert not any(rung["launches"].values())  # the rung's process
            assert len(rung["psnr"]) == 5  # one batch of eval_batch_size
        assert rungs["exact_all"]["delta_vs_exact_all_db"] == 0.0
    if name == "ladder_checkpoint":
        assert res["steps"] == 2
        assert pathlib.Path(res["checkpoint"]).name == "params.pth"


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


@pytest.mark.parametrize("name", ["tpu_sweep.json", "roofline.json",
                                  "REFINE_PARALLEL_SWEEP.json",
                                  "GATES_256.json"])
def test_probes_refuse_the_tpu_files(name):
    """The repo-root files that hold the JAX package's numbers are never
    written (refused before anything runs), by any probe, the sweep and
    the ladder included."""
    path = str(pathlib.Path(__file__).resolve().parents[1] / name)
    for module in (sweep, bench_expand, refine_parallel_sweep):
        with pytest.raises(ValueError, match="TPU"):
            module.main(["--device", "cpu", "--out", path])
    with pytest.raises(ValueError, match="TPU"):
        gates_256.main([__file__, "--device", "cpu", "--out", path])


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


# -- the rejected probes against the JAX package -----------------------------

def test_scatter_forms_match_jax():
    """Each of ``bench_scatter``'s forms against ``.at[gid].add`` (the
    scatter forms) or ``jax.ops.segment_sum`` over the sorted ids (the
    sorted forms) on the JAX probe's seeded inputs: within 1e-5 (f32 sums
    of a few terms), the cumsum form within 4 ulps of its largest running
    sum (its rounding grows with the offset)."""
    n, pairs, lanes = 300, 2000, 16
    dfe, gid = bench_scatter.inputs(n, pairs, lanes)
    want = np.asarray(jnp.zeros((n, lanes), jnp.float32).at[gid].add(dfe))
    want_sorted = np.asarray(jax.ops.segment_sum(
        dfe, np.sort(gid), num_segments=n, indices_are_sorted=True))
    d, g = torch.from_numpy(dfe), torch.from_numpy(gid.astype(np.int64))
    for name, fn in bench_scatter.SCATTER.items():
        assert np.abs(fn(d, g, n).numpy() - want).max() <= 1e-5, name
    lengths, base, ends, has = (torch.from_numpy(a) for a in
                                bench_scatter.contiguous_runs(gid, n))
    seg = bench_scatter.segment_sum_lengths(d, lengths).numpy()
    assert np.abs(seg - want_sorted).max() <= 1e-5
    cum = bench_scatter.cumsum_boundaries(d, base, ends, has).numpy()
    ulp = np.finfo(np.float32).eps * np.abs(np.cumsum(dfe, 0)).max()
    assert np.abs(cum - want_sorted).max() <= 4 * ulp


def test_gatherad_forms_match_jax():
    """``bench_gatherad``'s forward, its autograd gradient and the sorted
    segment sum against ``jnp`` and ``jax.grad`` on the JAX probe's
    seeded inputs, within 1e-5 (the forward relative)."""
    n, pairs, lanes = 300, 2000, 32
    feats, ids, w = bench_gatherad.inputs(n, pairs, lanes)

    def fwd(f):
        return jnp.sum(f[ids] * w)

    f, i, wt = (torch.from_numpy(feats), torch.from_numpy(ids.astype(
        np.int64)), torch.from_numpy(w))
    got = float(bench_gatherad.gather_fwd(f, i, wt))
    assert abs(got - float(fwd(feats))) <= 1e-5 * abs(float(fwd(feats)))
    grad = bench_gatherad.gather_grad(f, i, wt).numpy()
    assert np.abs(grad - np.asarray(jax.grad(fwd)(feats))).max() <= 1e-5
    lengths = torch.from_numpy(bench_scatter.contiguous_runs(ids, n)[0])
    seg = bench_scatter.segment_sum_lengths(wt, lengths).numpy()
    want = np.asarray(jax.ops.segment_sum(w, np.sort(ids), num_segments=n))
    assert np.abs(seg - want).max() <= 1e-5


def _sorted_pairs(tiles, pairs, n, seed):
    """A sorted pair list of ``tiles`` tiles (poisson counts, some past
    the table's rows, the rest of the budget padding) as numpy arrays."""
    rng = np.random.RandomState(seed)
    counts = np.minimum(rng.poisson(40, tiles), pairs // tiles).astype(
        np.int32)
    counts[rng.randint(0, tiles, 3)] = 0
    total = int(counts.sum())
    tile_id = np.full(pairs, tiles, np.int32)
    tile_id[:total] = np.repeat(np.arange(tiles, dtype=np.int32), counts)
    gauss_id = np.full(pairs, -1, np.int32)
    gauss_id[:total] = rng.randint(0, n, total)
    start = (np.cumsum(counts) - counts).astype(np.int32)
    return gauss_id, tile_id, start, counts


@pytest.mark.parametrize("mpt", [32, 64])
def test_idxtable_variants_match_jax(mpt):
    """``bench_idxtable``'s variants on one seeded sorted list against the
    JAX package's ``pairs_to_idx_table``: A, B and C equal its table
    exactly; D and E equal its table followed by the feature gather
    within each tile's count (at 32 rows a tile some tiles overflow)."""
    tiles, pairs, n = 24, 2048, 500
    gid, tid, start, counts = _sorted_pairs(tiles, pairs, n, seed=mpt)
    z = np.zeros(0, np.int32)
    want = np.asarray(jax_idx_table(JTilePairs(
        jnp.asarray(gid), jnp.asarray(tid), jnp.int32(counts.sum()),
        jnp.asarray(start), jnp.asarray(counts), jnp.bool_(False), z, z, z),
        mpt))
    e = torch.zeros(0, dtype=torch.int64)
    tp = TilePairs(torch.from_numpy(gid), torch.from_numpy(tid),
                   torch.tensor([counts.sum()], dtype=torch.int32),
                   torch.from_numpy(start), torch.from_numpy(counts),
                   torch.tensor([False]), e, e.int(), e)
    assert (counts > mpt).any() == (mpt == 32)
    assert np.array_equal(pairs_to_idx_table(tp, mpt).numpy(), want)
    assert np.array_equal(
        bench_idxtable.variant_b(tp, tiles, mpt).numpy(), want)
    assert np.array_equal(
        bench_idxtable.variant_c(tp, tiles, mpt).numpy(), want)
    feats = np.random.RandomState(1).normal(size=(n, 32)).astype(np.float32)
    gathered = feats[np.maximum(want, 0)]
    live = bench_idxtable.within_counts(tp, mpt).numpy()
    ft = torch.from_numpy(feats)
    for got in (bench_idxtable.variant_d(tp, ft, tiles, mpt),
                bench_idxtable.variant_e(tp, ft, mpt)):
        got = got.reshape(gathered.shape).numpy()
        assert np.array_equal(got[live], gathered[live])


# -- the ladder: its repairs (ROADMAP C44) and its configs --------------------

def _fake_rungs(fail, calls):
    """A ``subprocess.run`` for ``gates_256`` that writes each rung's
    results.json and fails the rungs named in ``fail``."""
    class Done:
        def __init__(self, rc):
            self.returncode, self.stdout = rc, "rung output\n"
            self.stderr = 'kernel launches {"segmented_scan": 3}\n'

    def run(cmd, **kw):
        ws = next(a.split("=", 1)[1] for a in cmd
                  if a.startswith("opt.workspace="))
        name = pathlib.Path(ws).name
        calls.append(name)
        if name in fail:
            return Done(1)
        pathlib.Path(ws).mkdir(parents=True, exist_ok=True)
        (pathlib.Path(ws) / "results.json").write_text(json.dumps({
            "avg": 20.0 + len(calls), "psnr": [20.0], "overflow_events": [],
            "sec/frame": 0.5}))
        return Done(0)
    return run


def test_gates_writes_a_failed_last_rung(tmp_path, monkeypatch, capsys):
    """A failed last rung is in the JSON with its exit code and output,
    and the JSON was written after each rung (the JAX probe dropped it);
    the program exits 1."""
    calls = []
    monkeypatch.setattr(gates_256.subprocess, "run",
                        _fake_rungs({"exact_fps"}, calls))
    out = tmp_path / "g.json"
    rc = gates_256.main([__file__, "--only", "exact_all", "exact_knn",
                         "exact_fps", "--workspace", str(tmp_path / "ws"),
                         "--device", "cpu", "--out", str(out)])
    assert rc == 1 and calls == ["exact_all", "exact_knn", "exact_fps"]
    res = json.loads(out.read_text())["results"]["results"]
    assert res["exact_fps"]["error"] == 1
    assert "rung output" in res["exact_fps"]["output_tail"]
    assert res["exact_knn"]["launches"] == {"segmented_scan": 3}
    assert res["exact_knn"]["delta_vs_exact_all_db"] == 1.0
    assert "ROADMAP C1" in res["exact_knn"]["exact_knn_note"]
    assert capsys.readouterr().out.count("gates_256: wrote") == 3


@pytest.mark.parametrize("argv", [
    ["--max-batches", "two"], ["--max-batches", "1.5"],
    ["--max-batches", "0"], ["not_an_override"]])
def test_gates_refuses_bad_arguments_before_any_run(tmp_path, monkeypatch,
                                                    capsys, argv):
    """A ``--max-batches`` that is not a positive integer, a stray
    argument, or a missing checkpoint is refused before any rung runs,
    and nothing says "wrote"."""
    calls = []
    monkeypatch.setattr(gates_256.subprocess, "run",
                        _fake_rungs(set(), calls))
    out = tmp_path / "g.json"
    for args in ([__file__, *argv], [str(tmp_path / "missing.pth")]):
        with pytest.raises(SystemExit):
            gates_256.main([*args, "--device", "cpu", "--out", str(out)])
    assert calls == [] and not out.exists()
    assert "wrote" not in capsys.readouterr().out


ROOT = pathlib.Path(__file__).resolve().parents[1]


def _as_dict(cfg) -> dict:
    return (dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg)
            else cfg._asdict())


@pytest.mark.parametrize("name", ["synthetic_train_256",
                                  "synthetic_overfit_256",
                                  "synthetic_stream_256"])
def test_ladder_configs_read_as_jax(name):
    """The 256² configs (the ladder's training and stream) give the port
    the sections and the optimiser, stream, refine and network settings
    the JAX builders read from them: ``train_backbone``, the ``opt``
    keys ``crash_snapshot_every``, ``save_every``, ``eval_every`` (read
    by both ``train_agm`` loops) and ``resume_cfg`` (both stream CLIs)
    pass through unchanged."""
    path = str(ROOT / "configs" / f"{name}.yaml")
    jcfg, pcfg = jax_load_config(path), load_config(path)
    for sec in ("opt", "data", "system"):
        assert getattr(pcfg, sec) == getattr(jcfg, sec), sec
    jopt = jax_builders.build_opt_config(jcfg.opt)
    popt = builders.build_opt_config(pcfg.opt)
    assert vars(popt) == vars(jopt)
    for port, jx in zip(builders.build_stream_configs(pcfg.opt),
                        jax_builders.build_stream_configs(jcfg.opt)):
        port, jx = _as_dict(port), _as_dict(jx)
        for f in set(port) & set(jx):
            assert port[f] == jx[f], f
    want_tb = bool(jcfg.system.get("train_backbone", False))
    model = builders.build_model(
        dict(pcfg.system, backbone=dict(pcfg.system["backbone"],
                                        feature_channels=32)), device="cpu")
    assert model.train_backbone == want_tb == (name != "synthetic_stream_256")
