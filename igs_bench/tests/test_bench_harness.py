"""The harness end to end on the CPU at a tiny size: one cell's run, its
last line, and ``correct`` false under each fault the streaming cell can
have (a refine step that returns its state unchanged, half of a window's
candidates left out, an answer altered where it is produced) and under
the control (the reference one precision step down in the program's
place)."""

import json
from pathlib import Path

import pytest
import torch

from igs_bench import compare, run as bench_run
from igs_bench.drivers import stream
from igs_bench.tests.tiny import tiny_config, tiny_job, tiny_traffic

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.fixture
def tiny_cell(monkeypatch, tmp_path):
    load = bench_run.load_json

    def tiny(path):
        path = Path(path)
        if path.parent.name == "configs":
            return tiny_config()
        if path.parent.name == "workloads":
            return tiny_traffic()
        return load(path)

    monkeypatch.setattr(bench_run, "load_json", tiny)
    monkeypatch.setattr(bench_run, "ROOT", bench_run.ROOT)
    return tmp_path


@pytest.mark.parametrize("trace", [0, 1])
def test_run_prints_one_result_line(tiny_cell, capsys, trace):
    rc = bench_run.main(["--workload", "n3dv_stream.refine", "--seed",
                         str(2**31 + 7), "--seconds", "0", "--trace",
                         str(trace)], device=torch.device("cpu"))
    assert rc == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == list(KEYS)
    assert keys[-1] == "checks" and set(keys) <= set(KEYS) | {
        "breakdown", "checks"}
    assert ("breakdown" in line) == bool(trace)
    assert line["correct"] is True
    assert line["attempted"] == 10 and line["failed"] == 0
    names = {m["name"] for m in bench_run.cell_metrics(
        json.loads((bench_run.ROOT / "BENCHMARK.json").read_text()),
        "n3dv_stream.refine", bool(trace))}
    # on the CPU the trace holds no device operation: those metrics are
    # left out, never written as 0
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    assert err.strip().splitlines()[-1].startswith("check ")
    assert len([x for x in err.splitlines() if x.startswith("check ")]) \
        == len(line["checks"])


def _run(tmp_path, **kw):
    job = tiny_job(tmp_path, **kw)
    return bench_run.execute(job, [], job.traffic["limits"])


def test_program_agrees_with_the_reference_in_float32(tmp_path):
    """The tiny configuration computes in float32 on both sides: every
    number is at rounding."""
    nums = _run(tmp_path)["checks"]
    assert nums["anchors"]["value"] == 0.0
    for k in ("refine_grad", "refine_step"):
        assert nums[k]["value"] < 1e-3, (k, nums[k])
    # the eval image also differs where a pair's alpha sits at the 1/255
    # threshold and the two blends decide it apart
    assert nums["image"]["value"] < 5e-3
    assert nums["refine_loss"]["value"] < 1e-5


def test_control_fails(tmp_path):
    res = _run(tmp_path, control=True)
    assert res["correct"] is True
    assert not compare.judge(res["control"], tiny_traffic()["limits"])


def test_fault_refine_step_returns_its_state(tmp_path, monkeypatch):
    import igs_tpu_torch.stream.refine as refine

    step = refine.refine_step

    def unchanged(state, *a, **kw):
        _, metrics = step(state, *a, **kw)
        return state, metrics

    monkeypatch.setattr(refine, "refine_step", unchanged)
    assert _run(tmp_path)["correct"] is False


def test_fault_half_the_window_left_out(tmp_path, monkeypatch):
    from igs_tpu_torch.models.agm import AGMNet

    forward = AGMNet.forward

    def half(self, batch, state, gaussians, *a, **kw):
        out = forward(self, batch, state, gaussians, *a, **kw)
        b = out["images_pred"].shape[0]
        keep = (b + 1) // 2
        take = torch.arange(b) % keep
        out["images_pred"] = out["images_pred"][take]
        out["depth_pred"] = out["depth_pred"][take]
        out["3dgs"] = out["3dgs"].map(lambda x: x[take])
        return out

    monkeypatch.setattr(AGMNet, "forward", half)
    res = _run(tmp_path)
    assert res["correct"] is False
    assert res["checks"]["cand_merge"]["value"] == "inf"


def test_fault_deform_left_out(tmp_path, monkeypatch):
    from igs_tpu_torch.core.gaussians import Gaussians

    deform = Gaussians.deform

    def still(self, res_xyz, *a, **kw):
        return deform(self, torch.zeros_like(res_xyz), *a, **kw)

    monkeypatch.setattr(Gaussians, "deform", still)
    res = _run(tmp_path)
    assert res["checks"]["cand_merge"]["value"] == "inf"
    assert res["correct"] is False


def test_fault_answer_altered(tmp_path, monkeypatch):
    from igs_tpu_torch.models.agm import AGMNet

    forward = AGMNet.forward

    def altered(self, *a, **kw):
        out = forward(self, *a, **kw)
        img = out["images_pred"].clone()
        img[-1, 0, :, :8, :8] += 0.5
        out["images_pred"] = img
        return out

    monkeypatch.setattr(AGMNet, "forward", altered)
    assert _run(tmp_path)["correct"] is False


@pytest.mark.card
def test_control_on_the_card_at_the_cell_size(card, capsys):
    from igs_bench import control

    assert control.main(["--workload", "n3dv_stream.refine", "--seeds",
                         "101"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = json.loads((bench_run.HERE / "workloads" /
                         "n3dv_stream.refine.json").read_text())["limits"]
    assert line["correct"] is True
    assert not compare.judge(line["control"], limits)


def test_stream_driver_keeps_two_windows(tmp_path):
    rec = stream.Recorder((0, 1), 5)
    assert rec._keep() is None  # before the first window
    for frame, kept in ((0, True), (5, True), (10, False)):
        rec.window = frame // rec.b
        assert (rec._keep() is not None) == kept
    assert sorted(rec.records) == [0, 1]


def test_late_steps_are_the_densify_steps_and_the_last():
    cfg = json.loads((bench_run.HERE / "configs" / "igs_n3dv_stream.json"
                      ).read_text())
    assert compare.late_steps(cfg["refine"], 50) == [20, 40, 49]
    assert compare.late_steps(tiny_config()["refine"], 4) == [2, 3]


def test_fault_refine_skips_its_densify(tmp_path, monkeypatch):
    import igs_tpu_torch.stream.refine as refine

    monkeypatch.setattr(refine, "densify_and_prune",
                        lambda state, *a, **kw: state)
    res = _run(tmp_path)
    assert res["checks"]["late_step"]["value"] > \
        res["checks"]["late_step"]["limit"]
    assert res["correct"] is False


def test_fault_refine_stops_early(tmp_path, monkeypatch):
    import igs_tpu_torch.stream.pipeline as pipeline

    run = pipeline.refine_run

    def early(*args, **kw):
        args = list(args)
        args[-1] -= 1  # iters
        return run(*args, **kw)

    monkeypatch.setattr(pipeline, "refine_run", early)
    assert _run(tmp_path)["correct"] is False


def _train(tmp_path, **kw):
    from igs_bench.tests.tiny import tiny_train_job

    job = tiny_train_job(tmp_path, **kw)
    return bench_run.execute(job, [], job.traffic["limits"])


def test_train_step_agrees_and_its_control_and_faults_fail(tmp_path):
    res = _train(tmp_path, control=True)
    assert res["correct"] is True
    assert res["attempted"] == 2  # one step of a batch of two
    limits = json.loads((bench_run.HERE / "workloads" /
                         "n3dv_train.step.json").read_text())["limits"]
    for side in ("control", "fault_half", "fault_altered"):
        assert not compare.judge(res[side], limits), side


def test_train_fault_state_unchanged(tmp_path, monkeypatch):
    from igs_tpu_torch.train import driver

    def no_update(self):
        self.count += 1
        return {"grad_norm": 0.0, "lr": 0.0, "updated": True}

    monkeypatch.setattr(driver.Optimizer, "step", no_update)
    assert _train(tmp_path)["correct"] is False


def test_train_fault_half_the_batch(tmp_path, monkeypatch):
    from igs_tpu_torch.train import driver

    loss_fn = driver.compute_loss

    def half(out, gt, *a, **kw):
        out = dict(out, images_pred=out["images_pred"][:1])
        return loss_fn(out, gt[:1], *a, **kw)

    monkeypatch.setattr(driver, "compute_loss", half)
    assert _train(tmp_path)["correct"] is False


def test_train_fault_answer_altered(tmp_path, monkeypatch):
    from igs_tpu_torch.train import driver

    loss_fn = driver.compute_loss

    def altered(out, gt, *a, **kw):
        pred = out["images_pred"].clone()
        pred[0, 0, :, :16, :16] = pred[0, 0, :, :16, :16] + 0.5
        return loss_fn(dict(out, images_pred=pred), gt, *a, **kw)

    monkeypatch.setattr(driver, "compute_loss", altered)
    assert _train(tmp_path)["correct"] is False
