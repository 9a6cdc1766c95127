"""The port's training entry point on the CPU: ``train_agm.run`` with dict
sections (two steps through the windowed route on a scene written by the
port's writer, a checkpoint, the eval, a resume that restores the
optimizer state) and the CLI on a YAML config."""

import json

import numpy as np
import pytest
import torch

from igs_tpu_torch import train_agm
from igs_tpu_torch.data.synthetic import build_synthetic_scene
from igs_tpu_torch.train.driver import load_checkpoint

torch.set_num_threads(2)

SYSTEM = {
    "up_sample": True, "local_ray": False, "train_backbone": True,
    "backbone": {"feature_channels": 32, "transformer": {"num_layers": 1}},
    "transformer": {"num_layers": 1},
    "triplane_encoder": {"unet": {"num_attention_heads": 2,
                                  "attention_head_dim": 16, "num_layers": 1}},
}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    build_synthetic_scene(str(root), n_frames=5, n_cams=10, n_gaussians=96,
                          height=32, width=32, interval=2, motion_scale=0.3,
                          device="cpu")
    return root


def _cfg(root, workspace):
    data = {"data_path": "toy_scene_pairs.json", "root_dir": str(root),
            "iter": "6000_compress", "input_height": 32, "input_width": 32,
            "output_height": 32, "output_width": 32, "num_input_views": 2,
            "num_output_views": 3, "up_sample": True,
            "background_color": [0.0, 0.0, 0.0]}
    opt = {"batch_size": 2, "lr": 4e-4, "num_epochs": 3, "warmup_steps": 2,
           "gradient_clip": 1.0, "lambda_rgb": 1.0, "lambda_ssim": 0.2,
           "anchor_size": 32, "neighbor_k": 4, "save_every": 1,
           "eval_every": 1, "workspace": str(workspace)}
    return {"system": SYSTEM, "opt": opt,
            "data": {"data_cls": "igs.data.data.N3dDataset", "data": data}}


def test_two_steps_checkpoint_eval_and_resume(scene, tmp_path):
    seen = []
    out = train_agm.run(_cfg(scene, tmp_path), max_steps=2, device="cpu",
                        impl="pallas", max_per_tile=128,
                        on_step=lambda s, m: seen.append((s, m)))
    assert out["steps"] == 2 and [s for s, _ in seen] == [1, 2]
    for _, m in seen:
        assert np.isfinite(float(m["loss"])) and m["updated"]
        assert float(m["loss"]) == pytest.approx(
            float(m["loss_mse"]) + 0.2 * float(m["loss_ssim"]), rel=1e-6)
        assert int(m["overflow_tiles"]) >= 0
    assert out["settings"].impl == "pallas"
    assert out["settings"].clamp_grads
    with open(tmp_path / "log.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert log[0]["step"] == 1 and np.isfinite(log[0]["loss"])
    assert log[0]["lr"] == pytest.approx(
        out["optimizer"].schedule(1))
    assert np.isfinite(out["eval"][0]["eval_psnr"])
    assert (tmp_path / "0" / "eval_pred.png").exists()
    ckpt = tmp_path / "0" / "params.pth"
    sd, step = load_checkpoint(str(ckpt))
    assert step == 2
    model_sd = out["model"].state_dict()
    assert sorted(sd) == sorted(model_sd)
    assert all(torch.equal(sd[k], model_sd[k]) for k in sd)

    resumed = train_agm.run(_cfg(scene, tmp_path / "again"), max_steps=1,
                            resume=str(ckpt), device="cpu", impl="pallas",
                            max_per_tile=128)
    assert resumed["optimizer"].count == 3  # two restored, one taken
    moved = [k for k, v in resumed["model"].state_dict().items()
             if not torch.equal(v, sd[k])]
    # the recipe's train_backbone: the backbone trains with the rest
    assert any(k.startswith("backbone.") for k in moved)
    assert any(k.startswith("render.") for k in moved)


def test_cli_reads_yaml_and_dotlist(scene, tmp_path):
    import yaml

    cfg = _cfg(scene, tmp_path / "ws")
    cfg["opt"]["num_epochs"] = 1
    path = tmp_path / "train.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    train_agm.main(["--config", str(path), "--max-steps", "1", "--device",
                    "cpu", "--impl", "pallas", "--max-per-tile", "128",
                    "opt.lambda_ssim=0.0"])
    with open(tmp_path / "ws" / "experiment_config.yaml") as f:
        dumped = yaml.safe_load(f)
    assert dumped["opt"]["lambda_ssim"] == 0.0
    with open(tmp_path / "ws" / "log.jsonl") as f:
        rec = json.loads(f.readline())
    assert rec["step"] == 1 and np.isfinite(rec["loss"])
    assert (tmp_path / "ws" / "0" / "params.pth").exists()


@pytest.mark.parametrize("weights", [True, False])
def test_lpips_term_through_run(scene, tmp_path, capsys, weights):
    """``opt.lambda_lpips`` > 0: the term's weights from
    ``opt.lpips_weights`` (18 tensors, lpipsPyTorch's names) or, without
    them, a random VGG with the JAX CLI's warning; ``loss_lpips`` in the
    metrics and ``log.jsonl``; the LPIPS stays out of the checkpoint."""
    from igs_tpu_torch.train.lpips import LPIPS

    cfg = _cfg(scene, tmp_path / "ws")
    cfg["opt"].update(lambda_lpips=0.2, num_epochs=1)
    if weights:
        path = str(tmp_path / "lpips.pth")
        torch.save(LPIPS(generator=torch.Generator().manual_seed(5))
                   .state_dict(), path)
        cfg["opt"]["lpips_weights"] = path
    seen = []
    out = train_agm.run(cfg, max_steps=1, device="cpu", impl="pallas",
                        max_per_tile=128,
                        on_step=lambda s, m: seen.append(m))
    printed = capsys.readouterr().out
    if weights:
        assert f"loaded 18 LPIPS tensors from {path}" in printed
    else:
        assert "LPIPS uses a random VGG" in printed
    m = seen[0]
    assert float(m["loss_lpips"]) > 0
    assert float(m["loss"]) == pytest.approx(
        float(m["loss_mse"]) + 0.2 * float(m["loss_ssim"])
        + 0.2 * float(m["loss_lpips"]), rel=1e-6)
    with open(tmp_path / "ws" / "log.jsonl") as f:
        rec = json.loads(f.readline())
    assert rec["loss_lpips"] == pytest.approx(float(m["loss_lpips"]))
    sd, _ = load_checkpoint(str(tmp_path / "ws" / "0" / "params.pth"))
    assert sorted(sd) == sorted(out["model"].state_dict())
    assert not any(k.startswith(("net.", "lin.")) for k in sd)


def test_two_ranks_match_one_process(scene, tmp_path):
    """``run(ranks=2)`` with no group up spawns two gloo ranks on the CPU,
    each taking one item of every batch of 2, the gradients averaged
    before the clip: the step-1 loss within 1e-5 of one process's on the
    whole batch (C18) and the eval PSNR within 0.05 dB; rank 0 alone
    writes the log and the checkpoint."""
    kw = dict(max_steps=2, device="cpu", impl="pallas", max_per_tile=128)
    one = train_agm.run(_cfg(scene, tmp_path / "one"), **kw)
    two = train_agm.run(_cfg(scene, tmp_path / "two"), ranks=2,
                        backend="gloo", **kw)
    assert two["steps"] == one["steps"] == 2
    assert two["model"] is None and two["optimizer"] is None
    assert set(two["state_dict"]) == set(one["state_dict"])
    with pytest.raises(ValueError, match="on_step/on_stage need one rank"):
        train_agm.run(_cfg(scene, tmp_path / "cb"), ranks=2, backend="gloo",
                      on_step=lambda step, metrics: None, **kw)
    assert two["records"][0]["loss"] == pytest.approx(
        one["records"][0]["loss"], rel=1e-5)
    assert abs(two["eval"][0]["eval_psnr"] - one["eval"][0]["eval_psnr"]) \
        < 0.05
    with open(tmp_path / "two" / "log.jsonl") as f:
        assert len(f.read().splitlines()) == len(two["records"]) + len(
            two["eval"])
    sd, step = load_checkpoint(str(tmp_path / "two" / "0" / "params.pth"))
    assert step == 2
    for k, v in sd.items():
        torch.testing.assert_close(v, two["state_dict"][k], atol=0, rtol=0)
