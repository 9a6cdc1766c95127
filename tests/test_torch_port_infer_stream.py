"""The streaming CLI as a whole: ``python -m igs_tpu_torch.infer_stream``
against the JAX package's ``infer_stream.py``.

Both CLIs read one toy scene directory (written by the JAX synthetic
writer) through one YAML config, with the same ``opt.resume`` IGS file and
the same GMFlow file (the JAX weights of a tiny AGM-Net, carried over by
``models/convert``), two windows of B=2 (``--max-batches 2``), on the CPU
(the port with ``--device cpu``; the JAX CLI runs its XLA rasterizer there,
the port its packed route's plain versions). With the key-frame refine
(3 steps; densify off, since each package draws its split samples from
its own generator, ROADMAP C4) the per-frame PSNR must agree within
0.05 dB; without
it within 0.01 dB; the carried Gaussian counts equal; the same
``results.json`` keys. The refine run also merges a ``resume_cfg`` whose
``system`` section drops the ModLN conditioning and sets ``up_sample``,
which the config's own ``system`` overrides: a CLI that skipped the merge,
or let it win, would run another network. On an ENeRF-layout copy of the
scene (JPEG images written by PIL, the enerf view table, depth offset
-1) without refine, the per-frame PSNR must agree within 0.01 dB too.
Both builders ignore ``opt.anchor_size``
and ``opt.neighbor_k`` (ROADMAP C19), so the toy scene's 256 rows run
8192 anchors in both packages.
"""

import json
import os
import sys

import numpy as np
import jax
import pytest
import torch

import infer_stream as jax_cli
from igs_tpu.builders import build_stream_configs as jax_stream_configs
from igs_tpu.config import load_config as jax_load_config
from igs_tpu.data.synthetic import build_synthetic_scene
from igs_tpu_torch import infer_stream
from igs_tpu_torch.builders import build_stream_configs
from igs_tpu_torch.config import load_config
from igs_tpu_torch.models.convert import state_dict_from_flax
from tests.torch_port_common import enerf_copy, flax_params

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SYSTEM = """
system:
  up_sample: True
  local_ray: True
  backbone:
    feature_channels: 32
    pretrained_model_name_or_path: {gmflow}
    transformer:
      num_layers: 1
  transformer:
    num_layers: 1
  triplane_encoder:
    unet:
      num_attention_heads: 2
      attention_head_dim: 16
      num_layers: 1
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    scene = build_synthetic_scene(str(root / "scene"), n_frames=5,
                                  n_cams=14, n_gaussians=192, height=32,
                                  width=32, interval=2)
    _, params, _ = flax_params()
    sd = state_dict_from_flax(jax.tree.map(np.asarray, params))
    igs, gmflow = str(root / "igs.pth"), str(root / "gmflow.pth")
    torch.save({"model": sd}, igs)
    torch.save({"model": {k[len("backbone."):]: v for k, v in sd.items()
                          if k.startswith("backbone.")}}, gmflow)
    resume_cfg = str(root / "resume_cfg.yaml")
    with open(resume_cfg, "w") as f:
        f.write("system:\n  use_condition3d: False\n  up_sample: False\n")
    cfg = str(root / "stream.yaml")
    with open(cfg, "w") as f:
        f.write(f"""
data:
  data_cls: igs.data.infer_data.N3dDataset
  data:
    background_color: [0.0, 0.0, 0.0]
    data_path: {scene['pairs']}
    root_dir: {scene['root']}
    gs_mode: 3dgs_rade
    iter: 6000_compress
    input_height: 32
    input_width: 32
    output_height: 32
    output_width: 32
    scene_type: n3d
    depth_id_offset: 0
    max_sh_degree: 3
    start_gs_path: {scene['start_gs_path']}
opt:
  eval_batch_size: 2
  refine_gs: True
  refine_iterations: 3
  use_densify: False
  max_num: 256
  anchor_size: 32
  neighbor_k: 4
  depth_view_res: 16
  resume: {igs}
  resume_cfg: ""
""" + SYSTEM.format(gmflow=gmflow))
    return root, cfg, resume_cfg, scene


def _run_both(root, cfg, monkeypatch, name, dots):
    """Both CLIs on the same config and overrides → their results.json."""
    out = {}
    for pkg in ("jax", "port"):
        ws = str(root / f"{name}_{pkg}")
        args = ["--config", cfg, "--max-batches", "2",
                f"opt.workspace={ws}"] + dots
        if pkg == "jax":
            monkeypatch.setattr(sys, "argv", ["infer_stream.py"] + args)
            jax_cli.main()
        else:
            infer_stream.main(args + ["--device", "cpu"])
        with open(os.path.join(ws, "results.json")) as f:
            out[pkg] = json.load(f)
    return out["port"], out["jax"]


@pytest.mark.parametrize("refine", [True, False])
def test_cli_matches_jax(setup, monkeypatch, refine):
    root, cfg, resume_cfg, _ = setup
    dots = ([f"opt.resume_cfg={resume_cfg}"] if refine
            else ["opt.refine_gs=false"])
    got, want = _run_both(root, cfg, monkeypatch, f"refine{refine}", dots)
    assert set(got) == set(want)
    assert list(got["psnr"]) == list(want["psnr"]) == [
        f"frame_{i}" for i in range(4)]
    tol = 0.05 if refine else 0.01
    for k, w in want["psnr"].items():
        assert np.isfinite(got["psnr"][k])
        assert abs(got["psnr"][k] - w) < tol, (got["psnr"], want["psnr"])
    assert got["mask_num"] == want["mask_num"]
    assert got["points_num"] == want["points_num"]
    assert got["overflow_events"] == want["overflow_events"] == []
    assert len(got["AGM_times"]) == 2


def test_cli_matches_jax_on_enerf(setup, monkeypatch):
    """``scene_type: enerf``: JPEG inputs through each package's decoder
    (PIL's pixels in both), no refine: PSNR within 0.01 dB a frame."""
    root, cfg, _, scene = setup
    enerf = enerf_copy(scene["root"], str(root / "enerf_scene"))
    with open(cfg) as f:
        text = f.read()
    text = text.replace(f"root_dir: {scene['root']}", f"root_dir: {enerf}")
    text = text.replace("scene_type: n3d", "scene_type: enerf")
    text = text.replace("    depth_id_offset: 0\n", "")
    text = text.replace(scene["start_gs_path"], scene["start_gs_path"].replace(
        scene["root"], enerf))
    enerf_cfg = str(root / "enerf.yaml")
    with open(enerf_cfg, "w") as f:
        f.write(text)
    got, want = _run_both(root, enerf_cfg, monkeypatch, "enerf",
                          ["opt.refine_gs=false"])
    assert set(got) == set(want)
    assert list(got["psnr"]) == list(want["psnr"]) == [
        f"frame_{i}" for i in range(4)]
    for k, w in want["psnr"].items():
        assert abs(got["psnr"][k] - w) < 0.01, (got["psnr"], want["psnr"])
    assert got["points_num"] == want["points_num"]
    assert got["overflow_events"] == want["overflow_events"] == []


def test_anchor_keys_are_ignored_as_in_jax():
    """ROADMAP C19: the stream runs 8192 anchors and k=8 whatever
    ``opt.anchor_size`` and ``opt.neighbor_k`` say."""
    path = os.path.join(ROOT, "configs", "synthetic_demo.yaml")
    jopt = jax_load_config(path).opt
    assert (jopt["anchor_size"], jopt["neighbor_k"]) == (64, 8)
    want, _ = jax_stream_configs(jopt)
    got, _ = build_stream_configs(load_config(path).opt)
    assert (got.anchor_size, got.neighbor_k) == (
        want.anchor_size, want.neighbor_k) == (8192, 8)


def test_run_takes_dict_sections_and_leaves_them(setup, tmp_path):
    """``run`` on dict sections (no YAML), on the CPU; the caller's dicts
    are left as they were (the CLI copies ``up_sample`` into its own)."""
    _, cfg, _, _ = setup
    sections = {k: v for k, v in vars(load_config(cfg)).items()
                if k in ("opt", "data", "system")}
    sections["opt"] = dict(sections["opt"], refine_gs=False,
                           workspace=str(tmp_path))
    before = json.dumps(sections, sort_keys=True)
    res = infer_stream.run(sections, max_batches=1, device="cpu")
    assert json.dumps(sections, sort_keys=True) == before
    assert len(res["psnr"]) == 2
    assert sorted(os.listdir(tmp_path / "eval_pred")) == [
        "00000.png", "00001.png"]
