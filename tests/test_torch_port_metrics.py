"""``python -m igs_tpu_torch.metrics`` against the JAX package's
``metrics.py``: both CLIs, each in its own process (the JAX one with
``JAX_PLATFORMS=cpu``, the port's with ``--device cpu``), on one render
and GT directory pair of small PNGs and JPEGs (``.jpg``, ``.jpeg``, any
case), with an LPIPS weights file the port wrote (a seeded VGG under
lpipsPyTorch's names, which both load as available). PSNR and SSIM agree
per view to 1e-5 relative and LPIPS to 1e-4; the printed JSON and
``metric_results.json`` have the same keys and per-view names. Without
``--lpips-weights`` neither writes LPIPS. A one-channel image raises a
clear error in the port (the JAX CLI fails on it too).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from igs_tpu_torch import metrics
from igs_tpu_torch.train.lpips import LPIPS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("a.png", "b.jpg", "c.JPEG", "d.png")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics")
    rng = np.random.RandomState(0)
    for sub in ("renders", "gt"):
        os.makedirs(root / sub)
    yy, xx = np.mgrid[0:40, 0:56]
    for i, name in enumerate(NAMES):
        gt = np.stack([xx * 4, yy * 6, (xx + yy) * 2], -1) + 20 * i
        gt = np.clip(gt + rng.randint(-20, 21, gt.shape), 0, 255)
        render = np.clip(gt + rng.randint(-30, 31, gt.shape), 0, 255)
        for sub, img in (("gt", gt), ("renders", render)):
            Image.fromarray(img.astype(np.uint8)).save(
                root / sub / name, quality=90)
    # a file of another kind is skipped by both
    (root / "renders" / "notes.txt").write_text("not an image")
    weights = str(root / "lpips.pth")
    torch.save(LPIPS(generator=torch.Generator().manual_seed(3))
               .state_dict(), weights)
    return root, weights


def _run(pkg, root, weights, out):
    args = ["--renders", str(root / "renders"), "--gt", str(root / "gt"),
            "--out", out]
    if weights:
        args += ["--lpips-weights", weights]
    if pkg == "jax":
        cmd = [sys.executable, os.path.join(ROOT, "metrics.py")] + args
    else:
        cmd = [sys.executable, "-m", "igs_tpu_torch.metrics"] + args + [
            "--device", "cpu"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    printed = json.loads(proc.stdout[proc.stdout.index("{"):])
    with open(out) as f:
        return printed, json.load(f)


@pytest.mark.parametrize("with_lpips", [True, False])
def test_metrics_cli_matches_jax(dirs, with_lpips, tmp_path):
    root, weights = dirs
    w = weights if with_lpips else ""
    got, got_file = _run("port", root, w, str(tmp_path / "port.json"))
    want, want_file = _run("jax", root, w, str(tmp_path / "jax.json"))
    assert got == got_file["results"]
    assert want == want_file["results"]
    keys = ["PSNR", "SSIM"] + (["LPIPS"] if with_lpips else [])
    assert list(got) == list(want) == keys
    assert list(got_file) == list(want_file) == ["results", "per_view"]
    pv, wpv = got_file["per_view"], want_file["per_view"]
    assert list(pv) == list(wpv) == ["psnr", "ssim", "lpips"]
    for metric, rel in (("psnr", 1e-5), ("ssim", 1e-5), ("lpips", 1e-4)):
        names = sorted(NAMES) if metric != "lpips" or with_lpips else []
        assert list(pv[metric]) == list(wpv[metric]) == names
        for name in names:
            assert pv[metric][name] == pytest.approx(wpv[metric][name],
                                                     rel=rel), (metric, name)
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=1e-4 if k == "LPIPS"
                                       else 1e-5)


def test_default_out_and_one_channel_error(dirs, tmp_path):
    root, _ = dirs
    res = metrics.run(str(root / "renders"), str(root / "gt"),
                      device="cpu")
    with open(root / "metric_results.json") as f:
        assert json.load(f)["results"] == res["results"]
    assert set(res["ms"]) == {"decode", "psnr_ssim", "lpips", "total"}
    grey = tmp_path / "grey"
    os.makedirs(grey / "r")
    os.makedirs(grey / "g")
    for sub in ("r", "g"):
        Image.fromarray(np.zeros((8, 8), np.uint8)).save(grey / sub / "x.png")
    with pytest.raises(ValueError, match="one-channel"):
        metrics.run(str(grey / "r"), str(grey / "g"), device="cpu")
