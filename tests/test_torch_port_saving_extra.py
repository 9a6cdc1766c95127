"""The port's ``save_image_grid``, ``dump_json`` and ``save_runtime_code``
(``igs_tpu_torch/utils/saving.py``) against the JAX package's
(``igs_tpu/utils/saving.py``): the grid's pixels equal (the port's PNG
codec against PIL), the JSON bytes equal, the snapshot a copy of the
port's package without ``__pycache__``; and ``train_agm.run`` writing
``code_snapshot/`` into its workspace, as the JAX ``train_agm.py:60-62``
does."""

import filecmp
import os

import numpy as np
import pytest
from PIL import Image

from igs_tpu.utils import saving as jsaving
from igs_tpu_torch.utils import saving as tsaving
from tests.test_torch_port_train_agm import _cfg, scene  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n,cols", [(5, 4), (3, 4), (6, 3), (1, 2)])
def test_image_grid_pixels(tmp_path, n, cols):
    rng = np.random.RandomState(n)
    kinds = [rng.uniform(0, 1, (3, 10, 14)).astype(np.float32),   # CHW
             rng.uniform(-0.2, 1.2, (10, 14, 3)),                 # clipped
             rng.randint(0, 256, (10, 14, 3)).astype(np.uint8),    # uint8
             rng.uniform(0, 1, (10, 14)),                         # grey
             rng.uniform(0, 1, (1, 10, 14))]                      # 1-ch
    images = [kinds[i % len(kinds)] for i in range(n)]
    jsaving.save_image_grid(str(tmp_path / "jax.png"), images, cols=cols)
    tsaving.save_image_grid(str(tmp_path / "sub" / "port.png"), images,
                            cols=cols)
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    got = np.asarray(Image.open(tmp_path / "sub" / "port.png"))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_dump_json_bytes(tmp_path):
    obj = {"psnr": {"frame_0": 31.25, "frame_1": float("inf")},
           "names": ["a", "é"], "n": 3, "nested": [[1, 2], {"x": None}]}
    jsaving.dump_json(str(tmp_path / "j" / "r.json"), obj)
    tsaving.dump_json(str(tmp_path / "t" / "r.json"), obj)
    assert (tmp_path / "t" / "r.json").read_bytes() == (
        tmp_path / "j" / "r.json").read_bytes()


def test_runtime_code_snapshot(tmp_path):
    src = tmp_path / "checkout"
    pkg = src / "igs_tpu_torch"
    (pkg / "sub" / "__pycache__").mkdir(parents=True)
    (pkg / "__init__.py").write_text("x = 1\n")
    (pkg / "sub" / "m.py").write_text("y = 2\n")
    (pkg / "sub" / "__pycache__" / "m.cpython-312.pyc").write_bytes(b"\0")
    (src / "other.py").write_text("not copied\n")
    dst = tsaving.save_runtime_code(str(tmp_path / "ws"), src_root=str(src))
    assert dst == str(tmp_path / "ws" / "code_snapshot")
    files = sorted(os.path.relpath(os.path.join(d, f), dst)
                   for d, _, fs in os.walk(dst) for f in fs)
    assert files == ["igs_tpu_torch/__init__.py", "igs_tpu_torch/sub/m.py"]
    # the default root: this checkout's package, every source file
    dst = tsaving.save_runtime_code(str(tmp_path / "ws2"))
    cmp = filecmp.dircmp(os.path.join(ROOT, "igs_tpu_torch"),
                         os.path.join(dst, "igs_tpu_torch"),
                         ignore=["__pycache__"])
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files
    assert os.path.exists(os.path.join(dst, "igs_tpu_torch", "csrc",
                                       "host", "igsio.cpp"))


def test_train_agm_writes_code_snapshot(scene, tmp_path):  # noqa: F811
    from igs_tpu_torch import train_agm

    out = train_agm.run(_cfg(scene, tmp_path), max_steps=1, device="cpu",
                        impl="pallas", max_per_tile=128)
    assert out["steps"] == 1
    snap = tmp_path / "code_snapshot" / "igs_tpu_torch"
    assert (snap / "train_agm.py").read_bytes() == open(
        os.path.join(ROOT, "igs_tpu_torch", "train_agm.py"), "rb").read()
    assert not list(snap.rglob("__pycache__"))
