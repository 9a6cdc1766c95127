"""The port and chip_smoke.py import no JAX, flax or igs_tpu, and every
port module imports on a machine without nvcc, triton or a card."""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "igs_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "flax", "igs_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("module", [
    "igs_tpu_torch/build_frame0.py", "igs_tpu_torch/train/frame0.py",
    "igs_tpu_torch/ops/count.py", "igs_tpu_torch/data/dataset.py",
    "igs_tpu_torch/data/images.py", "igs_tpu_torch/data/ply.py",
    "igs_tpu_torch/utils/saving.py"])
def test_frame0_slice_modules_are_checked(module):
    """The frame-0 slice's modules are among the files checked above, and
    none reads images through PIL (the card's machine has no PIL)."""
    path = ROOT / module
    assert path in PORT_FILES
    assert not [m for m in _imports(path) if m.split(".")[0] == "PIL"]


def test_every_port_module_imports():
    for path in PORT_FILES[:-1]:
        rel = path.relative_to(ROOT).with_suffix("")
        importlib.import_module(".".join(rel.parts).replace(".__init__", ""))
