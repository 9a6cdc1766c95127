"""What runs on the card imports neither JAX nor the JAX package, compared
by whole top-level names (so that ``igs_tpu_torch`` passes), and the
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from igs_bench import run as bench_run

HERE = bench_run.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "igs_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


ON_CARD = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", ON_CARD,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_by_top_level_name(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert "igs_tpu_torch" not in tops and not tops & FORBIDDEN


def test_reference_loads_no_program_module():
    code = ("import sys, igs_bench.reference.models.agm, "
            "igs_bench.reference.stream.refine, "
            "igs_bench.reference.ops.anchors, igs_bench.compare, "
            "igs_bench.scene, igs_bench.flops; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('igs_tpu_torch', 'igs_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=bench_run.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "igs_tpu_torch_fake", sys)
    assert "igs_tpu_torch_fake" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.fake", sys)
    assert "jax.fake" in bench_run.forbidden_modules()
