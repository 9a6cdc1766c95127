"""The port and chip_smoke.py import no JAX, flax, optax, msgpack or
igs_tpu, no PIL, imageio or OpenCV (the port carries its own codecs,
resize and undistortion), and no PyYAML at module level (the card's
machine may lack it), and every port module imports on a machine without
nvcc, triton or a card."""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "igs_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "flax", "optax", "igs_tpu", "PIL", "imageio",
          "msgpack", "cv2")


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


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_yaml(path):
    """PyYAML only inside the functions that read or write YAML text."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom)
              and n.module]
    assert "yaml" not in [m.split(".")[0] for m in names]


@pytest.mark.parametrize("module", [
    "igs_tpu_torch/train_agm.py", "igs_tpu_torch/train/driver.py",
    "igs_tpu_torch/config.py", "igs_tpu_torch/data/synthetic.py",
    "igs_tpu_torch/ops/blend_windowed.py"])
def test_training_slice_modules_are_checked(module):
    """The training slice's modules are among the files checked above, and
    none reads or writes images through PIL."""
    path = ROOT / module
    assert path in PORT_FILES
    assert not [m for m in _imports(path) if m.split(".")[0] == "PIL"]


@pytest.mark.parametrize("module", [
    "igs_tpu_torch/utils/devtime.py", "igs_tpu_torch/utils/profiling.py",
    "igs_tpu_torch/tools/segscan_fold.py",
    "igs_tpu_torch/tools/bench_segscan_fold.py",
    "igs_tpu_torch/tools/bench_segscan_kernel.py",
    "igs_tpu_torch/ops/render_tiles.py", "igs_tpu_torch/bench.py",
    "igs_tpu_torch/roofline.py", "igs_tpu_torch/profile_stages.py"])
def test_measurement_slice_modules_are_checked(module):
    """The measurement path's modules are among the files checked above,
    and none imports triton, which the card's build route does not use."""
    path = ROOT / module
    assert path in PORT_FILES
    assert not [m for m in _imports(path) if m.split(".")[0] == "triton"]


@pytest.mark.parametrize("module", [
    "igs_tpu_torch/infer_stream.py", "igs_tpu_torch/data/infer_data.py",
    "igs_tpu_torch/utils/resume.py", "igs_tpu_torch/stream/pipeline.py",
    "igs_tpu_torch/models/networks.py"])
def test_streaming_cli_slice_modules_are_checked(module):
    """The streaming CLI's modules are among the files checked above."""
    assert ROOT / module in PORT_FILES


@pytest.mark.parametrize("module", [
    "igs_tpu_torch/utils/flax_msgpack.py", "igs_tpu_torch/models/convert.py",
    "igs_tpu_torch/train/driver.py", "igs_tpu_torch/data/jpeg.py",
    "igs_tpu_torch/utils/saving.py", "igs_tpu_torch/models/renderer.py",
    "igs_tpu_torch/models/agm.py"])
def test_checkpoint_and_free_view_slice_modules_are_checked(module):
    """The native-checkpoint, free-view and flow modules are among the
    files checked above, and none reads or writes through PIL, imageio,
    flax or msgpack."""
    path = ROOT / module
    assert path in PORT_FILES
    assert not [m for m in _imports(path) if m.split(".")[0] in BANNED]


@pytest.mark.parametrize("module", [
    "igs_tpu_torch/train/lpips.py", "igs_tpu_torch/metrics.py",
    "igs_tpu_torch/data/jpeg.py", "igs_tpu_torch/data/images.py",
    "igs_tpu_torch/data/infer_data.py", "igs_tpu_torch/data/dataset.py",
    "igs_tpu_torch/models/convert.py", "igs_tpu_torch/train/driver.py"])
def test_lpips_and_jpeg_slice_modules_are_checked(module):
    """The LPIPS, metrics and JPEG-decoder modules are among the files
    checked above, and none reads images or weights through PIL, imageio,
    flax or the JAX package."""
    path = ROOT / module
    assert path in PORT_FILES
    assert not [m for m in _imports(path) if m.split(".")[0] in BANNED]


def test_every_port_module_imports():
    for path in PORT_FILES[:-1]:
        rel = path.relative_to(ROOT).with_suffix("")
        importlib.import_module(".".join(rel.parts).replace(".__init__", ""))


@pytest.mark.parametrize("module", [
    "igs_tpu_torch/parallel/__init__.py",
    "igs_tpu_torch/parallel/distributed.py",
    "igs_tpu_torch/parallel/mesh.py", "igs_tpu_torch/parallel/spmd.py",
    "igs_tpu_torch/parallel/launch.py", "igs_tpu_torch/build_frame0.py",
    "igs_tpu_torch/bench_scaling.py", "tests/torch_port_parallel_ranks.py"])
def test_parallel_slice_modules_are_checked(module):
    """The parallel paths' modules are among the files checked above, and
    the ranks' side of their tests imports no JAX either (each spawned
    rank would pay its import)."""
    path = ROOT / module
    assert path in PORT_FILES or path.parent.name == "tests"
    assert not [m for m in _imports(path) if m.split(".")[0] in BANNED]


@pytest.mark.parametrize("module", [
    "igs_tpu_torch/prepare_data.py", "igs_tpu_torch/data/colmap.py",
    "igs_tpu_torch/data/colmap_db.py", "igs_tpu_torch/data/resize.py",
    "igs_tpu_torch/data/undistort.py", "igs_tpu_torch/data/native.py",
    "igs_tpu_torch/ops/host_build.py", "igs_tpu_torch/utils/cache.py",
    "igs_tpu_torch/utils/saving.py", "igs_tpu_torch/graft_entry.py"])
def test_data_preparation_slice_modules_are_checked(module):
    """The data-preparation slice's modules are among the files checked
    above, and none reads, resizes or undistorts images through PIL or
    OpenCV, or imports the JAX package's ``data/colmap.py`` (which needs
    no JAX: the port keeps its own copy)."""
    path = ROOT / module
    assert path in PORT_FILES
    assert not [m for m in _imports(path) if m.split(".")[0] in BANNED]


PROBES = ("probe", "packed_test", "precision_check", "bench_blend",
          "profile_raster", "bench_parts", "bench_binning", "bench_binning2",
          "bench_binning3", "profile_bin_ablate", "bench_expand",
          "bench_segred", "bench_segred_ab", "bench_segred_loop",
          "bench_refine_loop", "profile_refine_ablate", "sweep",
          "bench_attn", "bench_attn2", "bench_swin", "bench_agm_bf16",
          "profile_agm_diff", "bench_agm_plucker", "bench_attn_variants")


@pytest.mark.parametrize("name", PROBES)
def test_probe_modules_are_checked(name):
    """The rasterizer, refine and AGM-Net probes of
    ``igs_tpu_torch/tools/`` are among the files checked above, none
    imports JAX, PIL, OpenCV or triton, and each imports on a machine
    without a card."""
    path = ROOT / "igs_tpu_torch" / "tools" / f"{name}.py"
    assert path in PORT_FILES
    assert not [m for m in _imports(path)
                if m.split(".")[0] in BANNED + ("triton",)]
    importlib.import_module(f"igs_tpu_torch.tools.{name}")


def test_no_port_module_names_sdpa():
    """No module of the port outside ``tools/`` names PyTorch's
    ``scaled_dot_product_attention``: the attention runs through the
    port's own kernels (``ops/attention.py``); the probes may time it as
    a library yardstick."""
    tools = ROOT / "igs_tpu_torch" / "tools"
    bad = [str(p.relative_to(ROOT))
           for p in sorted((ROOT / "igs_tpu_torch").rglob("*.py"))
           if tools not in p.parents
           and "scaled_dot_product_attention" in p.read_text()]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "igs_tpu_torch/ops/attention.py", "igs_tpu_torch/models/swin.py",
    "igs_tpu_torch/models/transformer1d.py"])
def test_attention_slice_modules_are_checked(module):
    """The attention's modules are among the files checked above, and
    none imports triton (the kernels are CUDA C++ built with nvcc)."""
    path = ROOT / module
    assert path in PORT_FILES
    assert not [m for m in _imports(path)
                if m.split(".")[0] in BANNED + ("triton",)]
