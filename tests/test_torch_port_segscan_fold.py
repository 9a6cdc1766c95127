"""Kernel B6, the segscan layout probes: the port's plain versions against
the JAX tool's own kernels.

``tools/tools_bench_segscan_fold.py:main`` runs at its full size, (2^19,
16) float32, with ``pl.pallas_call`` in interpret mode and
``timeit_device`` replaced by a recorder that evaluates ``fn(*args)``
once. ×2 is exact in float32, so the port's input must equal the JAX
tool's and every plain version (and ``torch.mul``) its kernel's output
bit for bit. The CUDA wrappers run only on the card (``chip_smoke.py``);
here they must refuse CPU tensors and leave their counters alone.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import jax
import pytest
import torch
from jax.experimental import pallas as pl

import igs_tpu.utils.devtime as jax_devtime
from igs_tpu_torch.tools import segscan_fold
from igs_tpu_torch.tools.bench_segscan_fold import (
    bound_ms, check_bound, cold_inputs, make_input, summary)
from igs_tpu_torch.utils import h100
from igs_tpu_torch.utils.devtime import rotation_ms

torch.set_num_threads(2)

TOOL = (pathlib.Path(__file__).resolve().parents[1] / "tools"
        / "tools_bench_segscan_fold.py")


@pytest.fixture(scope="module")
def jax_tool_run():
    """[(x, out)] of the JAX tool's three timed calls, in order."""
    spec = importlib.util.spec_from_file_location("jax_segscan_fold", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    recorded = []

    def recorder(fn, *args, **kw):
        recorded.append((np.asarray(args[0]), np.asarray(fn(*args))))
        return 0.0

    cache_dir = jax.config.jax_compilation_cache_dir
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call,
                                                    interpret=True))
    mp.setattr(jax_devtime, "timeit_device", recorder)
    try:
        tool.main()
    finally:
        mp.undo()
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    assert len(recorded) == 3, "the JAX tool's in-kernel reshape failed"
    return recorded


def test_port_input_equals_the_jax_tools(jax_tool_run):
    x = make_input()
    for xj, _ in jax_tool_run:
        np.testing.assert_array_equal(x, xj)


@pytest.mark.parametrize("i,variant", list(enumerate(segscan_fold.VARIANTS)))
def test_plain_version_equals_the_jax_kernel(jax_tool_run, i, variant):
    xj, want = jax_tool_run[i]
    x = torch.from_numpy(xj.copy())
    plain = getattr(segscan_fold, f"{variant}_plain")(x)
    np.testing.assert_array_equal(plain.numpy(), want)
    # the dispatcher takes the plain version for a CPU tensor
    np.testing.assert_array_equal(getattr(segscan_fold, variant)(x).numpy(),
                                  want)
    np.testing.assert_array_equal(segscan_fold.library_mul(x).numpy(), want)


@pytest.mark.parametrize("variant", segscan_fold.VARIANTS)
def test_cuda_wrapper_refuses_cpu_tensors(variant):
    kernel = getattr(segscan_fold, f"{variant}_cuda")
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel(torch.zeros((4096, 16)))
    assert kernel.launches == before


@pytest.mark.parametrize("shape,dtype", [((4096, 32), torch.float32),
                                         ((4000, 16), torch.float32),
                                         ((4096, 16), torch.float64)])
def test_wrappers_refuse_shapes_the_kernel_does_not_take(shape, dtype):
    x = torch.zeros(shape, dtype=dtype)
    for variant in segscan_fold.VARIANTS:
        with pytest.raises(ValueError):
            getattr(segscan_fold, variant)(x)


# --- the launch geometry the wrappers compute -----------------------------
# Rows: one TPU block, the probe's size, and an odd multiple of the
# quantum; SMs: the H100 SXM's 132 and the PCIe part's 114.
GEOMETRY_ROWS = [segscan_fold.ROWS_QUANTUM, 1 << 19,
                 33 * segscan_fold.ROWS_QUANTUM]
GEOMETRY_SMS = [132, 114]


def _once_each(idx, n_vec):
    """Every one of the n_vec 16-byte vectors appears exactly once."""
    assert idx.min() >= 0 and idx.max() < n_vec
    assert (np.bincount(idx, minlength=n_vec) == 1).all()


def _copy_covers_once(rows, geometry):
    """fold_scale's map (csrc/segscan_fold.cu): block b's thread t loads,
    then stores, the vectors b·vec·threads + k·threads + t for k < vec.
    Each lane of a warp takes the next 16 bytes, so every warp instruction
    is 512 contiguous bytes."""
    vec, threads, blocks = geometry
    n_vec = rows * segscan_fold.LANES // 4
    assert vec in (1, 2, 4) and threads % 32 == 0 and threads <= 512
    b, k, t = np.meshgrid(np.arange(blocks), np.arange(vec),
                          np.arange(threads), indexing="ij")
    idx = b * vec * threads + k * threads + t
    _once_each(idx.ravel(), n_vec)
    warps = idx.reshape(blocks, vec, threads // 32, 32)
    assert (np.diff(warps, axis=-1) == 1).all()


def _reshape_covers_once(rows, geometry, sms):
    """fold_reshape's walk: block b takes slices b, b + blocks, ...; slice
    k of a block goes through ring stage k % stages, is loaded and stored
    whole, and its thread t scales vectors t, t + threads, ... The ring
    fits a block's 227 KiB of shared memory, a slice divides the TPU
    block (so the slices tile every row count the wrapper takes), and
    every block of the persistent grid has a slice."""
    slice_vec, stages, threads, blocks = geometry
    n_vec = rows * segscan_fold.LANES // 4
    quantum_vec = segscan_fold.ROWS_QUANTUM * segscan_fold.LANES // 4
    assert quantum_vec % slice_vec == 0 and slice_vec % threads == 0
    assert 2 <= stages <= 16 and stages * slice_vec * 16 <= 227 * 1024
    n_slices = n_vec // slice_vec
    assert 1 <= blocks <= n_slices
    walked = [np.arange(b, n_slices, blocks) for b in range(blocks)]
    assert all(len(w) for w in walked)
    slices = np.concatenate(walked)
    _once_each(slices, n_slices)  # each slice loaded and stored once
    lanes = np.arange(0, slice_vec, threads)[:, None] + np.arange(threads)
    idx = slices[:, None] * slice_vec + lanes.ravel()[None, :]
    _once_each(idx.ravel(), n_vec)  # each vector scaled once


@pytest.mark.parametrize("sms", GEOMETRY_SMS)
@pytest.mark.parametrize("rows", GEOMETRY_ROWS)
def test_copy_geometry_covers_every_vector_once(rows, sms):
    """The wrapper's copy geometry: every vector once, warp-contiguous;
    at the probe's size four loads in flight per thread and every SM a
    block."""
    vec, threads, blocks = segscan_fold.copy_geometry(rows, sms)
    _copy_covers_once(rows, (vec, threads, blocks))
    assert blocks >= sms or vec == 1
    if rows == 1 << 19:
        assert vec >= 4 and blocks == (1 << 21) // (vec * threads)


@pytest.mark.parametrize("sms", GEOMETRY_SMS)
@pytest.mark.parametrize("rows", GEOMETRY_ROWS)
def test_reshape_geometry_covers_every_vector_once(rows, sms):
    """The wrapper's reshape geometry: every vector once, and a persistent
    grid of at most two blocks per SM whose rings fit the SM's 228 KiB of
    shared memory together (1 KiB reserved a block)."""
    geometry = segscan_fold.reshape_geometry(rows, sms)
    _reshape_covers_once(rows, geometry, sms)
    slice_vec, stages, _, blocks = geometry
    assert blocks <= 2 * sms
    per_sm = segscan_fold.RESHAPE_BLOCKS_PER_SM
    assert per_sm * (stages * slice_vec * 16 + 1024 + 128) <= 228 * 1024


@pytest.mark.parametrize("rows", [0, 4000, 4096 + 2048])
def test_geometry_refuses_rows_the_kernels_do_not_take(rows):
    for geometry in (segscan_fold.copy_geometry,
                     segscan_fold.reshape_geometry):
        with pytest.raises(ValueError, match="multiple"):
            geometry(rows, 132)


@pytest.mark.parametrize("shape,dtype", [((4096, 32), torch.float32),
                                         ((4000, 16), torch.float32),
                                         ((4096, 16), torch.float64)])
@pytest.mark.parametrize("variant", segscan_fold.VARIANTS)
def test_cuda_wrappers_refuse_shapes_the_kernel_does_not_take(variant,
                                                              shape, dtype):
    """Shape, width and dtype are refused before the device is looked at,
    and no launch is counted."""
    kernel = getattr(segscan_fold, f"{variant}_cuda")
    before = kernel.launches
    with pytest.raises(ValueError, match="rows|float32"):
        kernel(torch.zeros(shape, dtype=dtype))
    assert kernel.launches == before


# --- the B6 readings' guard -----------------------------------------------


def test_bytes_bound_and_its_guard():
    """(2^19, 16) f32 read once and written once at 3.35 TB/s: 0.0200 ms.
    A reading faster than 1.05 of that is a timing fault and raises; a
    torch.mul reading of 0.0256 ms on an H100 at 700 W is 78 % of it."""
    x = torch.zeros((1 << 19, 16))
    bound = bound_ms(x)
    assert bound == pytest.approx(2 * 32 * 2**20 / 3.35e12 * 1e3)
    assert check_bound("torch.mul", 0.0256, bound) == pytest.approx(
        bound / 0.0256)
    check_bound("at the bound", bound / 1.05, bound)
    with pytest.raises(RuntimeError, match="timing is wrong"):
        check_bound("past the bound", bound / 1.06, bound)


@pytest.mark.parametrize("nbytes,flops,by", [
    (2 * 32 * 2**20, 0, "bytes"), (3.35e12, 67e12, "bytes"),
    (1e6, 67e9, "operations")])
def test_h100_bound_is_the_larger_time(nbytes, flops, by):
    """The bound of every kernel line: bytes over 3.35 TB/s or float32
    operations over 67 TFLOP/s, whichever takes longer (bytes on a tie)."""
    ms, bound_by = h100.bound(nbytes, flops)
    assert ms == pytest.approx(1e3 * max(nbytes / 3.35e12, flops / 67e12))
    assert bound_by == by


def test_rotation_inputs_are_distinct_and_readings_summarised():
    """The rotation's seeds 1, 2, ... give inputs other than the probe's
    RandomState(0) x, on the device asked for; a summary is the median and
    spread of a reading."""
    xs = [make_input(4096, seed=s) for s in range(3)]
    np.testing.assert_array_equal(xs[0], make_input(4096))
    assert not np.array_equal(xs[1], xs[0]) and not np.array_equal(
        xs[2], xs[1])
    rotation = cold_inputs(torch.device("cpu"), mp=4096, rotation=2)
    assert [x.device.type for x in rotation] == ["cpu", "cpu"]
    for x, want in zip(rotation, xs[1:]):
        np.testing.assert_array_equal(x.numpy(), want)
    assert summary([3.0, 1.0, 2.0, 5.0]) == {"median": 2.5, "min": 1.0,
                                             "max": 5.0, "n": 4}


def test_rotation_timer_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rotation_ms({"mul": segscan_fold.library_mul},
                    [torch.zeros((4096, 16))])
