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
from igs_tpu_torch.tools.bench_segscan_fold import make_input

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
