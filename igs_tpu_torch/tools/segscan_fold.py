"""The segmented scan's layout probes (kernel B6): y = 2x over (rows, 16).

Counterpart of the kernels of ``tools/tools_bench_segscan_fold.py:26-70``.
The TPU probe walked the same 32 MiB three ways to ask what a 16-lane
row layout costs; ``csrc/segscan_fold.cu`` asks it of HBM on Hopper:

  * ``copy_folded``: the (rows/8, 128) view, a warp per 512-byte row;
  * ``copy_padded``: the (rows, 16) view, a thread per 64-byte row;
  * ``reshape``: (512, 128) blocks staged through shared memory and
    scaled through their (·, 16) view.

Each variant has a wrapper that launches the kernel on a CUDA tensor
(``*_cuda``, with a launch counter), a plain PyTorch version that repeats
the TPU probe's reshapes (``*_plain``), and a dispatcher that takes the
kernel for a CUDA tensor and the plain version for a CPU tensor.
``library_mul`` is the one PyTorch call that computes the same function,
the yardstick of the kernel table; the port never calls it otherwise. ×2
is exact in float32, so all of them agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

LANES = 16  # the segscan row
FOLD = 128  # the folded row: 8 segscan rows
ROWS_QUANTUM = 4096  # rows of one (512, 128) block of the TPU probe
VARIANTS = ("copy_folded", "copy_padded", "reshape")


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] != LANES or x.dtype != torch.float32:
        raise ValueError(f"x must be a float32 (rows, {LANES}) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[0] % ROWS_QUANTUM:
        raise ValueError(f"rows must be a multiple of {ROWS_QUANTUM}, got "
                         f"{x.shape[0]}")


@functools.lru_cache(maxsize=None)
def _kernels():
    from igs_tpu_torch.ops.cuda_build import load

    lib = load("segscan_fold.cu")
    fns = {}
    for name in VARIANTS:
        fn = getattr(lib, f"igs_fold_{name}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    lib.igs_fold_rows_quantum.restype = ctypes.c_longlong
    if lib.igs_fold_rows_quantum() != ROWS_QUANTUM:
        raise RuntimeError("segscan_fold.cu and its wrapper disagree on the "
                           "row quantum")
    err = lib.igs_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fns, err


def _launch(name: str, x: torch.Tensor) -> torch.Tensor:
    _check(x)
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    fns, error_string = _kernels()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fns[name](x.data_ptr(), y.data_ptr(), x.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"segscan_fold {name} launch failed: "
                           + error_string(err).decode())
    return y


def copy_folded_cuda(x: torch.Tensor) -> torch.Tensor:
    """B6a: the kernel through the (rows/8, 128) view → (rows, 16)."""
    y = _launch("copy_folded", x)
    copy_folded_cuda.launches += 1
    return y


def copy_padded_cuda(x: torch.Tensor) -> torch.Tensor:
    """B6b: the kernel through the (rows, 16) view → (rows, 16)."""
    y = _launch("copy_padded", x)
    copy_padded_cuda.launches += 1
    return y


def reshape_cuda(x: torch.Tensor) -> torch.Tensor:
    """B6c: the kernel staging (512, 128) blocks through shared memory."""
    y = _launch("reshape", x)
    reshape_cuda.launches += 1
    return y


# launches since the last reset
copy_folded_cuda.launches = 0
copy_padded_cuda.launches = 0
reshape_cuda.launches = 0


def copy_folded_plain(x: torch.Tensor) -> torch.Tensor:
    """run_copy_folded in plain PyTorch: ×2 through the (rows/8, 128) view."""
    _check(x)
    return (x.reshape(-1, FOLD) * 2.0).reshape(x.shape)


def copy_padded_plain(x: torch.Tensor) -> torch.Tensor:
    """run_copy_padded in plain PyTorch: ×2 on the (rows, 16) rows."""
    _check(x)
    return x * 2.0


def reshape_plain(x: torch.Tensor) -> torch.Tensor:
    """run_reshape in plain PyTorch: fold, unfold to (·, 16), ×2, refold."""
    _check(x)
    z = x.reshape(-1, FOLD).reshape(-1, LANES) * 2.0
    return z.reshape(-1, FOLD).reshape(x.shape)


def library_mul(x: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call that computes the same function."""
    return torch.mul(x, 2.0)


def _dispatch(kernel, plain, x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return kernel(x)
    if x.device.type != "cpu":
        raise ValueError(f"no segscan_fold kernel for device {x.device}")
    return plain(x)


def copy_folded(x: torch.Tensor) -> torch.Tensor:
    return _dispatch(copy_folded_cuda, copy_folded_plain, x)


def copy_padded(x: torch.Tensor) -> torch.Tensor:
    return _dispatch(copy_padded_cuda, copy_padded_plain, x)


def reshape(x: torch.Tensor) -> torch.Tensor:
    return _dispatch(reshape_cuda, reshape_plain, x)
