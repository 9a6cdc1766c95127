"""The segmented scan's layout probes (kernel B6): y = 2x over (rows, 16).

Counterpart of the kernels of ``tools/tools_bench_segscan_fold.py:26-70``.
The TPU probe walked the same 32 MiB three ways to ask what a 16-lane
row layout costs; ``csrc/segscan_fold.cu`` asks it of HBM on Hopper:

  * ``copy_folded``: the (rows/8, 128) view, a warp per 512-byte row;
  * ``copy_padded``: the (rows, 16) view, four threads per 64-byte row;
  * ``reshape``: slices staged through a ring of shared memory with
    bulk copies and scaled through their (·, 16) view.

The two copies launch one kernel body (the TPU probe's ``copy_kernel``),
the reshape the other (``reshape_kernel``). Their launch geometry is
computed here, from the row count and the card's SM count
(``copy_geometry``, ``reshape_geometry``), so the CPU tests can check
that it covers every 16-byte vector of x exactly once.

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
VEC_BYTES = 16  # one float4: the kernels' unit of work
THREADS = 256  # threads per block of both kernels
# The geometry below read fastest among the candidates measured on an H100
# (PERF.md, Findings).
COPY_VECS = (4, 2, 1)  # float4 loads in flight per thread, most first
SLICE_VEC = 512  # float4 per ring stage of the reshape: 8 KiB
STAGES = 14  # ring stages: 112 KiB of shared memory a block
RESHAPE_BLOCKS_PER_SM = 2  # the reshape's persistent grid


def _vectors(rows: int) -> int:
    if rows <= 0 or rows % ROWS_QUANTUM:
        raise ValueError(f"rows must be a positive multiple of "
                         f"{ROWS_QUANTUM}, got {rows}")
    return rows * LANES * 4 // VEC_BYTES


@functools.lru_cache(maxsize=None)
def copy_geometry(rows: int, sms: int):
    """(vec, threads, blocks) of the copy kernel: block b's thread t owns
    the 16-byte vectors b·vec·threads + k·threads + t for k < vec, and the
    blocks cover the tensor once. vec is the most loads in flight per
    thread that still gives every SM a block."""
    n_vec = _vectors(rows)
    for vec in COPY_VECS:
        blocks = n_vec // (vec * THREADS)
        if blocks >= sms:
            break
    return vec, THREADS, blocks


@functools.lru_cache(maxsize=None)
def reshape_geometry(rows: int, sms: int):
    """(slice_vec, stages, threads, blocks) of the reshape kernel: the
    tensor is cut in slices of slice_vec 16-byte vectors, block b walks
    slices b, b + blocks, ... through a ring of ``stages`` slices, and its
    thread t scales vectors t, t + threads, ... of each slice."""
    n_slices = _vectors(rows) // SLICE_VEC
    return (SLICE_VEC, STAGES, THREADS,
            min(n_slices, RESHAPE_BLOCKS_PER_SM * sms))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    ptrs = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    fns = {}
    for name in VARIANTS:
        fn = getattr(lib, f"igs_fold_{name}")
        geometry = ([ctypes.c_int] * 3 if name == "reshape"
                    else [ctypes.c_int] * 2)
        fn.argtypes = ptrs + geometry + [ctypes.c_longlong, ctypes.c_void_p]
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
    rows, sms = x.shape[0], _sms(x.device.index)
    geometry = (reshape_geometry(rows, sms) if name == "reshape"
                else copy_geometry(rows, sms))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fns[name](x.data_ptr(), y.data_ptr(), rows, *geometry, stream)
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
    """B6b: the same kernel body through the (rows, 16) view."""
    y = _launch("copy_padded", x)
    copy_padded_cuda.launches += 1
    return y


def reshape_cuda(x: torch.Tensor) -> torch.Tensor:
    """B6c: the kernel staging slices through a ring of shared memory."""
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
