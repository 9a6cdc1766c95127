"""Softmax attention over (B, H, L, C) tensors: the AGM-Net triplane
encoder's multi-head attention and the feature transformer's window
attention.

Counterpart of the JAX package's two attention routes: on its TPU the
Pallas flash-attention kernel (``igs_tpu/models/transformer1d.py:88``,
``igs_tpu/models/swin.py:150``, with the swin shift mask as
``SegmentIds``) and its dkv/dq kernels under ``jax.grad``; off the TPU
the query-chunked einsums (``transformer1d.py:95-113``). Both compute

    o = softmax(scale · q kᵀ, keys of the query's region) · v

with the scores and the softmax in float32 and P cast to v's type before
the P·V product. ``region_ids`` (an int32 (H, L) table, broadcast over B)
lets a query attend only to keys of its own id; swin passes its K²
windows as H and ``shift_window_region_ids`` as the table.

``attention`` on a CUDA tensor launches ``csrc/attention.cu``: the
forward (B7) through ``attention_fwd_cuda``, which also returns the row
log-sum-exp, and in the backward (B8) D = rowsum(dO ∘ O), the dK/dV and
the dQ kernels through ``attention_bwd_cuda``. On a CPU tensor it takes
the plain version ``attention_plain`` (exact, chunks of 1024 queries,
autograd through plain ops). Masked keys
are excluded (−inf before the softmax); the JAX XLA route's additive −100
differs from that by at most e^-100 relative while a row's scores spread
by less than ~80 (``tests/test_torch_port_attention.py`` holds the two
together).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch

from igs_tpu_torch.utils.profiling import launched

DTYPES = (torch.float32, torch.bfloat16)
# the forward kernel's tiles (queries x keys), the TPU route's BlockSizes
# counterpart: 64 or 128 queries (one or two bf16 warpgroups, four or
# eight f32 warps); the backward's tiles are fixed (csrc/attention.cu
# DqBf16, DkvBf16, DqF32, DkvF32)
TILES = ((64, 64), (128, 64), (128, 128))
# the fastest tile of each type at the triplane shape (5, 8, 8192, 64) on
# an H100 (PERF.md: the bench_attn sweep)
DEFAULT_BLOCK = {torch.float32: (128, 64), torch.bfloat16: (128, 64)}
QUERY_CHUNK = 1024  # the plain version's query chunk (transformer1d.py:46)


def _check(q, k, v, region_ids) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"attention: {name} must be (B, H, L, C), got "
                             f"{tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"attention: {name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"attention: q, k and v must share one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"attention: q, k and v must share one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("attention: q, k and v must be on one device")
    c = q.shape[-1]
    if c % 16 or not 16 <= c <= 128:
        raise ValueError(f"attention: head dim {c} is not a multiple of 16 "
                         "in [16, 128]")
    if region_ids is not None:
        if region_ids.dtype != torch.int32:
            raise TypeError(f"attention: region_ids must be int32, got "
                            f"{region_ids.dtype}")
        if tuple(region_ids.shape) != (q.shape[1], q.shape[2]):
            raise ValueError(f"attention: region_ids must be (H, L) = "
                             f"{(q.shape[1], q.shape[2])}, got "
                             f"{tuple(region_ids.shape)}")
        if region_ids.device != q.device:
            raise ValueError("attention: region_ids must be on q's device")


def attention_plain(q, k, v, scale: float,
                    region_ids: Optional[torch.Tensor] = None,
                    chunk: int = QUERY_CHUNK) -> torch.Tensor:
    """The same function in plain PyTorch: float32 scores over chunks of
    ``chunk`` queries, masked keys excluded, a float32 softmax cast to
    v's type, then P·V in v's type."""
    _check(q, k, v, region_ids)
    kt = k.float().transpose(-1, -2)
    outs = []
    for s0 in range(0, q.shape[2], chunk):
        s = torch.matmul(q[:, :, s0:s0 + chunk].float(), kt) * scale
        if region_ids is not None:
            same = region_ids[:, s0:s0 + chunk, None] == region_ids[:, None, :]
            s = s.masked_fill(~same, float("-inf"))
        outs.append(torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v))
    return torch.cat(outs, dim=2)


def _cuda_args(name, tensors, device):
    for label, t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: {label} must be on {device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")


def _geometry(q):
    b, h, length, c = q.shape
    if b * h > 65535:
        raise ValueError(f"attention: B·H = {b * h} is over the kernel "
                         "grid's 65535")
    return b * h, h, length, c


def attention_fwd_cuda(q, k, v, scale: float,
                       region_ids: Optional[torch.Tensor] = None,
                       block: Optional[Tuple[int, int]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B7 on the current stream → (o in q's type, the row
    log-sum-exp (B, H, L) float32). ``block`` is the (queries, keys)
    tile, one of ``TILES``."""
    _check(q, k, v, region_ids)
    _cuda_args("attention_fwd_cuda", (("q", q), ("k", k), ("v", v),
                                      ("region_ids", region_ids)), q.device)
    block = tuple(block or DEFAULT_BLOCK[q.dtype])
    if block not in TILES:
        raise ValueError(f"attention: block {block} is not one of {TILES}")
    bh, h, length, c = _geometry(q)
    lib = _kernels()
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib["fwd"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if region_ids is None else region_ids.data_ptr(),
            o.data_ptr(), lse.data_ptr(), bh, h, length, c, float(scale),
            int(q.dtype == torch.bfloat16), TILES.index(block), stream)
    if err != 0:
        raise RuntimeError("attention forward launch failed: "
                           + lib["error_string"](err).decode())
    launched(attention_fwd_cuda)
    return o, lse


# launches since the last reset (chip_smoke.py resets it before each path)
attention_fwd_cuda.launches = 0


def attention_bwd_cuda(q, k, v, out, lse, dout, scale: float,
                       region_ids: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch B8 (D = rowsum(dout ∘ out) in float32, then the dK/dV
    kernel, then the dQ kernel) on the current stream → (dq, dk, dv) in
    q's type. ``lse`` is the forward's."""
    _check(q, k, v, region_ids)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("attention backward: out and dout must have q's "
                         "shape")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError("attention backward: out and dout must have q's "
                        "dtype")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError("attention backward: lse must be (B, H, L) float32")
    _cuda_args("attention_bwd_cuda",
               (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout),
                ("lse", lse), ("region_ids", region_ids)), q.device)
    bh, h, length, c = _geometry(q)
    lib = _kernels()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    bf16 = int(q.dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib["delta"](out.data_ptr(), dout.data_ptr(),
                           delta.data_ptr(), bh * length, c, bf16, stream)
        if err == 0:
            err = lib["bwd"](
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if region_ids is None else region_ids.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, h, length,
                c, float(scale), bf16, stream)
    if err != 0:
        raise RuntimeError("attention backward launch failed: "
                           + lib["error_string"](err).decode())
    launched(attention_bwd_cuda)
    return dq, dk, dv


attention_bwd_cuda.launches = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# csrc/attention.cu's C entry points: (argument types, result type)
SIGNATURES = {
    "fwd": ([_P] * 6 + [_I] * 4 + [_F, _I, _I, _P], _I),
    "bwd": ([_P] * 10 + [_I] * 4 + [_F, _I, _P], _I),
    "delta": ([_P] * 3 + [_I] * 3 + [_P], _I),
    "count_tiles": ([_I], _I),
    "tile_pairs": ([ctypes.POINTER(ctypes.c_ulonglong)], _I),
}


def bind(lib: ctypes.CDLL) -> dict:
    """{name: typed function} of the ``SIGNATURES`` entries
    (``igs_attention_<name>``) that a library built from a version of
    ``csrc/attention.cu`` exports, and ``error_string``."""
    out = {}
    for name, (args, res) in SIGNATURES.items():
        try:
            fn = getattr(lib, f"igs_attention_{name}")
        except AttributeError:
            continue
        fn.argtypes, fn.restype = args, res
        out[name] = fn
    err = lib.igs_cuda_error_string
    err.argtypes, err.restype = [_I], ctypes.c_char_p
    out["error_string"] = err
    return out


@functools.lru_cache(maxsize=None)
def _kernels() -> dict:
    from igs_tpu_torch.ops.cuda_build import load

    return bind(load("attention.cu"))


@contextlib.contextmanager
def counting_tile_pairs(device):
    """Count, while the block runs, the tiles that the kernels list under
    region ids (``csrc/attention.cu``'s ``live_tiles``). Yields a dict
    that is filled on exit: ``{"fwd" | "dkv" | "dq": [listed, all]}``,
    the (block, tile) pairs summed over every launch, all zero for a
    kernel that ran no launch with ids. For check runs: counting adds an
    atomic a block."""
    lib = _kernels()

    def call(name, *args):
        err = lib[name](*args)
        if err:
            raise RuntimeError("attention: tile counting failed: "
                               + lib["error_string"](err).decode())

    counts = {}
    out = (ctypes.c_ulonglong * 6)()
    torch.cuda.synchronize(device)
    with torch.cuda.device(device):
        call("count_tiles", 1)
        try:
            yield counts
        finally:
            torch.cuda.synchronize(device)
            call("count_tiles", 0)
        call("tile_pairs", out)
    counts.update({kind: [int(out[2 * i]), int(out[2 * i + 1])]
                   for i, kind in enumerate(("fwd", "dkv", "dq"))})


class _Attention(torch.autograd.Function):
    """B7 forward saving the row log-sum-exp; B8 backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, region_ids):
        out, lse = attention_fwd_cuda(q, k, v, scale, region_ids)
        ctx.save_for_backward(q, k, v, out, lse, region_ids)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, region_ids = ctx.saved_tensors
        dq, dk, dv = attention_bwd_cuda(q, k, v, out, lse, dout.contiguous(),
                                        ctx.scale, region_ids)
        return dq, dk, dv, None, None


def attention(q, k, v, scale: float,
              region_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(scale · q kᵀ) v over (B, H, L, C) tensors → (B, H, L, C) in
    q's type; with ``region_ids`` (H, L) int32 a query sees only the keys
    of its own id.

    A CUDA tensor goes to the kernels (B7 at its type's
    ``DEFAULT_BLOCK``, and B8 under autograd), a CPU tensor to the plain
    version."""
    _check(q, k, v, region_ids)
    if q.is_cuda:
        return _Attention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), float(scale), region_ids)
    if q.device.type != "cpu":
        raise ValueError(f"attention: no route for device {q.device}")
    return attention_plain(q, k, v, scale, region_ids)
