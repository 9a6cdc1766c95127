"""The host data plane: threaded batch PNG decoding and the PLY vertex
reader, through the port's C++ library (``csrc/host/igsio.cpp``).

Counterpart of ``igs_tpu/data/native.py``. The JAX loader uses a library
built beforehand (``make -C native``) when it finds one and PIL
otherwise; the port builds its library at first use
(``ops/host_build.py``): a failed build raises. As in the JAX loader, a
batch that holds a file the library does not read (a JPEG, or a
palette, 1-, 2- or 4-bit or Adam7 PNG) decodes whole through
``data/images.read_image``, whose pixels are PIL's; a truncated, corrupt
or wrong-size PNG raises naming the file and the decoder's reason. The
library's pixels are the numpy codec's samples (``data/images.
decode_png``) bit for bit: each sample as float32 times ``scale`` as
float32.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from igs_tpu_torch.ops import host_build

SOURCE = "igsio.cpp"

_REASONS = {
    -1: "no PNG signature", -2: "a chunk runs past the end of the file",
    -3: "no size or interlaced", -4: "a palette or unknown colour type",
    -5: "a bit depth other than 8 or 16", -6: "zlib refused the data",
    -7: "out of memory", -8: "an unknown scanline filter",
    -100: "the file cannot be read", -101: "a size other than the batch's",
}


def _lib() -> ctypes.CDLL:
    lib = host_build.load(SOURCE)
    if not getattr(lib, "_igs_bound", False):
        lib.igsio_load_png_batch_status.restype = ctypes.c_int
        lib.igsio_load_png_batch_status.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.igsio_ply_info.restype = ctypes.c_int
        lib.igsio_ply_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_long)]
        lib.igsio_ply_read.restype = ctypes.c_int
        lib.igsio_ply_read.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long]
        lib._igs_bound = True
    return lib


def native_available() -> bool:
    """True once the library is built and loaded; a failed build raises
    (the JAX helper answers False and falls back to PIL)."""
    return _lib() is not None


# the library's refusals for a file's kind (palette, low bit depth,
# Adam7), which the JAX loader answers by decoding the batch through PIL
_KIND_REFUSALS = (-4, -5)


def _decode_pngs(paths: Sequence[str], out: np.ndarray, scale: float,
                 threads: int) -> bool:
    """Decode PNGs into ``out`` on the library's threads; False where the
    library refused only files of a kind it does not read, which the
    caller then decodes as PIL does. Any other refusal raises naming the
    file and the reason."""
    n, channels, height, width = out.shape
    lib = _lib()
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    status = np.zeros(n, np.int32)
    failed = lib.igsio_load_png_batch_status(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height, width, channels, ctypes.c_float(scale), threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if not failed:
        return True
    bad = [(p, int(s)) for p, s in zip(paths, status) if s]
    if all(s in _KIND_REFUSALS or (s == -3 and _interlaced(p))
           for p, s in bad):
        return False
    raise ValueError(f"{failed} of {n} PNGs refused by the decoder "
                     f"(batch {height}x{width}x{channels}): "
                     + "; ".join(f"{p}: {_REASONS.get(s, f'code {s}')}"
                                 for p, s in bad))


def _interlaced(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(29)
    return len(head) == 29 and head[12:16] == b"IHDR" and head[28] == 1


def load_images_nchw(paths: Sequence[str], height: int, width: int,
                     channels: int = 3, scale: float = 1.0 / 255.0,
                     threads: int = 0) -> np.ndarray:
    """(N, C, H, W) float32 batch, pixel values times ``scale``, as the
    JAX loader gives it: an all-PNG batch on the library's ``threads``
    threads (0: one a core), its samples; a batch with a file that is
    not a PNG, or a PNG of a kind the library does not read, whole
    through ``read_image`` (PIL's pixels: a 16-bit colour file then gives
    its high byte, a palette file its indices); grey repeats into every
    channel."""
    from igs_tpu_torch.data.images import read_image

    paths = [os.fspath(p) for p in paths]
    out = np.empty((len(paths), channels, height, width), np.float32)
    if all(os.path.splitext(p)[1].lower() == ".png" for p in paths) \
            and _decode_pngs(paths, out, scale, threads):
        return out
    for i, path in enumerate(paths):
        img = read_image(path)
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[:2] != (height, width):
            raise ValueError(f"{path}: {img.shape[1]}x{img.shape[0]} "
                             f"image in a {width}x{height} batch")
        img = img[:, :, :channels]
        if img.shape[2] < channels:
            img = np.repeat(img[:, :, :1], channels, axis=2)
        out[i] = img.astype(np.float32).transpose(2, 0, 1) * np.float32(
            scale)
    return out


def read_ply_fast(path: str) -> Optional[np.ndarray]:
    """The vertex block of a binary little-endian PLY as a structured
    array (one field a property, in the file's order), or None where the
    library cannot read the header (an ASCII PLY, a property type it does
    not know): the caller then reads with ``data/ply.read_ply_vertices``,
    as the JAX callers do."""
    lib = _lib()
    count = ctypes.c_long()
    stride = ctypes.c_int()
    props = ctypes.create_string_buffer(16384)
    offset = ctypes.c_long()
    rc = lib.igsio_ply_info(os.fsencode(path), ctypes.byref(count),
                            ctypes.byref(stride), props, len(props),
                            ctypes.byref(offset))
    if rc != 0:
        return None
    fields = [tuple(p.split(":")) for p in props.value.decode().split(";")
              if p]
    dtype = np.dtype([(name, "<" + dt) for name, dt in fields])
    if dtype.itemsize != stride.value:
        raise ValueError(f"{path}: PLY stride {stride.value} but the "
                         f"properties take {dtype.itemsize} bytes")
    buf = np.empty(count.value, dtype=dtype)
    rc = lib.igsio_ply_read(os.fsencode(path), offset,
                            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            count.value * stride.value)
    return buf if rc == 0 else None
