"""PNG reading and writing with numpy and ``zlib``, image reading by
suffix (PNG or JPEG), and the batched image loader of the datasets
(``load_images_nchw``, which decodes PNG batches through the host
library of ``data/native.py``).

The port carries its own codecs so that it needs no PIL. It reads
non-interlaced 8- and 16-bit grey, grey+alpha, RGB and RGBA PNGs (all
five scanline filters), and writes 8-bit RGB and 16-bit grey with filter 0; JPEGs
decode through ``data/jpeg.decode_jpeg`` (baseline, PIL's pixels).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

from igs_tpu_torch.data.jpeg import decode_jpeg, jpeg_size

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type → channels


def _unfilter(rows: np.ndarray, height: int, stride: int,
              bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: (H, 1 + stride) → (H, stride) u8."""
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per byte of the pixel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            lv = line.astype(np.int32).reshape(-1, bpp)
            up = prev.astype(np.int32).reshape(-1, bpp)
            res = np.empty_like(lv)
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(lv.shape[0]):
                if kind == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pa = np.abs(up[x] - upleft)
                    pb = np.abs(left - upleft)
                    pc = np.abs(left + up[x] - 2 * upleft)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up[x], upleft))
                left = (lv[x] + pred) & 255
                res[x] = left
                upleft = up[x]
            cur = res.reshape(-1).astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W) grey or (H, W, C) uint8/uint16 pixels of a PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (color type {color}, "
                         f"bit depth {depth}, interlace {interlace})")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pixels = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return pixels.reshape(shape)


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) of a PNG file, from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    return struct.unpack(">II", head[16:24])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) grey or (H, W, 3) RGB, uint8 or uint16, filter 0."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG file ``write_png`` writes, as bytes."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG pixels must be uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"PNG pixels must be (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    height, width = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(height, -1)
    rows = rows.view(np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


_JPEG_SUFFIXES = (".jpg", ".jpeg")


def _kind(path: str) -> str:
    suffix = os.path.splitext(os.fspath(path))[1].lower()
    if suffix == ".png":
        return "png"
    if suffix in _JPEG_SUFFIXES:
        return "jpeg"
    raise ValueError(f"{path}: not a .png, .jpg or .jpeg file")


def read_image(path: str) -> np.ndarray:
    """The pixels of a PNG (``read_png``) or a JPEG (``decode_jpeg``),
    chosen by the suffix (.png, .jpg, .jpeg, any case): (H, W) grey or
    (H, W, C), as ``np.asarray(PIL.Image.open(path))`` gives them."""
    if _kind(path) == "png":
        return read_png(os.fspath(path))
    with open(path, "rb") as f:
        return decode_jpeg(f.read())


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of a PNG or a JPEG, by the suffix, from its
    header."""
    if _kind(path) == "png":
        return png_size(os.fspath(path))
    return jpeg_size(os.fspath(path))


def load_images_nchw(paths: Sequence[str], height: int, width: int,
                     channels: int = 3,
                     scale: float = 1.0 / 255.0) -> np.ndarray:
    """(N, C, H, W) float32 batch of PNGs or JPEGs, pixel values times
    ``scale``; grey images repeat into every channel. The one batch
    loader: ``data/native.load_images_nchw`` (PNGs on the host library's
    threads, the pixels of ``read_png`` bit for bit; JPEGs through
    ``read_image``)."""
    from igs_tpu_torch.data import native

    return native.load_images_nchw(paths, height, width, channels, scale)
