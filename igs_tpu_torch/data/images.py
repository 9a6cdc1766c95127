"""PNG reading and writing with numpy and ``zlib``, image reading by
suffix (PNG or JPEG), and the batched image loader of the datasets
(``load_images_nchw``, which decodes PNG batches through the host
library of ``data/native.py``).

The port carries its own codecs so that it needs no PIL. ``decode_png``
reads every legal PNG: grey at 1, 2, 4, 8 and 16 bits, RGB, grey+alpha
and RGBA at 8 and 16, palette at 1, 2, 4 and 8 (``PLTE``), with or
without ``tRNS``, all five scanline filters, and Adam7 interlacing. Its
samples have three views, each the pixels of the program that the JAX
package reads such a file with:

* ``read_png``: ``np.asarray(PIL.Image.open(path))`` (PIL's modes: 1-bit
  grey as bool, 2- and 4-bit grey scaled to 8 bits, palette indices,
  16-bit colour as its high byte, 16-bit grey+alpha as RGBA, 16-bit grey
  as uint16 samples);
* ``to_rgb``/``to_rgba``: PIL's ``convert("RGB")``/``convert("RGBA")``
  of those pixels (the palette applied, ``tRNS`` as alpha, mode ``1`` as
  0/255, 16-bit grey clipped to 255);
* ``data/undistort.imread_bgr``: ``cv2.imread(path)`` of the samples.

It writes 8-bit RGB and 16-bit grey with filter 0; JPEGs decode through
``data/jpeg.decode_jpeg`` (baseline and progressive, PIL's pixels).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from igs_tpu_torch.data.jpeg import decode_jpeg, jpeg_size

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type → channels
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PngSamples(NamedTuple):
    """A PNG's samples as the file holds them: ``samples`` (H, W, C),
    uint8 up to 8 bits (a sample of 1, 2 or 4 bits in a byte of its
    own, unscaled) or uint16 at 16; ``palette`` (n, 3) uint8 for colour
    type 3; ``trns`` the ``tRNS`` chunk: (n,) uint8 palette alphas, or
    the transparent key as (1,) or (3,) uint16 samples, or None."""
    samples: np.ndarray
    depth: int
    color: int
    palette: Optional[np.ndarray]
    trns: Optional[np.ndarray]

    def palette256(self) -> np.ndarray:
        """The palette as a (256, 3) table, black past its entries."""
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(self.palette)] = self.palette[:256]
        return pal


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


def _samples(raw: np.ndarray, height: int, width: int, channels: int,
             depth: int) -> Tuple[np.ndarray, int]:
    """One (sub-)image's filtered rows from the front of ``raw`` →
    ((H, W, C) samples, bytes used)."""
    stride = -(-width * channels * depth // 8)
    used = height * (stride + 1)
    if len(raw) < used:
        raise ValueError(f"PNG: the image data holds {len(raw)} bytes, "
                         f"{used} needed")
    bpp = max(1, channels * depth // 8)
    rows = _unfilter(raw[:used].reshape(height, stride + 1), height,
                     stride, bpp)
    if depth == 16:
        px = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        px = rows
    else:
        per = 8 // depth
        shifts = (8 - depth) - depth * np.arange(per, dtype=np.uint8)
        px = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            height, -1)[:, :width * channels]
    return px.reshape(height, width, channels), used


def decode_png(data: bytes, name: str = "PNG") -> PngSamples:
    """The samples of a PNG file's bytes, every legal colour type and bit
    depth, interlaced (Adam7) or not; ``name`` labels the errors."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name} is not a PNG file")
    pos, idat, header = 8, [], None
    palette = trns = None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) < length:
            raise ValueError(f"{name}: a chunk runs past the end of the "
                             "file")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color] \
            or interlace > 1:
        raise ValueError(f"{name}: not a legal PNG (color type {color}, "
                         f"bit depth {depth}, interlace {interlace})")
    if color == 3 and palette is None:
        raise ValueError(f"{name}: a palette PNG without a PLTE chunk")
    if trns is not None:
        trns = (np.frombuffer(trns, np.uint8).copy() if color == 3
                else np.frombuffer(trns, ">u2").astype(np.uint16))
    channels = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if not interlace:
        px, _ = _samples(raw, height, width, channels, depth)
    else:
        px = np.zeros((height, width, channels),
                      np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            sub, used = _samples(raw[at:], ph, pw, channels, depth)
            px[y0::dy, x0::dx] = sub
            at += used
    return PngSamples(px, depth, color, palette, trns)


def read_png_samples(path: str) -> PngSamples:
    """``decode_png`` of a file."""
    with open(path, "rb") as f:
        return decode_png(f.read(), os.fspath(path))


def pil_pixels(s: PngSamples) -> np.ndarray:
    """``np.asarray(PIL.Image.open(f))`` of the PNG whose samples are
    ``s``: PIL's mode for the colour type and depth (1-bit grey ``1`` as
    bool, 2/4-bit grey ``L`` scaled, palette ``P`` as indices, 16-bit grey
    ``I;16``, 16-bit colour as its high byte, 16-bit grey+alpha as RGBA)."""
    px, depth, color = s.samples, s.depth, s.color
    if color == 3:
        return px[:, :, 0]
    if color == 0:
        if depth == 1:
            return px[:, :, 0].astype(bool)
        if depth in (2, 4):
            return (px[:, :, 0] * (255 // ((1 << depth) - 1))).astype(
                np.uint8)
        return px[:, :, 0]
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
        if color == 4:
            return np.concatenate([np.repeat(px[:, :, :1], 3, axis=2),
                                   px[:, :, 1:]], axis=2)
    return px


def read_png(path: str) -> np.ndarray:
    """The pixels of a PNG file as ``np.asarray(PIL.Image.open(path))``
    gives them: the same dtype, shape and values (``pil_pixels``)."""
    return pil_pixels(read_png_samples(path))


def _pil_mode(s: PngSamples) -> str:
    """PIL's mode for the file's colour type and depth."""
    if s.color == 3:
        return "P"
    if s.color == 0:
        return {1: "1", 16: "I;16"}.get(s.depth, "L")
    if s.color == 2:
        return "RGB"
    return "LA" if s.color == 4 and s.depth == 8 else "RGBA"


def _key_alpha(px8: np.ndarray, s: PngSamples, mode: str) -> np.ndarray:
    """The alpha PIL's ``convert("RGBA")`` gives a file with a ``tRNS``
    key: 0 where every channel of the 8-bit pixel equals the key, 255
    elsewhere. PIL keeps the key's samples unscaled (times 255 for mode
    ``1``) and compares their low byte."""
    if s.trns is None:
        return np.full(px8.shape[:2] + (1,), 255, np.uint8)
    key = s.trns[:px8.shape[2]].astype(np.int64) * (255 if mode == "1"
                                                     else 1)
    hit = np.all(px8 == (key & 255).astype(np.uint8), axis=2, keepdims=True)
    return np.where(hit, 0, 255).astype(np.uint8)


def _convert(s: PngSamples, alpha: bool) -> np.ndarray:
    px = pil_pixels(s)
    mode = _pil_mode(s)
    if mode == "P":
        rgb = s.palette256()[px]
        if not alpha:
            return rgb
        alphas = np.full(256, 255, np.uint8)
        if s.trns is not None:
            alphas[:len(s.trns)] = s.trns[:256]
        return np.concatenate([rgb, alphas[px][:, :, None]], axis=2)
    if mode in ("1", "L", "I;16"):
        grey = (px.astype(np.uint8) * 255 if mode == "1"
                else np.minimum(px, 255).astype(np.uint8))
        rgb = np.repeat(grey[:, :, None], 3, axis=2)
        return np.concatenate([rgb, _key_alpha(grey[:, :, None], s, mode)],
                              axis=2) if alpha else rgb
    if mode == "LA":
        rgb = np.repeat(px[:, :, :1], 3, axis=2)
        return (np.concatenate([rgb, px[:, :, 1:]], axis=2) if alpha
                else rgb)
    if mode == "RGB":
        return np.concatenate([px, _key_alpha(px, s, mode)], axis=2) \
            if alpha else px
    return px if alpha else px[:, :, :3]


def to_rgb(s: PngSamples) -> np.ndarray:
    """PIL's ``Image.open(f).convert("RGB")`` of the PNG whose samples are
    ``s``: (H, W, 3) uint8."""
    return _convert(s, alpha=False)


def to_rgba(s: PngSamples) -> np.ndarray:
    """PIL's ``Image.open(f).convert("RGBA")``: (H, W, 4) uint8, the
    palette's ``tRNS`` alphas or the transparent key as alpha 0."""
    return _convert(s, alpha=True)


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


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of a CMYK image (``Convert.c``
    ``cmyk2rgb``): each of C, M, Y scaled by 255 − K over 255 with PIL's
    rounded division, taken from 255 − K. (H, W, 4) → (H, W, 3) uint8."""
    cmy = cmyk[..., :3].astype(np.int64)
    nk = 255 - cmyk[..., 3:].astype(np.int64)
    tmp = cmy * nk + 128
    return np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255).astype(np.uint8)


def read_image_as(path: str, mode: str) -> np.ndarray:
    """PIL's ``Image.open(path).convert(mode)`` for ``mode`` "RGB" or
    "RGBA", of a PNG (``to_rgb``/``to_rgba`` of its samples) or a JPEG
    (grey repeated, CMYK through ``cmyk_to_rgb``, an opaque alpha added):
    (H, W, 3 or 4) uint8."""
    if mode not in ("RGB", "RGBA"):
        raise ValueError(f"mode must be RGB or RGBA, got {mode!r}")
    if _kind(path) == "png":
        s = read_png_samples(os.fspath(path))
        return to_rgba(s) if mode == "RGBA" else to_rgb(s)
    with open(path, "rb") as f:
        img = decode_jpeg(f.read())
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    elif img.shape[2] == 4:
        img = cmyk_to_rgb(img)
    if mode == "RGBA":
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=2)
    return img


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
    loader: ``data/native.load_images_nchw`` (an all-PNG batch on the
    host library's threads, the samples of ``read_png_samples`` bit for
    bit; a batch with a JPEG or a PNG of a kind the library refuses
    whole through ``read_image``, PIL's pixels)."""
    from igs_tpu_torch.data import native

    return native.load_images_nchw(paths, height, width, channels, scale)
