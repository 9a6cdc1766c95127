"""PIL's bilinear resize of 8-bit images, bit for bit, in numpy.

``prepare_data subsample`` (the JAX package's ``prepare_data.py:70-76``)
resizes with ``Image.resize((w, h), Image.BILINEAR)``; the card's machine
has no PIL, so the port carries the same arithmetic (Pillow's
``libImaging/Resample.c``):

* per axis, coefficients in double: ``scale = in / out``, ``support =
  max(scale, 1)``, for output ``i`` the centre ``c = (i + 0.5) * scale``,
  the window ``[int(c - support + 0.5), int(c + support + 0.5))`` clipped
  to the input, weights ``1 - |(x - c + 0.5) / support|`` (0 outside
  [-1, 1]) summed in order and normalised;
* the weights in fixed point with 22 fractional bits, ``trunc(k * 2**22 ±
  0.5)``;
* the horizontal pass first (skipped when the width is kept), then the
  vertical one, each output starting at ``1 << 21``, shifted right by 22
  and clipped to 0..255, the intermediate rows stored as uint8.

RGBA and LA images are resized premultiplied by their alpha, as PIL does
(``RGBa``/``La``), then divided back. Vectorised over output rows and
columns: the only Python loops run over the window's taps.
"""

from __future__ import annotations

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _coefficients(in_size: int, out_size: int):
    """(first input index (out,), taps (out, k) int32) of one axis; taps
    past the clipped window are 0."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    count = xmax - xmin
    ss = 1.0 / filterscale
    x = np.arange(ksize)
    arg = ((x[None, :] + xmin[:, None]).astype(np.float64)
           - center[:, None] + 0.5) * ss
    w = np.where(np.abs(arg) < 1.0, 1.0 - np.abs(arg), 0.0)
    w = np.where(x[None, :] < count[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for i in range(ksize):  # in order, as the C loop sums
        ww = ww + w[:, i]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = w * (1 << PRECISION_BITS)
    k = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int32)
    return xmin, k


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` (0 rows, 1 columns) of (H, W, C) uint8."""
    in_size = img.shape[axis]
    xmin, k = _coefficients(in_size, out_size)
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int64)
    for i in range(k.shape[1]):
        idx = np.minimum(xmin + i, in_size - 1)
        taps = np.take(img, idx, axis=axis).astype(np.int64)
        shape = [1, 1, 1]
        shape[axis] = out_size
        acc += taps * k[:, i].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tmp = a.astype(np.uint32) * b.astype(np.uint32) + 128
    return (((tmp >> 8) + tmp) >> 8).astype(np.uint8)


def _premultiply(img: np.ndarray) -> np.ndarray:
    out = img.copy()
    alpha = img[..., -1]
    for c in range(img.shape[2] - 1):
        out[..., c] = _muldiv255(img[..., c], alpha)
    return out


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    out = img.copy()
    alpha = img[..., -1].astype(np.uint32)
    keep = (alpha == 255) | (alpha == 0)
    safe = np.where(alpha == 0, 1, alpha)
    for c in range(img.shape[2] - 1):
        div = np.minimum(255 * img[..., c].astype(np.uint32) // safe, 255)
        out[..., c] = np.where(keep, img[..., c], div).astype(np.uint8)
    return out


def resize_bilinear(img_u8: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(img_u8).resize((width, height), Image.BILINEAR)``
    as an array: (H, W) grey or (H, W, C) with C in 1..4, uint8."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bilinear takes uint8 pixels, got {img.dtype}")
    grey = img.ndim == 2
    if grey:
        img = img[:, :, None]
    if img.ndim != 3 or not 1 <= img.shape[2] <= 4:
        raise ValueError(f"resize_bilinear takes (H, W) or (H, W, 1..4), got "
                         f"{img_u8.shape}")
    if width < 1 or height < 1:
        raise ValueError(f"output size {width}x{height} must be positive")
    h, w, c = img.shape
    if (w, h) == (width, height):
        out = img.copy()
    else:
        alpha = c in (2, 4)
        work = _premultiply(img) if alpha else img
        if width != w:
            work = _pass(work, width, 1)
        if height != h:
            work = _pass(work, height, 0)
        out = _unpremultiply(work) if alpha else work
    return out[:, :, 0] if grey else out
