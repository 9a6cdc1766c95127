"""Image, grid, video, JSON and source-snapshot export
(``igs_tpu/utils/saving.py``), written with the port's own codecs: PNG
(``data/images.py``) and baseline JPEG (``data/jpeg.py``) for the
MJPEG-in-AVI video. Neither PIL nor imageio is needed."""

from __future__ import annotations

import json
import os
import shutil
import struct
import time
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np

from igs_tpu_torch.data.images import write_png
from igs_tpu_torch.data.jpeg import encode_jpeg


def to_uint8_image(img: np.ndarray) -> np.ndarray:
    """(3,H,W)/(H,W,3)/(H,W) float [0,1] — or uint8 passthrough — →
    (H,W,3) uint8."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = img.transpose(1, 2, 0)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def save_image(path: str, img: np.ndarray) -> None:
    """8-bit RGB PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, to_uint8_image(img))


def save_image_grid(path: str, images: Iterable[np.ndarray],
                    cols: int = 4) -> None:
    """Tile images into a grid, row by row, ``cols`` a row (the JAX
    package's ``save_image_grid``: the same pixels)."""
    imgs = [to_uint8_image(i) for i in images]
    h, w = imgs[0].shape[:2]
    cols = min(cols, len(imgs))
    rows = (len(imgs) + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    # the JAX helper saves grid / 255.0, which to_uint8_image turns back
    # into the same value for every uint8
    save_image(path, grid)


def dump_json(path: str, obj) -> None:
    """``obj`` as indented JSON (the JAX package's bytes)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def save_runtime_code(workspace: str, src_root: Optional[str] = None) -> str:
    """Snapshot the port's source into ``<workspace>/code_snapshot/``
    (the reference's saveRuntimeCode, main.py:36-59) and return that
    directory. The JAX package copies ``igs_tpu`` and its three repo-root
    scripts; the port's CLIs are modules of ``igs_tpu_torch``, so the
    package alone is copied (``__pycache__`` skipped). ``src_root`` is the
    directory holding ``igs_tpu_torch`` (default: this checkout)."""
    root = Path(src_root) if src_root else Path(__file__).resolve().parents[2]
    dst = os.path.join(workspace, "code_snapshot")
    os.makedirs(dst, exist_ok=True)
    shutil.copytree(root / "igs_tpu_torch", os.path.join(dst, "igs_tpu_torch"),
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def save_depth_mm(path: str, depth: np.ndarray) -> None:
    """16-bit grey PNG of the depth in millimetres (compress.py's
    depth_expected_mm convention)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, np.clip(np.asarray(depth) * 1000.0, 0, 65535).astype(
        np.uint16))


def save_video(path: str, frames: List[np.ndarray], fps: int = 30,
               timings: Optional[List[float]] = None) -> str:
    """Video export; returns the path written.

    The JAX package writes ``.mp4`` through imageio's ffmpeg backend and,
    without one, falls back to MJPEG in AVI beside the requested path. The
    port has no ffmpeg writer, so it always takes that fallback: a
    ``.mp4`` (or any other) request writes ``<stem>.avi``
    (``save_video_avi``) and returns that path; ``.gif`` is not
    supported. ``timings`` as in ``save_video_avi``."""
    if path.endswith(".gif"):
        raise NotImplementedError("gif export needs imageio; write .avi")
    if not path.endswith(".avi"):
        path = os.path.splitext(path)[0] + ".avi"
    return save_video_avi(path, frames, fps=fps, timings=timings)


def save_video_avi(path: str, frames: List[np.ndarray], fps: int = 30,
                   quality: int = 92,
                   timings: Optional[List[float]] = None) -> str:
    """MJPEG-in-AVI writer: the JAX package's ``save_video_avi`` byte for
    byte outside the JPEG payloads (RIFF ``AVI `` with hdrl/avih,
    strl/strh/strf, movi of ``00dc`` chunks, idx1 with offsets from
    ``movi``; each chunk's word-align pad outside its size), one 'vids'
    stream, fourcc 'MJPG', frames through ``data/jpeg.encode_jpeg``.
    ``timings``, when given, receives each frame's encode seconds."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames8 = [to_uint8_image(f) for f in frames]
    h, w = frames8[0].shape[:2]
    jpegs = []
    for f in frames8:
        t0 = time.perf_counter()
        jpegs.append(encode_jpeg(np.ascontiguousarray(f), quality))
        if timings is not None:
            timings.append(time.perf_counter() - t0)
    max_size = max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(kind: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", kind + payload)

    avih = struct.pack(
        "<14I",
        1_000_000 // fps,  # microseconds per frame
        max_size * fps,    # max bytes/sec
        0,                 # padding granularity
        0x10,              # AVIF_HASINDEX
        len(jpegs), 0, 1, max_size, w, h, 0, 0, 0, 0)
    strh = (b"vids" + b"MJPG"
            + struct.pack("<10I4h", 0, 0, 0, 1, fps, 0, len(jpegs),
                          max_size, 0xFFFFFFFF, 0, 0, 0, w, h))
    strf = struct.pack("<I2i2H4s5I", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi, index = [], []
    offset = 4  # idx1 offsets count from the 'movi' fourcc
    for j in jpegs:
        index.append(b"00dc" + struct.pack("<3I", 0x10, offset, len(j)))
        movi.append(chunk(b"00dc", j))
        offset += len(movi[-1])
    riff = (b"AVI " + hdrl + lst(b"movi", b"".join(movi))
            + chunk(b"idx1", b"".join(index)))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)
    return path


def avi_chunks(data: bytes) -> List[tuple]:
    """(fourcc, payload) of every chunk of a RIFF file, depth first, LIST
    and RIFF payloads entered (their kind fourcc listed as a chunk of its
    own with an empty payload): a layout walk for checks."""
    out = []

    def walk(pos: int, end: int) -> None:
        while pos + 8 <= end:
            fourcc = data[pos:pos + 4]
            n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            body = pos + 8
            if fourcc in (b"RIFF", b"LIST"):
                out.append((fourcc + data[body:body + 4], b""))
                walk(body + 4, body + n)
            else:
                out.append((fourcc, data[body:body + n]))
            pos = body + n + (n & 1)

    walk(0, len(data))
    return out
