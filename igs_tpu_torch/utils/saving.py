"""Image export (the image half of ``igs_tpu/utils/saving.py``), written
with the port's own PNG codec (``data/images.py``)."""

from __future__ import annotations

import os

import numpy as np

from igs_tpu_torch.data.images import write_png


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


def save_depth_mm(path: str, depth: np.ndarray) -> None:
    """16-bit grey PNG of the depth in millimetres (compress.py's
    depth_expected_mm convention)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, np.clip(np.asarray(depth) * 1000.0, 0, 65535).astype(
        np.uint16))
