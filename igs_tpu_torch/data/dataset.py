"""Camera records of the datasets (the frame-0 part of
``igs_tpu/data/dataset.py``): fov/focal conversions and the
``cameras.json`` entry → (c2w, fovx, fovy). The N3DV datasets are not
ported yet."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def focal2fov(focal, pixels):
    return 2 * np.arctan(pixels / (2 * focal))


def fov2focal(fov, pixels):
    return pixels / (2 * np.tan(fov / 2))


def camera_from_json(cam: Dict) -> Tuple[np.ndarray, float, float]:
    """One ``cameras.json`` entry (rotation, position, fx, fy, width,
    height) → (4×4 float32 c2w, fovx, fovy)."""
    c2w = np.zeros((4, 4), np.float32)
    c2w[:3, :3] = np.array(cam["rotation"])
    c2w[:3, 3] = np.array(cam["position"])
    c2w[3, 3] = 1
    fovx = focal2fov(cam["fx"], cam["width"])
    fovy = focal2fov(cam["fy"], cam["height"])
    return c2w, float(fovx), float(fovy)
