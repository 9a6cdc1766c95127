"""COLMAP binary model parsing (cameras.bin / images.bin / points3D.bin)
and the NeRF-synthetic transforms reader.

Counterpart of ``igs_tpu/data/colmap.py`` (the reference's
submodules/RaDe-GS/scene/colmap_loader.py): the sparse reconstruction
reader feeding the frame-0 trainer and the bbox tool
(script/compute_aabb.py). Pure numpy/struct, read-only; images are read
through the port's codecs (``data/images.py``), not PIL.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np

from igs_tpu_torch.data.images import image_size, read_image_as

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
}


class ColmapCamera(NamedTuple):
    model: str
    width: int
    height: int
    params: np.ndarray  # fx [fy] cx cy [distortion...]


class ColmapImage(NamedTuple):
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, nparams = CAMERA_MODELS[model_id]
            params = np.array(struct.unpack(f"<{nparams}d", f.read(8 * nparams)))
            out[cam_id] = ColmapCamera(name, int(w), int(h), params)
    return out


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            img_id = struct.unpack("<i", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n2d = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n2d)  # skip 2D points
            out[img_id] = ColmapImage(qvec, tvec, cam_id, name.decode())
    return out


def read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (xyz (N,3) f64, rgb (N,3) u8)."""
    xyzs, rgbs = [], []
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            f.read(8)  # point id
            xyz = struct.unpack("<3d", f.read(24))
            rgb = struct.unpack("<3B", f.read(3))
            f.read(8)  # error
            track_len = struct.unpack("<Q", f.read(8))[0]
            f.read(8 * track_len)
            xyzs.append(xyz)
            rgbs.append(rgb)
    return np.asarray(xyzs), np.asarray(rgbs, np.uint8)


def colmap_to_cameras_json(sparse_dir: str, downscale: int = 1):
    """cameras.bin+images.bin → the 3DGS cameras.json schema
    (RaDe-GS scene/ output consumed by igs data loaders)."""
    cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    images = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    out = []
    for i, (img_id, im) in enumerate(sorted(images.items())):
        cam = cams[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        else:
            fx, fy = cam.params[0], cam.params[1]
        r = qvec2rotmat(im.qvec)  # w2c rotation
        t = np.asarray(im.tvec)
        c2w_rot = r.T
        c2w_pos = -r.T @ t
        out.append({
            "id": i,
            "img_name": os.path.splitext(im.name)[0],
            "width": cam.width // downscale,
            "height": cam.height // downscale,
            "position": c2w_pos.tolist(),
            "rotation": c2w_rot.tolist(),
            "fx": float(fx) / downscale,
            "fy": float(fy) / downscale,
        })
    return out


def compute_aabb(
    points: np.ndarray, low_pct: float = 2.0, high_pct: float = 98.0,
    padding: float = 0.1,
):
    """Percentile bbox + padding (script/compute_aabb.py:33-60 behavior)."""
    lo = np.percentile(points, low_pct, axis=0)
    hi = np.percentile(points, high_pct, axis=0)
    pad = (hi - lo) * padding
    return np.stack([lo - pad, hi + pad]).tolist()


class TransformsCamera(NamedTuple):
    """One camera from a NeRF-synthetic transforms_*.json."""

    r: np.ndarray  # (3,3) c2w rotation, stored transposed like colmap R
    t: np.ndarray  # (3,) w2c translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int


def read_transforms_cameras(
    path: str, transforms_file: str, extension: str = ".png"
):
    """Blender/NeRF-synthetic scene reader (metadata only).

    Parity: readCamerasFromTransforms
    (submodules/RaDe-GS/scene/dataset_readers.py:249-289): OpenGL camera
    axes (Y up, Z back) flipped to COLMAP (Y down, Z forward), R stored
    transposed, fovy derived from fovx via the image aspect.
    """
    import json

    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    fovx = float(contents["camera_angle_x"])
    cams = []
    for idx, frame in enumerate(contents["frames"]):
        name = frame["file_path"] + extension
        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL → COLMAP axes
        w2c = np.linalg.inv(c2w)
        r = np.transpose(w2c[:3, :3])
        t = w2c[:3, 3]
        image_path = os.path.join(path, name)
        w, h = image_size(image_path)
        focal = w / (2.0 * np.tan(fovx / 2.0))
        fovy = 2.0 * np.arctan(h / (2.0 * focal))
        cams.append(TransformsCamera(
            r=r.astype(np.float32), t=t.astype(np.float32),
            fovx=fovx, fovy=float(fovy), image_path=image_path,
            image_name=os.path.splitext(os.path.basename(name))[0],
            width=w, height=h))
    return cams


def load_transforms_image(cam: TransformsCamera, white_background: bool):
    """RGBA → RGB composite over the scene background
    (dataset_readers.py:276-280). Returns float32 (H, W, 3) in [0, 1]."""
    im = read_image_as(cam.image_path, "RGBA").astype(np.float32) / 255.0
    bg = np.ones(3, np.float32) if white_background else np.zeros(3, np.float32)
    return im[..., :3] * im[..., 3:4] + bg * (1.0 - im[..., 3:4])
