"""COLMAP sqlite database writer + manual-model text export.

Counterpart of ``igs_tpu/data/colmap_db.py``, host tooling for the
data-prep pipeline (reference:
script/pre_colmap.py — itself COLMAP's public database schema — and
script/process_panoptic.py:117-172): seed a ``database.db`` with known
cameras/poses so ``colmap point_triangulator`` can triangulate with fixed
extrinsics, plus the images.txt/cameras.txt/points3D.txt "manual model"
it reads the poses from.

The table definitions are the public COLMAP database file format
(github.com/colmap/colmap scripts/python/database.py); only the minimal
writer surface the prep pipeline needs is implemented.
"""

from __future__ import annotations

import os
import sqlite3
from typing import Sequence

import numpy as np

MAX_IMAGE_ID = 2**31 - 1

# COLMAP camera model ids (public format)
CAMERA_MODELS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2,
                 "RADIAL": 3, "OPENCV": 4}

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < {maxid}),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
""".format(maxid=MAX_IMAGE_ID)


def rotmat2qvec(r: np.ndarray) -> np.ndarray:
    """Rotation matrix → COLMAP (w, x, y, z) quaternion (sign w ≥ 0)."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = np.asarray(r).flat
    k = np.array([
        [rxx - ryy - rzz, 0, 0, 0],
        [ryx + rxy, ryy - rxx - rzz, 0, 0],
        [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
        [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q if q[0] >= 0 else -q


class ColmapDB:
    """Minimal writer for COLMAP's sqlite database."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)

    def add_camera(self, model: str, width: int, height: int,
                   params: Sequence[float], camera_id: int | None = None,
                   prior_focal_length: bool = True) -> int:
        blob = np.asarray(params, np.float64).tobytes()
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, CAMERA_MODELS[model], width, height, blob,
             int(prior_focal_length)))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int,
                  qvec=None, tvec=None, image_id: int | None = None) -> int:
        q = np.full(4, np.nan) if qvec is None else np.asarray(qvec, float)
        t = np.full(3, np.nan) if tvec is None else np.asarray(tvec, float)
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, q[0], q[1], q[2], q[3],
             t[0], t[1], t[2]))
        return cur.lastrowid

    def commit(self):
        self.conn.commit()

    def close(self):
        self.conn.close()


def write_manual_model(out_dir: str, cameras, images):
    """Write the images.txt/cameras.txt/points3D.txt text model.

    ``cameras``: list of dicts {camera_id, model, width, height, params};
    ``images``: list of dicts {image_id, qvec, tvec, camera_id, name}.
    Empty points3D.txt — point_triangulator fills the points
    (process_panoptic.py:119-172).
    """
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        for c in cameras:
            params = " ".join(str(p) for p in c["params"])
            f.write(f"{c['camera_id']} {c['model']} {c['width']} "
                    f"{c['height']} {params}\n")
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        for im in images:
            q = im["qvec"]
            t = im["tvec"]
            f.write(f"{im['image_id']} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} {im['camera_id']} "
                    f"{im['name']}\n\n")
    open(os.path.join(out_dir, "points3D.txt"), "w").close()


def seed_known_poses_db(db_path: str, cameras, images):
    """Create a database pre-filled with known cameras + posed images so
    feature_extractor/matcher + point_triangulator run with fixed poses."""
    if os.path.exists(db_path):
        os.remove(db_path)
    db = ColmapDB(db_path)
    for c in cameras:
        db.add_camera(c["model"], c["width"], c["height"], c["params"],
                      camera_id=c["camera_id"])
    for im in images:
        db.add_image(im["name"], im["camera_id"], qvec=im["qvec"],
                     tvec=im["tvec"], image_id=im["image_id"])
    db.commit()
    db.close()
