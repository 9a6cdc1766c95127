"""The port's COLMAP readers and writers (``igs_tpu_torch/data/colmap.py``,
``colmap_db.py``) against the JAX package's on the same synthetic sparse
models, seeded with numpy: every reader's output equal, ``cameras.json``
at downscale 1 and 2 for SIMPLE_PINHOLE and PINHOLE cameras equal,
``compute_aabb`` equal, the transforms reader equal (its image read
through the port's PNG codec, the JAX one's through PIL), and the sqlite
rows and blobs of ``seed_known_poses_db`` and the manual model's text
byte-equal."""

import json
import os
import sqlite3
import struct

import numpy as np
import pytest
from PIL import Image

from igs_tpu.data import colmap as jcolmap
from igs_tpu.data import colmap_db as jdb
from igs_tpu_torch.data import colmap as tcolmap
from igs_tpu_torch.data import colmap_db as tdb


def _rotation(rng):
    u, _, vt = np.linalg.svd(rng.normal(size=(3, 3)))
    r = u @ vt
    if np.linalg.det(r) < 0:
        r[:, 0] *= -1
    return r


def write_sparse(sparse, rng, model="PINHOLE", n_images=5, n_points=200,
                 size=(2704, 2028)):
    """cameras.bin (one camera), images.bin and points3D.bin of a seeded
    rig; returns the images' (qvec, tvec)."""
    os.makedirs(sparse, exist_ok=True)
    model_id, params = {"SIMPLE_PINHOLE": (0, [1500.5, 1352.0, 1014.0]),
                        "PINHOLE": (1, [1500.5, 1498.25, 1352.0, 1014.0])}[
        model]
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, model_id, *size))
        f.write(struct.pack(f"<{len(params)}d", *params))
    poses = []
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i in rng.permutation(n_images):  # ids out of order on disk
            q = tdb.rotmat2qvec(_rotation(rng))
            t = rng.normal(size=3)
            poses.append((q, t))
            f.write(struct.pack("<i", int(i) + 1))
            f.write(struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *t))
            f.write(struct.pack("<i", 1))
            f.write(f"cam{i:02d}.png".encode() + b"\x00")
            n2d = int(rng.randint(0, 4))
            f.write(struct.pack("<Q", n2d))
            f.write(rng.bytes(24 * n2d))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_points))
        for i in range(n_points):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<3d", *rng.normal(0, 2, 3)))
            f.write(struct.pack("<3B", *rng.randint(0, 256, 3)))
            f.write(struct.pack("<d", rng.uniform()))
            track = int(rng.randint(1, 5))
            f.write(struct.pack("<Q", track))
            f.write(rng.bytes(8 * track))
    return poses


@pytest.mark.parametrize("model", ["SIMPLE_PINHOLE", "PINHOLE"])
def test_readers_and_cameras_json_match_jax(tmp_path, model):
    sparse = str(tmp_path / "sparse")
    write_sparse(sparse, np.random.RandomState(0), model=model)
    jc = jcolmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    tc = tcolmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    assert list(jc) == list(tc)
    for k in jc:
        assert jc[k].model == tc[k].model == model
        assert (jc[k].width, jc[k].height) == (tc[k].width, tc[k].height)
        np.testing.assert_array_equal(jc[k].params, tc[k].params)
    ji = jcolmap.read_images_bin(os.path.join(sparse, "images.bin"))
    ti = tcolmap.read_images_bin(os.path.join(sparse, "images.bin"))
    assert list(ji) == list(ti)
    for k in ji:
        np.testing.assert_array_equal(ji[k].qvec, ti[k].qvec)
        np.testing.assert_array_equal(ji[k].tvec, ti[k].tvec)
        assert (ji[k].camera_id, ji[k].name) == (ti[k].camera_id, ti[k].name)
    jx, jr = jcolmap.read_points3d_bin(os.path.join(sparse, "points3D.bin"))
    tx, tr = tcolmap.read_points3d_bin(os.path.join(sparse, "points3D.bin"))
    np.testing.assert_array_equal(jx, tx)
    np.testing.assert_array_equal(jr, tr)
    assert tr.dtype == np.uint8
    for downscale in (1, 2):
        want = jcolmap.colmap_to_cameras_json(sparse, downscale=downscale)
        got = tcolmap.colmap_to_cameras_json(sparse, downscale=downscale)
        assert json.dumps(got) == json.dumps(want)
    for kw in ({}, {"padding": 0.25}, {"low_pct": 5.0, "high_pct": 90.0}):
        assert tcolmap.compute_aabb(tx, **kw) == jcolmap.compute_aabb(jx, **kw)
    m = np.random.RandomState(1).normal(size=4)
    np.testing.assert_array_equal(tcolmap.qvec2rotmat(m),
                                  jcolmap.qvec2rotmat(m))


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L"])
@pytest.mark.parametrize("white", [True, False])
def test_transforms_reader_matches_jax(tmp_path, mode, white):
    rng = np.random.RandomState(2)
    frames = []
    for i in range(3):
        shape = (12, 17) + ({"RGBA": (4,), "RGB": (3,), "L": ()}[mode])
        Image.fromarray(rng.randint(0, 256, shape).astype(np.uint8),
                        mode).save(tmp_path / f"r_{i}.png")
        c2w = np.eye(4)
        c2w[:3, :3] = _rotation(rng)
        c2w[:3, 3] = rng.normal(size=3)
        frames.append({"file_path": f"r_{i}",
                       "transform_matrix": c2w.tolist()})
    with open(tmp_path / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    want = jcolmap.read_transforms_cameras(str(tmp_path),
                                           "transforms_train.json")
    got = tcolmap.read_transforms_cameras(str(tmp_path),
                                          "transforms_train.json")
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        for field in w._fields:
            a, b = getattr(w, field), getattr(g, field)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, field
        np.testing.assert_array_equal(
            tcolmap.load_transforms_image(g, white),
            jcolmap.load_transforms_image(w, white))


def _db_rows(path):
    conn = sqlite3.connect(path)
    try:
        return {t: conn.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in ("cameras", "images", "keypoints", "descriptors",
                          "matches", "two_view_geometries")} | {
            "schema": conn.execute(
                "SELECT type, name, sql FROM sqlite_master ORDER BY name"
            ).fetchall()}
    finally:
        conn.close()


def test_seeded_database_and_manual_model_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    cams, imgs = [], []
    for i in range(4):
        cams.append({"camera_id": i + 1, "model": "PINHOLE", "width": 1920,
                     "height": 1080,
                     "params": list(rng.uniform(900, 1500, 2))
                     + [960.0, 540.0]})
        r = _rotation(rng)
        assert np.array_equal(tdb.rotmat2qvec(r), jdb.rotmat2qvec(r))
        imgs.append({"image_id": i + 1, "camera_id": i + 1,
                     "name": f"hd_00_{i:02d}.png", "qvec": tdb.rotmat2qvec(r),
                     "tvec": rng.normal(size=3)})
    for mod, name in ((jdb, "jax"), (tdb, "port")):
        mod.seed_known_poses_db(str(tmp_path / f"{name}.db"), cams, imgs)
        mod.write_manual_model(str(tmp_path / name), cams, imgs)
    assert _db_rows(str(tmp_path / "port.db")) == _db_rows(
        str(tmp_path / "jax.db"))
    assert len(_db_rows(str(tmp_path / "port.db"))["images"]) == 4
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "port" / f).read_bytes() == (
            tmp_path / "jax" / f).read_bytes(), f
    # the writer object, one row at a time, with and without priors
    for mod, name in ((jdb, "jax1"), (tdb, "port1")):
        db = mod.ColmapDB(str(tmp_path / f"{name}.db"))
        cid = db.add_camera("OPENCV", 64, 48, [50.0, 51.0, 32.0, 24.0,
                                               0.1, -0.01, 0.0, 0.0],
                            prior_focal_length=False)
        db.add_image("a.png", cid)
        db.add_image("b.png", cid, qvec=[1.0, 0, 0, 0], tvec=[1.0, 2, 3],
                     image_id=7)
        db.commit()
        db.close()
    assert _db_rows(str(tmp_path / "port1.db")) == _db_rows(
        str(tmp_path / "jax1.db"))
