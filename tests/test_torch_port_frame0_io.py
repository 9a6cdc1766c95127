"""The port's frame-0 I/O against PIL and the JAX package: the numpy/zlib
PNG codec (``igs_tpu_torch/data/images.py``) both ways against PIL, image
export against ``igs_tpu/utils/saving.py``, PLY bytes against
``igs_tpu/data/ply.py``, and the camera records of
``igs_tpu/data/dataset.py``."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from igs_tpu.data import dataset as jds
from igs_tpu.data import ply as jply
from igs_tpu.data.native import load_images_nchw as jax_load_images
from igs_tpu.utils import saving as jsaving
from igs_tpu_torch.data import dataset as tds
from igs_tpu_torch.data import ply as tply
from igs_tpu_torch.data.images import load_images_nchw, read_png, write_png
from igs_tpu_torch.utils import saving as tsaving
from tests.conftest import random_gaussians
from tests.torch_port_common import to_torch_gaussians


def _pictures(rng, h=37, w=53):
    """Noise and smooth ramps: PIL's encoder picks other filters for each."""
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = np.stack([xx * 4, yy * 6, (xx + yy) * 3], -1) % 256
    noise = rng.randint(0, 256, (h, w, 3))
    return [noise.astype(np.uint8), ramp.astype(np.uint8),
            (ramp // 2 + noise // 2).astype(np.uint8)]


@pytest.mark.parametrize("kind", ["rgb8", "grey16"])
def test_png_codec_against_pil_both_ways(tmp_path, kind):
    rng = np.random.RandomState(0)
    if kind == "rgb8":
        images = _pictures(rng)
    else:
        yy, xx = np.mgrid[0:29, 0:41]
        images = [rng.randint(0, 65536, (29, 41)).astype(np.uint16),
                  (xx * 1500 + yy * 700).astype(np.uint16)]
    for i, img in enumerate(images):
        ours, theirs = tmp_path / f"ours{i}.png", tmp_path / f"pil{i}.png"
        write_png(str(ours), img)
        np.testing.assert_array_equal(np.asarray(Image.open(ours)), img)
        pil = Image.fromarray(img) if kind == "rgb8" else \
            Image.frombytes("I;16", img.shape[::-1], img.tobytes())
        pil.save(theirs)
        got = read_png(str(theirs))
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, img)


def test_png_reader_takes_grey_and_alpha(tmp_path):
    rng = np.random.RandomState(1)
    grey = _pictures(rng)[1][..., 0]
    rgba = np.concatenate([_pictures(rng)[2], grey[..., None]], -1)
    for name, img in (("grey", grey), ("rgba", rgba)):
        Image.fromarray(img).save(tmp_path / f"{name}.png")
        np.testing.assert_array_equal(read_png(str(tmp_path / f"{name}.png")),
                                      img)
    with pytest.raises(ValueError):
        read_png(__file__)


def test_image_export_and_loading_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    img = rng.uniform(-0.1, 1.1, (3, 24, 40)).astype(np.float32)
    depth = rng.uniform(0.5, 70.0, (24, 40)).astype(np.float32)
    np.testing.assert_array_equal(tsaving.to_uint8_image(img),
                                  jsaving.to_uint8_image(img))
    tsaving.save_image(str(tmp_path / "t" / "img.png"), img)
    jsaving.save_image(str(tmp_path / "j" / "img.png"), img)
    tsaving.save_depth_mm(str(tmp_path / "t" / "depth.png"), depth)
    jsaving.save_depth_mm(str(tmp_path / "j" / "depth.png"), depth)
    for name in ("img.png", "depth.png"):
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "t" / name)),
            np.asarray(Image.open(tmp_path / "j" / name)))
    paths = [str(tmp_path / d / "img.png") for d in "tj"]
    np.testing.assert_array_equal(load_images_nchw(paths, 24, 40),
                                  jax_load_images(paths, 24, 40))


def _gaussians():
    g = random_gaussians(n=40, seed=3).pad_to(48)
    return g, to_torch_gaussians(g)


@pytest.mark.parametrize("only_valid", [True, False])
def test_save_gaussian_ply_bytes_equal_jax(tmp_path, only_valid):
    jg, tg = _gaussians()
    jply.save_gaussian_ply(str(tmp_path / "j.ply"), jg, only_valid)
    tply.save_gaussian_ply(str(tmp_path / "t.ply"), tg, only_valid)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_load_gaussian_ply_reads_jax_files(tmp_path):
    jg, _ = _gaussians()
    jply.save_gaussian_ply(str(tmp_path / "j.ply"), jg)
    got = tply.load_gaussian_ply(str(tmp_path / "j.ply"))
    want = jply.load_gaussian_ply(str(tmp_path / "j.ply"))
    assert got.num_capacity == 40 and bool(got.valid.all())
    for name in ("xyz", "opacity", "rotation", "scaling", "shs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(jg, name))[:40])


def test_load_gaussian_ply_fuses_filter_3d_like_jax(tmp_path):
    """A RaDe-GS file with a ``filter_3D`` column: both packages fuse it
    into scale and opacity."""
    jg, _ = _gaussians()
    jply.save_gaussian_ply(str(tmp_path / "j.ply"), jg)
    v = jply.read_ply_vertices(str(tmp_path / "j.ply"))
    filt = np.random.RandomState(4).uniform(0.001, 0.05, len(v))
    names = list(v.dtype.names) + ["filter_3D"]
    rec = np.rec.fromarrays([v[n] for n in v.dtype.names]
                            + [filt.astype("<f4")], names=names)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(v)}\n"
              + "".join(f"property float {n}\n" for n in names)
              + "end_header\n")
    (tmp_path / "f.ply").write_bytes(header.encode() + rec.tobytes())
    got = tply.load_gaussian_ply(str(tmp_path / "f.ply"))
    want = jply.load_gaussian_ply(str(tmp_path / "f.ply"))
    for name in ("scaling", "opacity"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert not np.allclose(got.scaling.numpy(), np.asarray(jg.scaling)[:40])


def test_camera_from_json_matches_jax():
    rng = np.random.RandomState(5)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    cam = json.loads(json.dumps({
        "id": 0, "img_name": "00000", "width": 512, "height": 384,
        "position": rng.normal(size=3).tolist(), "rotation": q.tolist(),
        "fx": 600.5, "fy": 590.25}))
    got, want = tds.camera_from_json(cam), jds.camera_from_json(cam)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    for f in (300.0, 611.3):
        assert tds.focal2fov(f, 512) == jds.focal2fov(f, 512)
        assert tds.fov2focal(0.8, 512) == jds.fov2focal(0.8, 512)
    assert isinstance(torch.from_numpy(got[0]), torch.Tensor)
