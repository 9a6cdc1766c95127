"""The port's host data plane (``igs_tpu_torch/data/native.py`` over
``csrc/host/igsio.cpp``, built here with g++ at first use) against the
numpy PNG codec's samples (``data/images.read_png_samples``) and the
JAX package's ``igs_tpu/data/native.py``, whose own C++ source is built
for the comparison into a temporary directory: batch decodes bit-equal
on 8- and 16-bit grey, grey+alpha, RGB and RGBA PNGs whose rows use all
five scanline filters, a 16-bit depth at scale 1/1000, a mixed PNG and JPEG
batch; ``read_ply_fast`` equal to the JAX reader's on a Gaussian PLY the
port wrote; refused PNGs raise naming the file; two processes building
the library at once both load it."""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from igs_tpu.data import native as jnative
from igs_tpu.data.ply import read_ply_vertices as jax_read_ply_vertices
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.data import native
from igs_tpu_torch.data.images import (load_images_nchw, read_png,
                                       read_png_samples)
from igs_tpu_torch.data.ply import save_gaussian_ply
from igs_tpu_torch.ops import host_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLOR = {1: 0, 2: 4, 3: 2, 4: 6}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def png_all_filters(path, img):
    """A PNG whose row y uses filter y % 5 (None, Sub, Up, Average,
    Paeth)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    depth = 8 * img.dtype.itemsize
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = rows.view(np.uint8).reshape(h, -1).astype(np.int64)
    bpp = c * depth // 8
    raw = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        kind, line = y % 5, rows[y]
        out = []
        for x in range(len(line)):
            a = line[x - bpp] if x >= bpp else 0
            b = prev[x]
            cc = prev[x - bpp] if x >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[kind]
            out.append((line[x] - pred) & 255)
        raw.append(kind)
        raw.extend(out)
        prev = line

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                              COLOR[c], 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(bytes(raw)))
                + _chunk(b"IEND", b""))


def _chunk(k, body):
    return (struct.pack(">I", len(body)) + k + body
            + struct.pack(">I", zlib.crc32(k + body) & 0xFFFFFFFF))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's loader over its own C++ source, built here."""
    root = tmp_path_factory.mktemp("jax_native")
    os.makedirs(root / "native")
    r = subprocess.run(["g++", *host_build.CXX_FLAGS, "-o",
                        str(root / "native" / "libigsio.so"),
                        os.path.join(ROOT, "native", "igsio.cpp"),
                        *host_build.LIBS], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    saved = jnative.__file__
    jnative.__file__ = str(root / "igs_tpu" / "data" / "native.py")
    jnative._TRIED, jnative._LIB = False, None
    assert jnative.native_available()
    yield jnative
    jnative.__file__ = saved
    jnative._TRIED, jnative._LIB = False, None


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_batch_decode_bit_equal(tmp_path, jax_native, dtype, channels):
    rng = np.random.RandomState(channels)
    top = 256 if dtype == np.uint8 else 65536
    paths, want = [], []
    for i in range(3):
        img = rng.randint(0, top, (13, 17, channels)).astype(dtype)
        path = str(tmp_path / f"im{i}.png")
        png_all_filters(path, img[:, :, 0] if channels == 1 else img)
        px = read_png_samples(path).samples[..., 0 if channels == 1
                                            else slice(None)]
        np.testing.assert_array_equal(
            px, img[:, :, 0] if channels == 1 else img)
        paths.append(path)
        want.append(px if px.ndim == 3 else px[:, :, None])
    for out_c in (1, 3):
        got = load_images_nchw(paths, 13, 17, channels=out_c)
        ref = np.stack([
            np.repeat(w[:, :, :1], out_c, 2) if w.shape[2] < out_c
            else w[:, :, :out_c] for w in want]).astype(np.float32)
        ref = ref.transpose(0, 3, 1, 2) * np.float32(1 / 255)
        if channels != 2 or out_c == 1:
            # grey+alpha into three channels: both libraries give (grey,
            # alpha, alpha), checked against JAX's below
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            got, jax_native.load_images_nchw(paths, 13, 17, channels=out_c))


def test_depth_at_millimetres(tmp_path, jax_native):
    depth = np.random.RandomState(5).randint(0, 65536, (24, 31)).astype(
        np.uint16)
    path = str(tmp_path / "d.png")
    Image.fromarray(depth).save(path)
    got = load_images_nchw([path] * 2, 24, 31, channels=1, scale=1 / 1000)
    np.testing.assert_array_equal(
        got[0, 0], depth.astype(np.float32) * np.float32(1 / 1000))
    np.testing.assert_array_equal(got, jax_native.load_images_nchw(
        [path] * 2, 24, 31, channels=1, scale=1 / 1000))


def test_png_and_jpeg_batch(tmp_path, jax_native):
    rng = np.random.RandomState(6)
    paths = []
    for i, suffix in enumerate((".png", ".jpg", ".png", ".jpeg")):
        p = str(tmp_path / f"x{i}{suffix}")
        Image.fromarray(rng.randint(0, 256, (20, 28, 3)).astype(np.uint8)
                        ).save(p, **({"quality": 90} if "jp" in suffix
                                     else {}))
        paths.append(p)
    np.testing.assert_array_equal(
        load_images_nchw(paths, 20, 28),
        jax_native.load_images_nchw(paths, 20, 28))


def test_ply_fast_reader(tmp_path, jax_native):
    rng = np.random.RandomState(7)
    n = 300
    rot = rng.normal(size=(n, 4))
    g = Gaussians.create(rng.normal(size=(n, 3)), rng.normal(size=(n, 1)),
                         rot / np.linalg.norm(rot, axis=1, keepdims=True),
                         rng.normal(size=(n, 3)),
                         rng.normal(size=(n, 16, 3)), device="cpu")
    path = str(tmp_path / "g.ply")
    save_gaussian_ply(path, g)
    got = native.read_ply_fast(path)
    want = jax_native.read_ply_fast(path)
    assert got is not None and got.dtype == want.dtype and len(got) == n
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == jax_read_ply_vertices(path).tobytes()
    ascii_ply = tmp_path / "a.ply"
    ascii_ply.write_text("ply\nformat ascii 1.0\nelement vertex 1\n"
                         "property list uchar int x\nend_header\n1 0\n")
    assert native.read_ply_fast(str(ascii_ply)) is None


def test_refused_pngs_raise_by_name(tmp_path):
    rng = np.random.RandomState(8)
    good = str(tmp_path / "good.png")
    png_all_filters(good, rng.randint(0, 256, (8, 9, 3)).astype(np.uint8))
    data = open(good, "rb").read()
    cut = str(tmp_path / "cut.png")
    open(cut, "wb").write(data[:len(data) // 2])
    with pytest.raises(ValueError, match="cut.png: a chunk runs past"):
        load_images_nchw([good, cut], 8, 9)
    with pytest.raises(ValueError, match="good.png: a size other"):
        load_images_nchw([good], 9, 9)
    missing = str(tmp_path / "missing.png")
    with pytest.raises(ValueError, match="missing.png: the file cannot"):
        load_images_nchw([missing], 8, 9)
    bad = str(tmp_path / "badfilter.png")
    rows = np.zeros((8, 1 + 9 * 3), np.uint8)
    rows[3, 0] = 7  # no such filter
    with open(bad, "wb") as f:
        f.write(data[:33] + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="badfilter.png: an unknown"):
        load_images_nchw([good, bad], 8, 9)


BUILD_AND_DECODE = """
import sys
import numpy as np
from igs_tpu_torch.utils.cache import enable_persistent_cache
enable_persistent_cache(sys.argv[1])
from igs_tpu_torch.data import native
from igs_tpu_torch.data.images import read_png
out = native.load_images_nchw([sys.argv[2]], 8, 9)
assert np.array_equal(out[0], read_png(sys.argv[2]).astype(
    np.float32).transpose(2, 0, 1) * np.float32(1 / 255))
print("loaded", native.host_build.target("igsio.cpp"))
"""


def test_two_processes_build_at_once(tmp_path):
    png = str(tmp_path / "p.png")
    png_all_filters(png, np.random.RandomState(9).randint(
        0, 256, (8, 9, 3)).astype(np.uint8))
    cache = str(tmp_path / "cache")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_DECODE, cache,
                               png], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("loaded " + cache)
    libs = os.listdir(os.path.join(cache, "host"))
    assert len([f for f in libs if f.endswith(".so")]) == 1, libs
    assert not [f for f in libs if f.endswith(".tmp")], libs
