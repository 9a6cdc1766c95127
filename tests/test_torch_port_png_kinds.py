"""Every legal PNG kind through the port's numpy decoder
(``data/images.decode_png``) and its three views, against the programs
the JAX package reads PNGs with: ``read_png`` against
``np.asarray(PIL.Image.open(p))`` (dtype, shape and values),
``to_rgb``/``to_rgba`` against PIL's ``convert``, and
``data/undistort.imread_bgr`` against ``cv2.imread``. The files cover
every (colour type, bit depth) pair, with and without ``tRNS``, plain and
Adam7-interlaced; PIL writes no Adam7, so this file writes every PNG
itself (each row's filter cycles through all five). Then the port's
``data/dataset.load_image`` and ``data/native.load_images_nchw`` against
the JAX package's on 16-bit RGB, palette and 1-bit PNGs and on a batch
that mixes an 8-bit PNG with a palette PNG (JAX's whole-batch fallback
to PIL)."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from igs_tpu.data import dataset as jdataset
from igs_tpu_torch.data import dataset, native
from igs_tpu_torch.data.images import (decode_png, read_png,
                                       read_png_samples, to_rgb, to_rgba)
from igs_tpu_torch.data.undistort import imread_bgr

from test_torch_port_native import jax_native  # noqa: F401  (fixture)

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
         (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(px, depth, first_filter):
    """Rows of (h, w, c) samples packed at ``depth`` bits, each row
    filtered with the next of the five filters."""
    h, w, c = px.shape
    if depth == 16:
        rows = px.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        rows = px.astype(np.uint8).reshape(h, -1)
    else:
        per = 8 // depth
        flat = px.reshape(h, -1).astype(np.uint8)
        flat = np.concatenate(
            [flat, np.zeros((h, -flat.shape[1] % per), np.uint8)], axis=1)
        shifts = (8 - depth) - depth * np.arange(per, dtype=np.uint8)
        rows = np.bitwise_or.reduce(
            flat.reshape(h, -1, per) << shifts, axis=2).astype(np.uint8)
    rows = rows.astype(np.int64)
    bpp = max(1, c * depth // 8)
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        kind, line = (first_filter + y) % 5, rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        cc = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = (np.zeros_like(line), a, prev, (a + prev) // 2,
                _paeth(a, prev, cc))[kind]
        out.append(kind)
        out.extend(((line - pred) & 255).astype(np.uint8).tobytes())
        prev = line
    return bytes(out)


def png_bytes(px, depth, color, palette=None, trns=None, interlace=0):
    """A PNG of (h, w, c) samples at ``depth`` bits, colour type
    ``color``, plain or Adam7."""
    h, w, _ = px.shape
    if interlace:
        raw = b""
        for i, (x0, y0, dx, dy) in enumerate(ADAM7):
            sub = px[y0::dy, x0::dx]
            if sub.size:
                raw += _filtered(sub, depth, i)
    else:
        raw = _filtered(px, depth, 0)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                             interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def make_png(color, depth, trns, seed, h=13, w=19):
    """Random samples of the kind, and the file's bytes pieces: (samples,
    palette, tRNS body)."""
    rng = np.random.RandomState(seed)
    top = 1 << depth
    palette = body = None
    if color == 3:
        n = min(top, 200)
        px = rng.randint(0, n, (h, w, 1))
        palette = rng.randint(0, 256, (n, 3))
        if trns:
            body = bytes(rng.randint(0, 256, rng.randint(1, n + 1))
                         .astype(np.uint8))
    else:
        px = rng.randint(0, top, (h, w, CHANNELS[color]))
        if trns and color in (0, 2):
            # a key that some pixels hold, so the alpha has both values
            key = px[h // 2, w // 2]
            body = struct.pack(f">{len(key)}H", *key)
            if depth == 16:
                # PIL compares the key's low byte with the 8-bit pixel
                # (the high byte of RGB, the clipped grey of I;16)
                if color == 2:
                    px[0, :3] = [[257, 514, 771]] * 3
                    body = struct.pack(">3H", 1, 2, 3)
                else:
                    px[0, :3, 0] = [100, 300, 4464]
                    body = struct.pack(">H", 100)
    px = px.astype(np.uint16 if depth == 16 else np.uint8)
    return px, palette, body


def _cases():
    for color, depth in KINDS:
        for interlace in (0, 1):
            for trns in ((False, True) if color in (0, 2, 3) else (False,)):
                yield pytest.param(color, depth, interlace, trns,
                                   id=f"c{color}-d{depth}-i{interlace}"
                                      f"{'-trns' if trns else ''}")


@pytest.mark.parametrize("color,depth,interlace,trns", list(_cases()))
def test_every_kind_matches_pil_and_cv2(tmp_path, color, depth, interlace,
                                        trns):
    px, palette, body = make_png(color, depth, trns,
                                 seed=color * 100 + depth + 7 * interlace)
    path = str(tmp_path / "k.png")
    with open(path, "wb") as f:
        f.write(png_bytes(px, depth, color, palette, body, interlace))
    s = read_png_samples(path)
    assert s.depth == depth and s.color == color
    np.testing.assert_array_equal(s.samples, px)
    with Image.open(path) as im:
        want = np.asarray(im)
        want_rgb = np.asarray(im.convert("RGB"))
    with Image.open(path) as im:
        want_rgba = np.asarray(im.convert("RGBA"))
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(to_rgb(s), want_rgb)
    np.testing.assert_array_equal(to_rgba(s), want_rgba)
    np.testing.assert_array_equal(imread_bgr(path), cv2.imread(path))


@pytest.mark.parametrize("hw", [(1, 1), (1, 9), (9, 1), (3, 5), (8, 8),
                                (17, 23)])
def test_adam7_small_sizes(tmp_path, hw):
    """Images smaller than Adam7's 8×8 cell leave passes empty."""
    for color, depth in ((0, 1), (3, 4), (2, 8), (6, 16)):
        px, palette, body = make_png(color, depth, False, seed=sum(hw),
                                     h=hw[0], w=hw[1])
        path = str(tmp_path / f"a{color}_{depth}.png")
        with open(path, "wb") as f:
            f.write(png_bytes(px, depth, color, palette, body, 1))
        np.testing.assert_array_equal(read_png_samples(path).samples, px)
        with Image.open(path) as im:
            np.testing.assert_array_equal(read_png(path), np.asarray(im))
        np.testing.assert_array_equal(imread_bgr(path), cv2.imread(path))


def test_pil_written_kinds(tmp_path):
    """Files that PIL itself writes: modes 1, L, I;16, LA, RGB, RGBA and
    P at 1, 2, 4 and 8 bits."""
    rng = np.random.RandomState(3)
    arr = rng.randint(0, 256, (11, 14, 4)).astype(np.uint8)
    ims = {"1": Image.fromarray(arr[:, :, 0] > 127),
           "L": Image.fromarray(arr[:, :, 0]),
           "I16": Image.fromarray(arr[:, :, 0].astype(np.uint16) * 257),
           "LA": Image.fromarray(arr[:, :, :2], "LA"),
           "RGB": Image.fromarray(arr[:, :, :3]),
           "RGBA": Image.fromarray(arr)}
    for bits in (1, 2, 4, 8):
        p = Image.fromarray(arr[:, :, 0] & ((1 << bits) - 1), "L").convert("P")
        p.putpalette(list(rng.randint(0, 256, 3 * (1 << bits))))
        ims[f"P{bits}"] = (p, {"bits": bits})
    for name, im in ims.items():
        im, kw = im if isinstance(im, tuple) else (im, {})
        path = str(tmp_path / f"{name}.png")
        im.save(path, **kw)
        with Image.open(path) as ref:
            want = np.asarray(ref)
            rgb, rgba = (np.asarray(ref.convert(m)) for m in ("RGB", "RGBA"))
        got = read_png(path)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)
        s = read_png_samples(path)
        np.testing.assert_array_equal(to_rgb(s), rgb)
        np.testing.assert_array_equal(to_rgba(s), rgba)
        np.testing.assert_array_equal(imread_bgr(path), cv2.imread(path))


def test_malformed_pngs_raise(tmp_path):
    px, palette, _ = make_png(3, 4, False, seed=1)
    with pytest.raises(ValueError, match="PLTE"):
        decode_png(png_bytes(px, 4, 3))
    with pytest.raises(ValueError, match="not a legal PNG"):
        decode_png(png_bytes(px, 16, 3, palette))
    data = png_bytes(px, 4, 3, palette)
    with pytest.raises(ValueError, match="runs past"):
        decode_png(data[:len(data) - 20])
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")


def _write(tmp_path, name, color, depth, seed, h=12, w=15):
    px, palette, body = make_png(color, depth, False, seed, h, w)
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(png_bytes(px, depth, color, palette, body))
    return path


@pytest.mark.parametrize("color,depth", [(2, 16), (3, 8), (3, 2), (0, 1),
                                         (6, 16), (4, 16)])
def test_load_image_matches_jax(tmp_path, color, depth):
    path = _write(tmp_path, "x.png", color, depth, seed=color + depth)
    got = dataset.load_image(path)
    want = jdataset.load_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kinds", [
    [(2, 16)], [(3, 8)], [(0, 1)], [(2, 8), (3, 8)], [(2, 16), (3, 4)],
    [(2, 8), (0, 2), (2, 8)]],
    ids=["rgb16", "palette", "grey1", "rgb8+palette", "rgb16+palette",
         "rgb8+grey2"])
@pytest.mark.parametrize("channels", [1, 3])
def test_batch_loader_matches_jax(tmp_path, jax_native, kinds, channels):
    """The library reads 16-bit RGB by itself (its samples); a batch with
    a palette or low-depth file goes whole to PIL's pixels in JAX, and to
    ``read_png``'s in the port."""
    paths = [_write(tmp_path, f"b{i}.png", c, d, seed=10 * i + c + d)
             for i, (c, d) in enumerate(kinds)]
    got = native.load_images_nchw(paths, 12, 15, channels=channels)
    want = jax_native.load_images_nchw(paths, 12, 15, channels=channels)
    np.testing.assert_array_equal(got, want)


def test_batch_fallback_keeps_c39_errors(tmp_path):
    """Inside the fallback, a file of the wrong size or a cut file still
    raises naming it."""
    pal = _write(tmp_path, "pal.png", 3, 8, seed=1)
    small = _write(tmp_path, "small.png", 2, 8, seed=2, h=5, w=5)
    with pytest.raises(ValueError, match="small.png"):
        native.load_images_nchw([pal, small], 12, 15)
    good = _write(tmp_path, "good.png", 2, 8, seed=3)
    data = open(good, "rb").read()
    cut = str(tmp_path / "cut.png")
    open(cut, "wb").write(data[:len(data) // 2])
    with pytest.raises(ValueError, match="cut.png"):
        native.load_images_nchw([pal, cut], 12, 15)
