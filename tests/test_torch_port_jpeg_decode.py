"""The port's baseline JPEG decoder (``data/jpeg.decode_jpeg``) against
PIL's (libjpeg-turbo at its defaults): the pixels must be equal bit for
bit, ``np.asarray(Image.open(f))``, on PIL-written files at qualities
10–100, with 4:4:4, 4:2:2 and 4:2:0 sampling, greyscale, restart
markers, optimised Huffman tables, Adobe RGB (``keep_rgb``), odd sizes
with partial MCUs (1×1 up to 1014×1352), the port's own encoder's files
and random small images. Progressive, arithmetic-coded and CMYK files
raise by name. ``read_image``/``image_size`` choose the codec by suffix.
"""

import io
import os
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from igs_tpu_torch.data import jpeg
from igs_tpu_torch.data.images import image_size, read_image, write_png


def _pil_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _check(data):
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = jpeg.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _image(h, w, seed, grey=False):
    """A smooth gradient with noise: both flat and busy blocks."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([255 * xx / max(w, 1), 255 * yy / max(h, 1),
                     (xx + 2 * yy) % 256], -1)
    img = np.clip(base + rng.randint(-40, 41, base.shape), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if grey else img


@pytest.mark.parametrize("quality", [10, 50, 75, 95, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_quality_and_sampling_match_pil(quality, subsampling):
    img = _image(37, 53, seed=quality + subsampling)
    _check(_pil_bytes(img, quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (17, 33), (9, 7), (2, 3)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_odd_sizes_match_pil(hw, subsampling):
    img = _image(*hw, seed=hw[0] * 100 + hw[1])
    _check(_pil_bytes(img, quality=90, subsampling=subsampling))


@pytest.mark.parametrize("quality", [30, 95])
def test_greyscale_matches_pil(quality):
    img = _image(23, 41, seed=5, grey=True)
    got = _check(_pil_bytes(img, quality=quality))
    assert got.ndim == 2


@pytest.mark.parametrize("kw", [
    {"restart_marker_blocks": 1}, {"restart_marker_blocks": 3},
    {"restart_marker_rows": 1, "subsampling": 0},
    {"optimize": True}, {"keep_rgb": True}, {"keep_rgb": True,
                                             "subsampling": 0}],
    ids=["rst_1_block", "rst_3_blocks", "rst_row_444", "optimized_tables",
         "adobe_rgb", "adobe_rgb_444"])
def test_file_variants_match_pil(kw):
    img = _image(45, 70, seed=11)
    data = _pil_bytes(img, quality=85, **kw)
    if "restart_marker_blocks" in kw or "restart_marker_rows" in kw:
        assert 0xDD in jpeg.segments(data)
    _check(data)


def test_full_size_frame_matches_pil():
    """One 1014×1352 frame at quality 95 (4:2:0), as the eval images of a
    scene; the decode time is printed."""
    img = _image(1014, 1352, seed=3)
    data = _pil_bytes(img, quality=95)
    t0 = time.perf_counter()
    _check(data)
    print(f"1014x1352 q95 4:2:0 decode: "
          f"{1e3 * (time.perf_counter() - t0):.0f} ms")


@pytest.mark.parametrize("quality", [50, 92])
def test_port_encoder_round_trip_matches_pil(quality):
    img = _image(61, 90, seed=quality)
    _check(jpeg.encode_jpeg(img, quality))


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24),
       quality=st.integers(1, 100), subsampling=st.sampled_from([0, 1, 2]),
       seed=st.integers(0, 2**31 - 1))
def test_random_images_match_pil(h, w, quality, subsampling, seed):
    img = np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)
    _check(_pil_bytes(img, quality=quality, subsampling=subsampling))


def test_unsupported_kinds_raise_by_name():
    img = _image(16, 16, seed=1)
    with pytest.raises(NotImplementedError, match="progressive"):
        jpeg.decode_jpeg(_pil_bytes(img, progressive=True))
    data = bytearray(_pil_bytes(img))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = 0xC9  # the same frame, marked arithmetic-coded
    with pytest.raises(NotImplementedError, match="arithmetic"):
        jpeg.decode_jpeg(bytes(data))
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
    with pytest.raises(NotImplementedError, match="CMYK"):
        jpeg.decode_jpeg(buf.getvalue())
    with pytest.raises(ValueError, match="SOI"):
        jpeg.decode_jpeg(b"\x89PNG")


def test_read_image_by_suffix(tmp_path):
    img = _image(13, 21, seed=2)
    data = _pil_bytes(img, quality=80)
    for name in ("a.jpg", "b.JPEG", "c.Jpg"):
        path = os.path.join(tmp_path, name)
        with open(path, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(read_image(path),
                                      np.asarray(Image.open(path)))
        assert image_size(path) == jpeg.jpeg_size(path) == (21, 13)
    png = os.path.join(tmp_path, "d.PNG")
    write_png(png, img)
    np.testing.assert_array_equal(read_image(png), img)
    assert image_size(png) == (21, 13)
    other = os.path.join(tmp_path, "e.bmp")
    Image.fromarray(img).save(other)
    with pytest.raises(ValueError, match="not a .png, .jpg or .jpeg"):
        read_image(other)
    with pytest.raises(ValueError, match="not a .png, .jpg or .jpeg"):
        image_size(other)
