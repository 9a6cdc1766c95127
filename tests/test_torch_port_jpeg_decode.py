"""The port's baseline JPEG decoder (``data/jpeg.decode_jpeg``) against
PIL's (libjpeg-turbo at its defaults): the pixels must be equal bit for
bit, ``np.asarray(Image.open(f))``, on PIL-written files at qualities
10–100, with 4:4:4, 4:2:2 and 4:2:0 sampling, greyscale, restart
markers, optimised Huffman tables, Adobe RGB (``keep_rgb``), odd sizes
with partial MCUs (1×1 up to 1014×1352), the port's own encoder's files
and random small images; the same for progressive files (PIL's
``progressive=True``: ten scans with optimised tables), and for those
files cut after each of their scans (EOI appended), which libjpeg
block-smooths (4:2:0, 4:4:4, 4:2:2 and greyscale). PIL's CMYK files
(Adobe, transform 0; every sampling PIL writes, baseline and
progressive) and YCCK files (the same files with the Adobe transform set
to 2, or 1, which libjpeg also takes as YCCK) decode to PIL's inverted
"CMYK;I" values; the readers do with the four channels what the JAX
readers do. 4:1:1 and 4:4:0 files (PIL's 4:2:0 and 4:2:2 files with the
luma's sampling relabelled) decode to PIL's pixels too, and so do the
other integral sampling ratios. Lossless, hierarchical and
arithmetic-coded files, 12-bit samples and fractional sampling raise by
name.
``read_image``/``image_size`` choose the codec by suffix.
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
    _check(_pil_bytes(img, progressive=True))
    data = bytearray(_pil_bytes(img))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = 0xC9  # the same frame, marked arithmetic-coded
    with pytest.raises(NotImplementedError, match="arithmetic"):
        jpeg.decode_jpeg(bytes(data))
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
    assert _check(buf.getvalue()).shape == (16, 16, 4)  # CMYK decodes
    with pytest.raises(ValueError, match="SOI"):
        jpeg.decode_jpeg(b"\x89PNG")


def test_refused_kinds_raise_by_name():
    img = _image(16, 16, seed=1)
    data = bytearray(_pil_bytes(img))
    sof = data.index(b"\xff\xc0")
    for marker, name in ((0xC3, "lossless"), (0xC5, "hierarchical"),
                         (0xCA, "arithmetic")):
        data[sof + 1] = marker
        with pytest.raises(NotImplementedError, match=name):
            jpeg.decode_jpeg(bytes(data))
    data[sof + 1] = 0xC1
    data[sof + 4] = 12  # the precision byte
    with pytest.raises(NotImplementedError, match="12-bit"):
        jpeg.decode_jpeg(bytes(data))
    # luma sampled 4x1 (4:1:1) or 1x2 (4:4:0) against 1x1 chroma decode
    # as PIL does: replication across, libjpeg-turbo's h1v2 triangle down.
    # (4:4:0 relabels a 4:2:2 file: a 4:4:4 file's chroma-coded blocks read
    # through the luma tables give coefficients far out of range, where
    # PIL's SIMD inverse DCT and libjpeg's C one part ways.)
    for hv, sub in ((0x41, 0), (0x12, 1)):
        data = bytearray(_pil_bytes(img, subsampling=sub))
        data[data.index(b"\xff\xc0") + 11] = hv
        _check(bytes(data))
    # other integral ratios (luma 3x1, 1x3, 1x4 against 1x1 chroma) go
    # through libjpeg's int_upsample, plain replication
    for hv, sub in ((0x31, 0), (0x13, 0), (0x14, 0)):
        data = bytearray(_pil_bytes(img, subsampling=sub))
        data[data.index(b"\xff\xc0") + 11] = hv
        _check(bytes(data))
    # chroma 2x1 against luma 3x1: a fractional ratio, which libjpeg
    # refuses too
    data = bytearray(_pil_bytes(img, subsampling=0))
    sof = data.index(b"\xff\xc0")
    data[sof + 11], data[sof + 14] = 0x31, 0x21
    with pytest.raises(NotImplementedError, match="sampling factors"):
        jpeg.decode_jpeg(bytes(data))


@pytest.mark.parametrize("hw", [(1, 1), (9, 63), (31, 63), (32, 64),
                                (26, 122)])
@pytest.mark.parametrize("kind", ["411", "440"])
@pytest.mark.parametrize("progressive", [False, True])
def test_411_and_440_sampling_match_pil(kind, hw, progressive):
    """4:1:1 (luma 4x1) from a 4:2:0 file and 4:4:0 (luma 1x2) from a
    4:2:2 file, the luma's sampling byte relabelled, decoded as PIL
    decodes them. At these sizes every scan of the relabelled frame holds
    as many blocks as the file codes (MCUs of the interleaved scans,
    blocks of a component's own scans)."""
    sub, hv = {"411": (2, 0x41), "440": (1, 0x12)}[kind]
    data = bytearray(_pil_bytes(_image(*hw, seed=hw[0] + hw[1]), quality=90,
                                subsampling=sub, progressive=progressive))
    sof = data.index(b"\xff\xc2" if progressive else b"\xff\xc0")
    data[sof + 11] = hv
    _check(bytes(data))


@pytest.mark.parametrize("quality", [10, 50, 75, 95, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_progressive_quality_and_sampling_match_pil(quality, subsampling):
    img = _image(37, 53, seed=quality + subsampling)
    data = _pil_bytes(img, quality=quality, subsampling=subsampling,
                      progressive=True)
    assert 0xC2 in jpeg.segments(data)
    _check(data)


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (17, 33), (9, 7), (2, 3)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_progressive_odd_sizes_match_pil(hw, subsampling):
    img = _image(*hw, seed=hw[0] * 100 + hw[1])
    _check(_pil_bytes(img, quality=90, subsampling=subsampling,
                      progressive=True))


@pytest.mark.parametrize("quality", [30, 95])
def test_progressive_greyscale_matches_pil(quality):
    img = _image(23, 41, seed=5, grey=True)
    got = _check(_pil_bytes(img, quality=quality, progressive=True))
    assert got.ndim == 2


@pytest.mark.parametrize("kw", [
    {"restart_marker_blocks": 1}, {"restart_marker_blocks": 3},
    {"restart_marker_rows": 1, "subsampling": 0}, {"keep_rgb": True}],
    ids=["rst_1_block", "rst_3_blocks", "rst_row_444", "adobe_rgb"])
def test_progressive_file_variants_match_pil(kw):
    img = _image(45, 70, seed=11)
    data = _pil_bytes(img, quality=85, progressive=True, **kw)
    if "keep_rgb" not in kw:
        assert 0xDD in jpeg.segments(data)
    _check(data)


def test_progressive_full_size_frame_matches_pil():
    """One 1014×1352 progressive frame at quality 95 (4:2:0); the decode
    time is printed beside the baseline file's."""
    img = _image(1014, 1352, seed=3)
    times = {}
    for progressive in (False, True):
        data = _pil_bytes(img, quality=95, progressive=progressive)
        t0 = time.perf_counter()
        _check(data)
        times[progressive] = 1e3 * (time.perf_counter() - t0)
    print(f"1014x1352 q95 4:2:0 decode: baseline {times[False]:.0f} ms, "
          f"progressive {times[True]:.0f} ms")


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24),
       quality=st.integers(1, 100), subsampling=st.sampled_from([0, 1, 2]),
       seed=st.integers(0, 2**31 - 1))
def test_random_progressive_images_match_pil(h, w, quality, subsampling,
                                             seed):
    img = np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)
    _check(_pil_bytes(img, quality=quality, subsampling=subsampling,
                      progressive=True))


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


# -- C40: CMYK and YCCK, and the progressive files libjpeg smooths -------

def _cmyk_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", [None, 0, 1, 2])
def test_cmyk_matches_pil(subsampling, progressive):
    """PIL writes CMYK with an Adobe marker (transform 0), every component
    1x1 by default; a subsampling samples C at 2x1 or 2x2."""
    kw = {} if subsampling is None else {"subsampling": subsampling}
    data = _cmyk_bytes(_image(37, 53, seed=21), quality=85,
                       progressive=progressive, **kw)
    got = _check(data)
    assert got.shape == (37, 53, 4)
    assert Image.open(io.BytesIO(data)).mode == "CMYK"


@pytest.mark.parametrize("transform", [2, 1])
def test_ycck_matches_pil(transform):
    """A CMYK file with its Adobe transform set to 2 (or 1, which libjpeg
    also reads as YCCK) is a YCCK file: libjpeg converts its first three
    components as YCbCr and inverts them, and PIL inverts all four."""
    for progressive in (False, True):
        data = bytearray(_cmyk_bytes(_image(29, 41, seed=22),
                                     progressive=progressive))
        adobe = data.index(b"\xff\xee")  # the APP14 marker
        assert data[adobe + 4:adobe + 9] == b"Adobe"
        data[adobe + 4 + 11] = transform
        _check(bytes(data))


def _cut_after_each_scan(data):
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return [data[:s] + b"\xff\xd9" for s in sos[1:]]


@pytest.mark.parametrize("kind,k", [("4:2:0", k) for k in range(1, 10)]
                         + [("4:4:4", k) for k in range(1, 10)]
                         + [("4:2:2", k) for k in (1, 4, 7)]
                         + [("grey", k) for k in range(1, 6)]
                         + [("cmyk", k) for k in (1, 2, 5)])
def test_cut_progressive_matches_pil(kind, k):
    """PIL's progressive file cut after scan k, EOI appended: its scans
    leave coefficients 1..9 short of their last bit (or unscanned), and
    libjpeg-turbo's block smoothing estimates them from the DC values
    around each block; k = 1 leaves the DC alone (DC interpolation)."""
    grey = kind == "grey"
    img = _image(45, 70, seed=30 + k, grey=grey)
    if kind == "cmyk":
        data = _cmyk_bytes(img, quality=85, progressive=True)
    else:
        kw = {} if grey else {"subsampling": {"4:2:0": 2, "4:4:4": 0,
                                              "4:2:2": 1}[kind]}
        data = _pil_bytes(img, quality=85, progressive=True, **kw)
    cut = _cut_after_each_scan(data)[k - 1]
    got = _check(cut)
    # the smoothing changes the pixels: the same file unsmoothed differs
    assert (got != _check(data)).any()


def test_smoothing_ok_follows_the_scans():
    """No smoothing for a complete progressive file, nor for a baseline
    one; smoothing once any of coefficients 1..9 is short of its last
    bit."""
    frame = {"progressive": True, "bits": [[0] * 64]}
    qt = {0: np.ones(64, np.int64)}
    assert not jpeg._smoothing_ok(frame, qt)
    frame["bits"][0][5] = 1
    assert jpeg._smoothing_ok(frame, qt)
    assert not jpeg._smoothing_ok(dict(frame, progressive=False), qt)
    assert not jpeg._smoothing_ok(frame, {})  # no table latched
    frame["bits"][0][0] = -1  # DC never scanned
    assert not jpeg._smoothing_ok(frame, qt)


def test_readers_take_cmyk_as_the_jax_readers_do(tmp_path):
    """What each reader does with a CMYK JPEG's four channels, against
    the JAX package's reader (through PIL) on the same file: the dataset
    loader and the batch loader's fallback keep the first three
    (``igs_tpu/data/dataset.py:48``, ``native.py:80-88``, and the infer
    loader through it), ``read_image_as`` converts as PIL's
    ``convert("RGB"/"RGBA")`` (``colmap.py:194``, ``prepare_data``), the
    metrics keep the first three."""
    from igs_tpu.data import dataset as jds, native as jnative
    from igs_tpu_torch.data import dataset, native
    from igs_tpu_torch.data.images import read_image_as

    path = os.path.join(tmp_path, "cmyk.jpg")
    with open(path, "wb") as f:
        f.write(_cmyk_bytes(_image(24, 40, seed=40), quality=90))
    np.testing.assert_array_equal(dataset.load_image(path),
                                  jds.load_image(path))
    np.testing.assert_array_equal(
        native.load_images_nchw([path, path], 24, 40),
        jnative.load_images_nchw([path, path], 24, 40))
    for mode in ("RGB", "RGBA"):
        np.testing.assert_array_equal(
            read_image_as(path, mode),
            np.asarray(Image.open(path).convert(mode)))
    assert read_image(path).shape == (24, 40, 4)
