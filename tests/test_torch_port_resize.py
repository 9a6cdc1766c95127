"""``igs_tpu_torch/data/resize.resize_bilinear`` against PIL's
``Image.resize((w, h), Image.BILINEAR)``, which the JAX ``prepare_data
subsample`` calls: bit for bit on 1, 2, 3 and 4 channels (RGBA and LA
resized premultiplied, as PIL does), down, up and mixed scaling,
including the N3DV cases 2028×2704 → 512² and 1014×1352 → 512², and a
hypothesis sweep of sizes 1–300. No tolerance: the arithmetic is the
same fixed-point integer arithmetic."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from igs_tpu_torch.data.resize import resize_bilinear

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def pil_resize(a, w, h):
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[:, :, 0]
    mode = MODES[1 if a.ndim == 2 else a.shape[2]]
    return np.asarray(Image.fromarray(a, mode).resize((w, h),
                                                      Image.BILINEAR))


def check(a, w, h):
    want = pil_resize(a, w, h)
    got = resize_bilinear(a, w, h)
    if a.ndim == 3 and a.shape[2] == 1:
        got = got[:, :, 0]
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [
    ((2028, 2704), (512, 512)), ((1014, 1352), (512, 512))])
def test_n3dv_sizes_bit_equal(src, dst):
    a = np.random.RandomState(0).randint(0, 256, src + (3,)).astype(np.uint8)
    check(a, *dst)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("src,dst", [
    ((40, 60), (17, 23)),     # down
    ((20, 20), (61, 7)),      # up in width, down in height
    ((9, 7), (40, 55)),       # up
    ((33, 17), (33, 5)),      # height kept: one pass
    ((1, 1), (4, 3)), ((5, 300), (300, 1))])
def test_channels_and_scalings_bit_equal(channels, src, dst):
    rng = np.random.RandomState(channels)
    a = rng.randint(0, 256, src + (channels,)).astype(np.uint8)
    if channels in (2, 4):  # alphas 0 and 255 take their own branch
        a[::3, ::2, -1] = 0
        a[1::3, ::2, -1] = 255
    check(a, dst[1], dst[0])


def test_grey_2d_and_same_size():
    a = np.random.RandomState(5).randint(0, 256, (21, 34)).astype(np.uint8)
    check(a, 13, 8)
    np.testing.assert_array_equal(resize_bilinear(a, 34, 21), a)


def test_refuses_other_inputs():
    with pytest.raises(TypeError, match="uint8"):
        resize_bilinear(np.zeros((4, 4, 3), np.uint16), 2, 2)
    with pytest.raises(ValueError, match="1..4"):
        resize_bilinear(np.zeros((4, 4, 5), np.uint8), 2, 2)
    with pytest.raises(ValueError, match="positive"):
        resize_bilinear(np.zeros((4, 4, 3), np.uint8), 0, 2)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 300), st.integers(1, 300), st.integers(1, 300),
       st.integers(1, 300), st.sampled_from([1, 3, 4]),
       st.integers(0, 2**31 - 1))
def test_sizes_hypothesis(h, w, oh, ow, channels, seed):
    a = np.random.RandomState(seed).randint(
        0, 256, (h, w, channels)).astype(np.uint8)
    check(a, ow, oh)
