"""``igs_tpu_torch/data/undistort.py`` against OpenCV, which the JAX
``prepare_data panoptic`` calls, on seeded camera matrices and
distortions of 4, 5 and 8 coefficients, barrel and pincushion:

* ``optimal_new_camera_matrix``: K' within 1e-9 relative to its largest
  entry and the ROI exactly, at alpha 0 (what ``panoptic`` uses), 0.5
  and 1;
* ``remap_linear``: bit-equal to ``cv2.remap(INTER_LINEAR)`` on the
  same maps, the undistortion's and random maps that cross the border
  (BORDER_CONSTANT 0), colour and grey;
* ``init_undistort_rectify_map``: bit-equal on all but at most 1e-6 of
  the values, the rest within one float32 ulp. The tolerance is loosened
  from bit equality because cv2 evaluates the double-precision model in
  a vectorised loop with fused multiply-adds: its doubles differ from
  the port's by an ulp, which moves the float32 rounding of the rare
  value lying next to a rounding boundary;
* ``imread_bgr``/``imwrite_bgr``: ``cv2.imread``'s pixels (grey, RGB,
  RGBA and 16-bit PNGs) and a PNG that ``cv2.imread`` reads back equal.
"""

import cv2
import numpy as np
import pytest

from igs_tpu_torch.data.images import write_png
from igs_tpu_torch.data.undistort import (
    imread_bgr, imwrite_bgr, init_undistort_rectify_map,
    optimal_new_camera_matrix, remap_linear)

DISTORTIONS = {
    "barrel4": [-0.30, 0.10, 0.001, 0.0005],
    "panoptic5": [-0.225, 0.19, 0.0004, -0.0002, -0.07],
    "pincushion5": [0.12, -0.05, 0.0, 0.001, 0.02],
    "rational8": [-0.28, 0.07, 0.0003, -0.0001, 0.0, 0.01, 0.002, 0.0005],
    "pincushion8": [0.25, 0.1, -0.002, 0.001, 0.05, 0.1, 0.02, 0.01],
}
SIZES = [(1920, 1080), (160, 96)]


def camera(size, seed):
    rng = np.random.RandomState(seed)
    w, h = size
    f = w * rng.uniform(0.6, 0.8)
    return np.array([[f, 0.0, w / 2 + rng.uniform(-4, 4)],
                     [0.0, f * rng.uniform(0.98, 1.02),
                      h / 2 + rng.uniform(-4, 4)],
                     [0.0, 0.0, 1.0]])


@pytest.mark.parametrize("name", list(DISTORTIONS))
@pytest.mark.parametrize("size", SIZES)
def test_new_camera_matrix_and_roi(name, size):
    k = camera(size, 0)
    d = np.array(DISTORTIONS[name])
    for alpha in (0.0, 0.5, 1.0):
        want, roi = cv2.getOptimalNewCameraMatrix(k, d, size, alpha=alpha)
        got, got_roi = optimal_new_camera_matrix(k, d, size, alpha=alpha)
        assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max(), alpha
        assert got_roi == tuple(roi), alpha


@pytest.mark.parametrize("name", list(DISTORTIONS))
@pytest.mark.parametrize("size", SIZES)
def test_maps_and_remap(name, size):
    k = camera(size, 1)
    d = np.array(DISTORTIONS[name])
    new_k, _ = cv2.getOptimalNewCameraMatrix(k, d, size, alpha=0)
    m1, m2 = cv2.initUndistortRectifyMap(k, d, None, new_k, size,
                                         cv2.CV_32FC1)
    g1, g2 = init_undistort_rectify_map(k, d, None, new_k, size)
    for want, got in ((m1, g1), (m2, g2)):
        assert got.dtype == np.float32 and got.shape == (size[1], size[0])
        off = got != want
        assert off.mean() <= 1e-6
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    img = np.random.RandomState(2).randint(
        0, 256, (size[1], size[0], 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        remap_linear(img, m1, m2),
        cv2.remap(img, m1, m2, interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("shape", [(37, 53, 3), (37, 53)])
def test_remap_across_the_border(shape):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    h, w = shape[:2]
    mx = rng.uniform(-3, w + 3, (41, 67)).astype(np.float32)
    my = rng.uniform(-3, h + 3, (41, 67)).astype(np.float32)
    mx[0, :5] = [-1.0, -0.5, w - 1, w - 0.5, w]  # on and past the edges
    my[0, :5] = [0.0, h - 1, -0.25, h - 0.75, 3.0]
    np.testing.assert_array_equal(
        remap_linear(img, mx, my),
        cv2.remap(img, mx, my, interpolation=cv2.INTER_LINEAR))


def test_other_distortion_counts_raise():
    k = camera((64, 48), 0)
    for n in (3, 6, 12, 14):
        with pytest.raises(ValueError, match="4, 5 or 8 coefficients"):
            optimal_new_camera_matrix(k, np.zeros(n), (64, 48))
        with pytest.raises(ValueError, match="4, 5 or 8 coefficients"):
            init_undistort_rectify_map(k, np.zeros(n), None, k, (64, 48))


@pytest.mark.parametrize("kind", ["rgb", "rgba", "grey", "grey16"])
def test_bgr_reading_and_writing(tmp_path, kind):
    rng = np.random.RandomState(4)
    path = str(tmp_path / f"{kind}.png")
    if kind == "rgb":
        write_png(path, rng.randint(0, 256, (9, 11, 3)).astype(np.uint8))
    elif kind == "grey":
        write_png(path, rng.randint(0, 256, (9, 11)).astype(np.uint8))
    elif kind == "grey16":
        write_png(path, rng.randint(0, 65536, (9, 11)).astype(np.uint16))
    else:
        cv2.imwrite(path, rng.randint(0, 256, (9, 11, 4)).astype(np.uint8))
    np.testing.assert_array_equal(imread_bgr(path), cv2.imread(path))
    out = str(tmp_path / "out.png")
    bgr = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    imwrite_bgr(out, bgr)
    np.testing.assert_array_equal(cv2.imread(out), bgr)
