"""OpenCV's undistortion, in numpy: the camera matrix for the undistorted
image, the undistortion maps, bilinear remapping, and cv2's BGR reading
and writing of PNGs.

``prepare_data panoptic`` (the JAX package's ``prepare_data.py:193-211``)
calls ``cv2.getOptimalNewCameraMatrix(K, dist, (w, h), alpha=0)``,
``cv2.initUndistortRectifyMap(K, dist, None, K', (w, h), cv2.CV_32FC1)``
and ``cv2.remap(img, m1, m2, cv2.INTER_LINEAR)``; the card's machine has
no cv2, so the port carries the same arithmetic:

* ``optimal_new_camera_matrix``: a 9×9 grid over ``[0, w-1]×[0, h-1]``
  undistorted by five fixed-point iterations (cv2's ``undistortPoints``
  default); the inner rectangle (the largest x of the left column, the
  smallest of the right one, likewise in y) and the outer one are mapped
  onto ``[0, size-1]`` and blended by ``alpha``; the valid-pixel ROI is
  the inner rectangle of the grid undistorted into the new matrix,
  rounded half to even and clipped to the image.
* ``init_undistort_rectify_map``: the forward distortion model in double
  per output pixel (the new matrix inverted as cv2's ``DECOMP_LU`` does),
  cast to float32. It equals cv2's maps bit for bit but for rare values
  one float32 ulp apart, where cv2's vectorised loop rounds a double in
  another order next to a float32 rounding boundary (at most 1e-6 of the
  values: ``tests/test_torch_port_undistort.py``).
* ``remap_linear``: cv2 5's float32 bilinear form, ``top = fma(ax, p01 −
  p00, p00)``, ``bot = fma(ax, p11 − p10, p10)``, ``round(fma(ay, bot −
  top, top))`` (fused: one rounding each) with ``ax = mx − floor(mx)``,
  neighbours outside the image 0 (``BORDER_CONSTANT``), rounding half to
  even.

Distortion takes 4, 5 or 8 coefficients (k1 k2 p1 p2 [k3 [k4 k5 k6]]),
as cv2 reads them.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from igs_tpu_torch.data.images import read_png_samples, write_png

_GRID = 9
_ITERATIONS = 5


def _dist14(dist) -> np.ndarray:
    d = np.asarray(dist, np.float64).reshape(-1)
    if d.size not in (4, 5, 8):
        raise ValueError(f"distortion takes 4, 5 or 8 coefficients "
                         f"(k1 k2 p1 p2 [k3 [k4 k5 k6]]), got {d.size}")
    k = np.zeros(14)
    k[:d.size] = d
    return k


def undistort_points(pts: np.ndarray, K: np.ndarray, dist,
                     P: Optional[np.ndarray] = None) -> np.ndarray:
    """(N, 2) pixel points → undistorted: normalised coordinates, or pixels
    of ``P`` when given (``cv2.undistortPoints(pts, K, dist, None, P)``)."""
    K = np.asarray(K, np.float64)
    k = _dist14(dist)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ifx, ify = 1.0 / fx, 1.0 / fy
    u = pts[:, 0].astype(np.float64)
    v = pts[:, 1].astype(np.float64)
    x = (u - cx) * ifx
    y = (v - cy) * ify
    x0, y0 = x.copy(), y.copy()
    done = np.zeros(x.shape, bool)
    for _ in range(_ITERATIONS):
        r2 = x * x + y * y
        icdist = ((1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
                  / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2))
        # a negative factor: cv2 keeps the undistorted-by-nothing point
        neg = (icdist < 0) & ~done
        x = np.where(neg, (u - cx) * ifx, x)
        y = np.where(neg, (v - cy) * ify, y)
        done |= neg
        dx = (2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2
              + k[9] * r2 * r2)
        dy = (k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2
              + k[11] * r2 * r2)
        x = np.where(done, x, (x0 - dx) * icdist)
        y = np.where(done, y, (y0 - dy) * icdist)
    rr = np.eye(3) if P is None else np.asarray(P, np.float64)[:, :3]
    xx = rr[0, 0] * x + rr[0, 1] * y + rr[0, 2]
    yy = rr[1, 0] * x + rr[1, 1] * y + rr[1, 2]
    ww = 1.0 / (rr[2, 0] * x + rr[2, 1] * y + rr[2, 2])
    return np.stack([xx * ww, yy * ww], axis=1)


def _rectangles(K, dist, size, P=None):
    """(inner, outer) as (x, y, width, height) of the undistorted grid."""
    w, h = size
    g = np.arange(_GRID, dtype=np.float64)
    ys, xs = np.meshgrid(g * (h - 1) / (_GRID - 1), g * (w - 1) / (_GRID - 1),
                         indexing="ij")
    p = undistort_points(np.stack([xs.ravel(), ys.ravel()], 1), K, dist, P)
    px = p[:, 0].reshape(_GRID, _GRID)  # [row y, column x]
    py = p[:, 1].reshape(_GRID, _GRID)
    ix0, ix1 = px[:, 0].max(), px[:, -1].min()
    iy0, iy1 = py[0, :].max(), py[-1, :].min()
    ox0, ox1, oy0, oy1 = px.min(), px.max(), py.min(), py.max()
    return ((ix0, iy0, ix1 - ix0, iy1 - iy0),
            (ox0, oy0, ox1 - ox0, oy1 - oy0))


def _clip_rect(r, width, height) -> Tuple[int, int, int, int]:
    """cv2's ``Rect_<double>`` → ``Rect`` (round half to even) ``&= (0, 0,
    width, height)``."""
    x, y, w, h = (int(np.rint(v)) for v in r)
    if w <= 0 or h <= 0:
        return (0, 0, 0, 0)
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, width), min(y + h, height)
    if x1 <= x0 or y1 <= y0:
        return (0, 0, 0, 0)
    return (x0, y0, x1 - x0, y1 - y0)


def optimal_new_camera_matrix(K, dist, size: Sequence[int],
                              alpha: float = 0.0):
    """``cv2.getOptimalNewCameraMatrix(K, dist, size, alpha)`` → (K' (3, 3)
    float64, roi (x, y, w, h)). ``size`` is (width, height), kept for the
    new image; ``alpha`` in [0, 1]: 0 keeps only valid pixels, 1 keeps
    every source pixel."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must lie in [0, 1], got {alpha}")
    w, h = nw, nh = size
    K = np.asarray(K, np.float64)
    inner, outer = _rectangles(K, dist, (w, h))
    fx0, fy0 = (nw - 1) / inner[2], (nh - 1) / inner[3]
    cx0, cy0 = -fx0 * inner[0], -fy0 * inner[1]
    fx1, fy1 = (nw - 1) / outer[2], (nh - 1) / outer[3]
    cx1, cy1 = -fx1 * outer[0], -fy1 * outer[1]
    m = K.copy()
    m[0, 0] = fx0 * (1 - alpha) + fx1 * alpha
    m[1, 1] = fy0 * (1 - alpha) + fy1 * alpha
    m[0, 2] = cx0 * (1 - alpha) + cx1 * alpha
    m[1, 2] = cy0 * (1 - alpha) + cy1 * alpha
    inner, _ = _rectangles(K, dist, (w, h), P=m)
    return m, _clip_rect(inner, nw, nh)


def _lu_inverse(a: np.ndarray) -> np.ndarray:
    """Inverse by cv2's ``DECOMP_LU`` (partial pivoting, then back
    substitution dividing by the pivot), operation for operation."""
    a = np.array(a, np.float64)
    m = a.shape[0]
    b = np.eye(m)
    for i in range(m):
        k = i + int(np.argmax(np.abs(a[i:, i])))
        if k != i:
            a[[i, k]] = a[[k, i]]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, m):
            alpha = a[j, i] * d
            for c in range(i + 1, m):
                a[j, c] += alpha * a[i, c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        for j in range(m):
            s = b[i, j]
            for c in range(i + 1, m):
                s -= a[i, c] * b[c, j]
            b[i, j] = s / a[i, i]
    return b


def init_undistort_rectify_map(K, dist, R, new_K, size: Sequence[int]):
    """``cv2.initUndistortRectifyMap(K, dist, R, new_K, size, CV_32FC1)``
    → (map_x, map_y), each (h, w) float32: the source pixel of every pixel
    of the undistorted image. ``R`` None is the identity."""
    w, h = size
    K = np.asarray(K, np.float64)
    k = _dist14(dist)
    r = np.eye(3) if R is None else np.asarray(R, np.float64)
    ir = _lu_inverse(np.asarray(new_K, np.float64)[:, :3] @ r)
    j = np.arange(w, dtype=np.float64)[None, :]
    i = np.arange(h, dtype=np.float64)[:, None]
    _x = i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]
    _y = i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]
    _w = i * ir[2, 1] + ir[2, 2] + j * ir[2, 0]
    iw = 1.0 / _w
    x, y = _x * iw, _y * iw
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = ((1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
          / (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2))
    xd = x * kr + k[2] * _2xy + k[3] * (r2 + 2 * x2) + k[8] * r2 \
        + k[9] * r2 * r2
    yd = y * kr + k[2] * (r2 + 2 * y2) + k[3] * _2xy + k[10] * r2 \
        + k[11] * r2 * r2
    u = K[0, 0] * xd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


def remap_linear(img: np.ndarray, map_x: np.ndarray,
                 map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR)`` with a constant
    0 border: (H, W) or (H, W, C) uint8 → the maps' (h, w) shape."""
    src = np.asarray(img)
    if src.dtype != np.uint8:
        raise TypeError(f"remap_linear takes uint8 pixels, got {src.dtype}")
    grey = src.ndim == 2
    if grey:
        src = src[:, :, None]
    mx = np.asarray(map_x, np.float32)
    my = np.asarray(map_y, np.float32)
    fx, fy = np.floor(mx), np.floor(my)
    ax = (mx - fx)[..., None]
    ay = (my - fy)[..., None]
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
    h, w = src.shape[:2]

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        vals = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], vals, 0).astype(np.float32)

    def fma(a, b, c):
        # cv2 fuses each multiply-add: the float32 product is exact in
        # float64, so one float64 add and one rounding to float32 match
        return (a.astype(np.float64) * b + c).astype(np.float32)

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = fma(ax, p01 - p00, p00)
    bot = fma(ax, p11 - p10, p10)
    out = np.clip(np.rint(fma(ay, bot - top, top)), 0, 255).astype(np.uint8)
    return out[:, :, 0] if grey else out


def imread_bgr(path: str) -> np.ndarray:
    """``cv2.imread(path)`` (IMREAD_COLOR) of a PNG of any kind: (H, W, 3)
    uint8 in BGR order from its samples (``data/images.read_png_samples``):
    the palette applied, low-depth grey scaled to 8 bits, 16-bit samples
    as their high byte, grey repeated, alpha and ``tRNS`` dropped."""
    if os.path.splitext(path)[1].lower() != ".png":
        raise ValueError(f"{path}: imread_bgr reads PNG files only")
    s = read_png_samples(path)
    px = s.samples
    if s.color == 3:
        px = s.palette256()[px[:, :, 0]]
    elif s.depth == 16:
        px = (px >> 8).astype(np.uint8)
    elif s.depth < 8:
        px = (px * (255 // ((1 << s.depth) - 1))).astype(np.uint8)
    if px.shape[2] in (1, 2):
        px = np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, 2::-1])


def imwrite_bgr(path: str, img_bgr: np.ndarray) -> None:
    """``cv2.imwrite(path, img)`` of a BGR (H, W, 3) uint8 image as an RGB
    PNG (the pixels cv2 writes; the compressed bytes differ)."""
    if os.path.splitext(path)[1].lower() != ".png":
        raise ValueError(f"{path}: imwrite_bgr writes PNG files only")
    write_png(path, np.ascontiguousarray(np.asarray(img_bgr)[:, :, ::-1]))
