"""numpy copies of the OpenCV calls of training augmentation, bit for bit.

`yolo_infer_tpu/data/augment.py` calls OpenCV for the HSV jitter
(`cvtColor` RGB <-> HSV on uint8; its `LUT` is numpy indexing here), the
affine matrix (`getRotationMatrix2D`) and the warp (`warpAffine`, INTER_LINEAR,
BORDER_CONSTANT 114). The port computes each as OpenCV 5.0 does (the tests
hold every one against `cv2` on the same inputs; `resize_linear_u8` in
`ops/letterbox.py` is the resize):

- RGB -> HSV on uint8 is OpenCV's integer form: 12-bit fixed-point
  reciprocal tables for saturation and hue, hue in [0, 180).
- HSV -> RGB on uint8 is OpenCV's float form: s and v scaled by 1/255 in f32,
  h by 6/180, the sector's table of v*(1-s), v*(1-s*h), v*(1-s*(1-h)) with
  the inner products fused (FMA), times 255 and truncated.
- warpAffine on uint8 with INTER_LINEAR is OpenCV's float path (its
  fixed-point path with 5-bit interpolation tables is no longer taken for
  this case): the inverse map in double, taken to f32; per destination pixel
  the source coordinate `fma(M0, x, M1*y + M2)` (in the columns the 8-lane
  AVX2 loop covers, 16 at a time) or `fma(x, M0, M1*y) + M2` (its scalar tail),
  floor and fraction, the four taps (the border value where a tap lies
  outside), two horizontal lerps and a vertical one, each an FMA
  `fma(a, p1 - p0, p0)`, rounded half to even and saturated.

numpy has no fused multiply-add: `fma_f32` computes it exactly in float64
(the product of two f32 is exact there) and corrects the one case where
rounding the float64 sum to f32 rounds twice.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_F32 = np.float32
_F64 = np.float64


def fma_f32(a, b, c) -> np.ndarray:
    """round_f32(a * b + c) with one rounding, for f32 inputs (arrays or scalars)."""
    a, b, c = (np.asarray(v, _F32) for v in (a, b, c))
    p = a.astype(_F64) * b.astype(_F64)  # exact: 24 + 24 bits
    c64 = c.astype(_F64)
    s = np.asarray(p + c64)
    r = s.astype(_F32)
    # the f64 sum can land on an f32 midpoint that the exact sum is not on;
    # then the side of the exact sum (TwoSum's error term) decides
    mid = (s.view(np.uint64) & np.uint64((1 << 29) - 1)) == np.uint64(1 << 28)
    if not mid.any():
        return r
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    above = r.astype(_F64) > s
    lower = np.where(above, np.nextafter(r, _F32(-np.inf)), r)
    upper = np.where(above, r, np.nextafter(r, _F32(np.inf)))
    return np.where(mid & (err != 0), np.where(err > 0, upper, lower), r).astype(_F32)


# -------------------------------------------------------------------- colour

_HSV_SHIFT = 12
_I = np.arange(256, dtype=_F64)
with np.errstate(divide="ignore"):
    _SDIV = np.where(_I > 0, np.rint((255 << _HSV_SHIFT) / _I), 0).astype(np.int64)
    _HDIV180 = np.where(_I > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * _I)), 0).astype(np.int64)
del _I
# (b, g, r) <- tab[...] per hue sector, OpenCV's sector_data
_SECTOR_BGR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb2hsv_u8(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_RGB2HSV)` for an (H, W, 3) uint8 image."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = h + np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv2rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)` for an (H, W, 3) uint8 image
    whose hue is below 180 (as `rgb2hsv_u8` and the hue table give it)."""
    h = hsv[..., 0].astype(_F32) * _F32(6.0 / 180)
    s = hsv[..., 1].astype(_F32) * _F32(1.0 / 255.0)
    v = hsv[..., 2].astype(_F32) * _F32(1.0 / 255.0)
    sector = np.floor(h)
    h = h - sector
    one = _F32(1)
    tab = np.stack([v, v * (one - s), v * fma_f32(-s, h, one), v * fma_f32(-s, one - h, one)], -1)
    bgr = np.take_along_axis(tab, _SECTOR_BGR[sector.astype(np.int64) % 6], -1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    return np.clip(np.trunc(bgr[..., ::-1] * _F32(255)), 0, 255).astype(np.uint8)


# -------------------------------------------------------------------- affine

def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """`cv2.getRotationMatrix2D(center, angle, scale)`: (2, 3) float64."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], _F64)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """OpenCV's inverse of a (2, 3) forward map, in double: the six entries."""
    m = np.asarray(m, _F64).reshape(-1).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


# the float warp's vector loop: 2 x 8 f32 lanes per iteration (OpenCV's AVX2 build)
_WARP_UNROLL = 16


def warp_affine_linear_u8(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int], border: int = 114) -> np.ndarray:
    """`cv2.warpAffine(img, m, dsize, borderValue=(border,)*3)` (INTER_LINEAR,
    BORDER_CONSTANT) for an (H, W, C) uint8 image; `dsize` is (width, height)."""
    w_out, h_out = dsize
    minv = _invert_affine(m).astype(_F32)
    x = np.arange(w_out, dtype=_F32)[None, :]
    y = np.arange(h_out, dtype=_F32)[:, None]
    # vector columns: fma(M0, x, M1*y + M2); the scalar tail: fma(x, M0, M1*y) + M2
    vec = (np.arange(w_out) < (w_out // _WARP_UNROLL) * _WARP_UNROLL)[None, :]

    def coord(m0, m1, m2):
        my = y * m1
        v = fma_f32(_F32(m0), x, my + m2)
        t = fma_f32(x, _F32(m0), my) + m2
        return np.where(vec, v, t)

    sx, sy = coord(minv[0], minv[1], minv[2]), coord(minv[3], minv[4], minv[5])
    ix, iy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - ix)[..., None], (sy - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    h, w = img.shape[:2]

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        return np.where(ok[..., None], img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(_F32), _F32(border))

    p00, p01, p10, p11 = tap(iy, ix), tap(iy, ix + 1), tap(iy + 1, ix), tap(iy + 1, ix + 1)
    v0 = fma_f32(ax, p01 - p00, p00)
    v1 = fma_f32(ax, p11 - p10, p10)
    out = fma_f32(ay, v1 - v0, v0)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
