"""Letterbox geometry and its inverse (host side, numpy).

Port of `yolo_infer_tpu/ops/letterbox.py`: aspect-preserving scale, centre
pad with gray 114, and the inverse un-pad/un-scale/clamp applied to the
detections, rotated boxes and masks. The on-device resize + pad lives in
`ops.preprocess`.

The host letterbox (mixed frame sizes) resizes with `resize_linear_u8`, a
numpy copy of OpenCV's `cv2.resize(..., INTER_LINEAR)` on uint8 frames, so
the port needs no OpenCV.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

PAD_VALUE = 114


def letterbox_params(shape_hw: Tuple[int, int], new_shape: Union[int, Tuple[int, int]], scaleup: bool = True):
    """Compute (ratio, (dw, dh), (new_w, new_h)) for a letterbox resize."""
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    h, w = shape_hw
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    new_w, new_h = round(w * r), round(h * r)
    dw, dh = (new_shape[1] - new_w) / 2, (new_shape[0] - new_h) / 2
    return r, (dw, dh), (new_w, new_h)


# OpenCV's fixed-point bilinear weights: 11 fractional bits
_COEF_BITS = 11
_COEF_ONE = 1 << _COEF_BITS


def _linear_taps(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per output index along one axis: (first source index, its weight,
    the next index's weight), as OpenCV computes them: the half-pixel source
    coordinate in f32 from a double scale of 1 / (dst / src), each weight
    rounded to 11 fractional bits on its own."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    return s, f


def _fixed_weights(f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    one = np.float32(_COEF_ONE)
    return (np.rint((np.float32(1) - f) * one).astype(np.int32),
            np.rint(f * one).astype(np.int32))


def resize_linear_u8(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """`cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)` for
    an (H, W, C) uint8 image, bit for bit.

    OpenCV resizes uint8 in fixed point: a horizontal pass with 11-bit
    weights into int32 rows (columns past the edges take the edge pixel at
    full weight), then a vertical pass on those rows (source rows clamped)
    that drops 4 bits, keeps the high 16 of each 16x16-bit product and rounds
    the last 2 bits half up. A shrink by exactly 2 on both axes takes its
    area path instead: the rounded mean of each 2x2 block.
    """
    h, w = img.shape[:2]
    src = img.astype(np.int32)
    if w == 2 * new_w and h == 2 * new_h:
        acc = src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] + src[1::2, 1::2]
        return ((acc + 2) >> 2).astype(np.uint8)
    sx, fx = _linear_taps(new_w, w)
    edge = (sx < 0) | (sx >= w - 1)
    fx[edge] = 0
    sx = np.clip(sx, 0, w - 1)
    a0, a1 = _fixed_weights(fx)
    a0, a1 = a0[:, None], a1[:, None]
    sx1 = np.minimum(sx + 1, w - 1)
    sy, fy = _linear_taps(new_h, h)
    b0, b1 = _fixed_weights(fy)

    def hpass(rows: np.ndarray) -> np.ndarray:
        return src[rows][:, sx] * a0 + src[rows][:, sx1] * a1

    top = hpass(np.clip(sy, 0, h - 1)) >> 4
    bottom = hpass(np.clip(sy + 1, 0, h - 1)) >> 4
    out = (((b0[:, None, None] * top) >> 16) + ((b1[:, None, None] * bottom) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def letterbox(
    img: np.ndarray,
    new_shape: Union[int, Tuple[int, int]] = 640,
    color: int = PAD_VALUE,
    scaleup: bool = True,
) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """Resize `img` (H, W, 3 uint8) preserving aspect, center-pad to `new_shape`.

    Host-side path for batches of mixed frame sizes; the same pixels as the
    JAX package's OpenCV letterbox. Returns (padded_image, ratio, (dw, dh)).
    """
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r, (dw, dh), (new_w, new_h) = letterbox_params(img.shape[:2], new_shape, scaleup)
    if (img.shape[1], img.shape[0]) != (new_w, new_h):
        img = resize_linear_u8(img, new_w, new_h)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.full((img.shape[0] + top + bottom, img.shape[1] + left + right, img.shape[2]), color, np.uint8)
    out[top:top + img.shape[0], left:left + img.shape[1]] = img
    return out, r, (dw, dh)


def scale_obb(obb: np.ndarray, ratio: float, pad: Tuple[float, float]) -> np.ndarray:
    """Map rotated boxes (cx, cy, w, h, rad) from letterboxed coords to original."""
    out = np.asarray(obb, np.float32).copy()
    out[:, 0] = (out[:, 0] - pad[0]) / ratio
    out[:, 1] = (out[:, 1] - pad[1]) / ratio
    out[:, 2:4] /= ratio
    return out


def crop_letterbox_slices(ratio: float, pad: Tuple[float, float], orig_shape_hw: Tuple[int, int],
                          downsample: int = 4) -> Tuple[int, int, int, int]:
    """(y0, x0, ch, cw) of the content region inside the letterboxed grid —
    the one rounding rule that `crop_letterbox_masks` and `LazyMasks.shape`
    share."""
    x0 = int(round(pad[0] / downsample))
    y0 = int(round(pad[1] / downsample))
    ch = max(int(round(orig_shape_hw[0] * ratio / downsample)), 1)
    cw = max(int(round(orig_shape_hw[1] * ratio / downsample)), 1)
    return y0, x0, ch, cw


def crop_letterbox_masks(masks: np.ndarray, ratio: float, pad: Tuple[float, float],
                         orig_shape_hw: Tuple[int, int], downsample: int = 4) -> np.ndarray:
    """Remove the letterbox padding band from grid masks so their aspect
    matches the original image."""
    if masks.size == 0:
        return masks
    y0, x0, ch, cw = crop_letterbox_slices(ratio, pad, orig_shape_hw, downsample)
    return masks[:, y0: y0 + ch, x0: x0 + cw]


def scale_boxes(
    boxes: np.ndarray,
    ratio: float,
    pad: Tuple[float, float],
    orig_shape_hw: Tuple[int, int],
) -> np.ndarray:
    """Map xyxy boxes from letterboxed coords back to the original image."""
    boxes = np.asarray(boxes, dtype=np.float32).copy()
    dw, dh = pad
    boxes[..., [0, 2]] -= dw
    boxes[..., [1, 3]] -= dh
    boxes /= ratio
    h, w = orig_shape_hw
    boxes[..., [0, 2]] = boxes[..., [0, 2]].clip(0, w)
    boxes[..., [1, 3]] = boxes[..., [1, 3]].clip(0, h)
    return boxes
