"""Letterbox geometry and its inverse (host side, numpy).

Port of `yolo_infer_tpu/ops/letterbox.py`: aspect-preserving scale, centre
pad with gray 114, and the inverse un-pad/un-scale/clamp applied to the
detections. The on-device resize + pad lives in `ops.preprocess`.
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


def letterbox(
    img: np.ndarray,
    new_shape: Union[int, Tuple[int, int]] = 640,
    color: int = PAD_VALUE,
    scaleup: bool = True,
) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """Resize `img` (H, W, 3 uint8) preserving aspect, center-pad to `new_shape`.

    Host-side path for batches of mixed frame sizes. Returns
    (padded_image, ratio, (dw, dh)). OpenCV is imported here only, so the
    rest of the port runs on hosts without it.
    """
    import cv2

    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r, (dw, dh), (new_w, new_h) = letterbox_params(img.shape[:2], new_shape, scaleup)
    if (img.shape[1], img.shape[0]) != (new_w, new_h):
        img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    img = cv2.copyMakeBorder(img, top, bottom, left, right, cv2.BORDER_CONSTANT, value=(color, color, color))
    return img, r, (dw, dh)


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
