"""On-device letterbox + normalize.

Port of `yolo_infer_tpu/ops/preprocess.py`: raw uint8 NHWC frames go to the
device and are resized, scaled by 1/255 and padded there.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from yolo_infer_tpu_torch.ops.letterbox import PAD_VALUE, letterbox_params


def preprocess_batch(
    images: torch.Tensor,  # (B, H, W, 3) uint8, RGB
    out_hw: Tuple[int, int] = (640, 640),
    scaleup: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 RGB frames -> letterboxed, /255-normalized (B, out_h, out_w, 3)."""
    b, h, w, _ = images.shape
    r, (dw, dh), (new_w, new_h) = letterbox_params((h, w), out_hw, scaleup)
    if (new_h, new_w) != (h, w):
        # bilinear with half-pixel centres and no antialias (cv2.INTER_LINEAR,
        # what YOLO11 checkpoints were trained with), interpolated in f32
        x = images.permute(0, 3, 1, 2).float()
        x = F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False, antialias=False)
        x = (x * (1.0 / 255.0)).to(dtype).permute(0, 2, 3, 1)
    else:
        # no resize (square sources, the serving fast path): cast + scale only
        x = (images.float() * (1.0 / 255.0)).to(dtype)
    top = int(round(dh - 0.1))
    left = int(round(dw - 0.1))
    if (new_h, new_w) != tuple(out_hw):
        out = torch.full((b, out_hw[0], out_hw[1], 3), PAD_VALUE / 255.0, dtype=dtype, device=images.device)
        out[:, top:top + new_h, left:left + new_w] = x
        x = out
    return x
