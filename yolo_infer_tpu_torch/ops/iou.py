"""Pairwise box IoU.

Port of `yolo_infer_tpu/ops/iou.py` (`box_area`, `box_iou_matrix`). The
operation order is the JAX package's, `inter / (area_a + area_b - inter +
eps)`, so the NMS keep masks built on it agree bit for bit.
"""

from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (boxes[..., 3] - boxes[..., 1]).clamp(min=0)


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU: a (..., N, 4), b (..., M, 4) xyxy -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / (union + eps)
