"""Box IoU: pairwise matrices and aligned pairs.

Port of `yolo_infer_tpu/ops/iou.py` (`box_area`, `box_iou_matrix`,
`bbox_iou_aligned`, `xywh2xyxy`, `xyxy2xywh`). The operation order is the
JAX package's, `inter / (area_a + area_b - inter + eps)`, so the NMS keep
masks built on it agree bit for bit.
"""

from __future__ import annotations

import math

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


def bbox_iou_aligned(a: torch.Tensor, b: torch.Tensor, *, kind: str = "iou", eps: float = 1e-7) -> torch.Tensor:
    """Element-aligned IoU, GIoU, DIoU or CIoU of xyxy boxes of one leading
    shape. CIoU's `alpha` is detached, as the JAX package stops its gradient."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter + eps
    iou = inter / union
    if kind == "iou":
        return iou
    clt = torch.minimum(a[..., :2], b[..., :2])
    crb = torch.maximum(a[..., 2:], b[..., 2:])
    cwh = (crb - clt).clamp(min=0)
    if kind == "giou":
        c_area = cwh[..., 0] * cwh[..., 1] + eps
        return iou - (c_area - union) / c_area
    c2 = cwh[..., 0] ** 2 + cwh[..., 1] ** 2 + eps
    ca = (a[..., :2] + a[..., 2:]) / 2
    cb = (b[..., :2] + b[..., 2:]) / 2
    rho2 = ((ca - cb) ** 2).sum(-1)
    if kind == "diou":
        return iou - rho2 / c2
    if kind == "ciou":
        wa, ha = a[..., 2] - a[..., 0], a[..., 3] - a[..., 1]
        wb, hb = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
        v = (4 / math.pi ** 2) * (torch.atan(wb / (hb + eps)) - torch.atan(wa / (ha + eps))) ** 2
        alpha = (v / (v - iou + (1 + eps))).detach()
        return iou - (rho2 / c2 + v * alpha)
    raise ValueError(kind)


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    c, half = x[..., :2], x[..., 2:4] / 2
    return torch.cat([c - half, c + half], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    a, b = x[..., :2], x[..., 2:4]
    return torch.cat([(a + b) / 2, b - a], dim=-1)
