"""Oriented boxes: decode and probIoU rotated NMS.

Port of `yolo_infer_tpu/ops/rotated.py`. Boxes are (cx, cy, w, h, angle in
rad); the overlap is probIoU, 1 minus the Hellinger distance between the
boxes' Gaussian approximations. The keep mask over the score-sorted
candidates is kernel C (`ops/kernels/rotated_nms_fused.py`) on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from yolo_infer_tpu_torch.ops.kernels.nms_walk import threshold_tensor
from yolo_infer_tpu_torch.ops.kernels.rotated_nms_fused import rotated_nms_keep
from yolo_infer_tpu_torch.ops.nms import MAX_WH, Threshold, _keep_layout, _topk_stable

EPS = 1e-7


def dist2rbox(dist: torch.Tensor, angle: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """DFL ltrb distances (in the box's rotated frame) + angle -> (cx, cy, w, h) in grid units."""
    lt, rb = dist.chunk(2, dim=-1)
    c, s = torch.cos(angle), torch.sin(angle)
    xf = (rb[..., 0] - lt[..., 0]) / 2
    yf = (rb[..., 1] - lt[..., 1]) / 2
    cx = xf * c - yf * s + anchor_points[..., 0]
    cy = xf * s + yf * c + anchor_points[..., 1]
    return torch.stack([cx, cy, lt[..., 0] + rb[..., 0], lt[..., 1] + rb[..., 1]], dim=-1)


def _cov(boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotated boxes (..., 5) -> Gaussian covariance terms (a, b, c).

    w²/12 is written as a product with 1/12: that is what XLA and PyTorch's
    CUDA division by a constant compute, so the terms agree on every device.
    """
    w, h, r = boxes[..., 2], boxes[..., 3], boxes[..., 4]
    a_ = w * w * (1.0 / 12.0)
    b_ = h * h * (1.0 / 12.0)
    cos, sin = torch.cos(r), torch.sin(r)
    a = a_ * (cos * cos) + b_ * (sin * sin)
    b = a_ * (sin * sin) + b_ * (cos * cos)
    c = (a_ - b_) * cos * sin
    return a, b, c


def gauss_terms(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) rotated boxes -> (..., 5) f32 [x, y, a, b, c], kernel C's input."""
    a, b, c = _cov(boxes)
    return torch.stack([boxes[..., 0], boxes[..., 1], a, b, c], dim=-1)


def _probiou_from_terms(a1, b1, c1, x1, y1, a2, b2, c2, x2, y2, eps: float = EPS) -> torch.Tensor:
    """Bhattacharyya / Hellinger probIoU from broadcast covariance terms: the
    one copy of the clamp chain, in the JAX package's order (kernel C repeats
    it operation for operation)."""
    dx = x1 - x2
    dy = y1 - y2
    sa = a1 + a2
    sb = b1 + b2
    sc = c1 + c2
    # Bhattacharyya distance with Sigma = (Sigma1 + Sigma2) / 2, written with
    # the sum S of the covariances: (1/8) d^T Sigma^-1 d = 0.25 d^T S^-1 d,
    # and det(Sigma) = det(S) / 4 gives the 4 inside the log
    denom = sa * sb - sc * sc + eps
    t1 = (sb * (dx * dx) + sa * (dy * dy) - 2 * sc * dx * dy) / denom * 0.25
    # dets clamped inside the sqrt, so zero-size (padding) boxes stay finite
    det1 = torch.clamp(a1 * b1 - c1 * c1, min=eps)
    det2 = torch.clamp(a2 * b2 - c2 * c2, min=eps)
    t3 = torch.log(denom / (4 * torch.sqrt(det1 * det2) + eps) + eps) * 0.5
    bd = torch.clamp(t1 + t3, eps, 100.0)
    hd = torch.sqrt(torch.clamp(1.0 - torch.exp(-bd), min=eps))
    return 1.0 - hd


def probiou_gauss_matrix(g1: torch.Tensor, g2: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Pairwise probIoU from Gaussian terms: (..., N, 5) x (..., M, 5) -> (..., N, M)."""
    x1, y1, a1, b1, c1 = (v[..., :, None] for v in g1.unbind(-1))
    x2, y2, a2, b2, c2 = (v[..., None, :] for v in g2.unbind(-1))
    return _probiou_from_terms(a1, b1, c1, x1, y1, a2, b2, c2, x2, y2, eps)


def probiou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Pairwise probIoU of rotated boxes: (..., N, 5) x (..., M, 5) -> (..., N, M) in [0, 1]."""
    return probiou_gauss_matrix(gauss_terms(boxes1), gauss_terms(boxes2), eps)


def rotated_nms_keep_mask(sup: torch.Tensor, valid: torch.Tensor, iou_thres: Threshold) -> torch.Tensor:
    """Greedy probIoU-NMS keep mask (B, K) bool over (B, K, 5) score-sorted
    candidates: the Gaussian terms are computed here, outside the kernel, as
    the JAX package does, then kernel C (or its plain version on the CPU)."""
    return rotated_nms_keep(gauss_terms(sup).contiguous(), valid.contiguous(), iou_thres)


def batched_rotated_nms(
    rboxes: torch.Tensor,  # (B, A, 5) xywhr, letterboxed pixels
    scores: torch.Tensor,  # (B, A, nc)
    conf_thres: Threshold = 0.25,
    iou_thres: Threshold = 0.45,
    *,
    pre_topk: int = 1024,
    max_det: int = 300,
    multi_label: bool = False,
) -> Dict[str, torch.Tensor]:
    """Single-label rotated NMS with fixed-shape outputs: boxes
    (B, max_det, 5) xywhr, scores, classes, valid, num (B,) int32,
    anchor_idx; invalid slots are zero / -1."""
    if multi_label:
        raise NotImplementedError("multi-label rotated NMS is not ported yet (ROADMAP Queue 1 item 4.2, OBB validation)")
    rboxes = rboxes.float()
    scores = scores.float()
    best, cls_best = scores.max(dim=-1)
    a = best.shape[1]
    k = min(pre_topk, a)
    cand = torch.where(best > threshold_tensor(conf_thres, best.device), best, torch.full_like(best, -1.0))
    top_scores, top_idx = _topk_stable(cand, k)
    cls = torch.gather(cls_best.float(), 1, top_idx)
    cb = torch.gather(rboxes, 1, top_idx[..., None].expand(-1, -1, 5))
    sup = cb.clone()
    sup[..., 0] += cls * MAX_WH  # class-aware: shift centres apart per class
    kept = rotated_nms_keep_mask(sup, top_scores > 0, iou_thres)
    return _keep_layout(kept, cb, cls, top_scores, top_idx, max_det)
