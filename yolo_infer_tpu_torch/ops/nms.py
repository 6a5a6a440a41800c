"""Batched fixed-shape class-aware NMS.

Port of `yolo_infer_tpu/ops/nms.py`: the single-label select-then-decode
serving tail (`batched_nms_seldec`, keep mask by kernel A) and the full-grid
NMS of the validation program (`batched_nms`, multi-label or single-label:
a class-offset IoU matrix in plain torch, keep mask by kernel G). Candidates
are picked by score, sorted descending, offset by class (`MAX_WH`) and
suppressed greedily; every output has a fixed shape.

Greedy-equivalence: with candidates sorted by descending score, define
  f(kept)[j] = valid[j] and not any_i (i<j and kept[i] and iou[i,j] > t).
Sequential greedy NMS is the unique fixpoint of f reached from kept=valid, so
iterating f to stability (`_nms_fixpoint`) and the sequential walk of the
CUDA kernel (`ops/kernels/nms_fused.py`) give the same keep mask.

Two TPU workarounds of the JAX path have plain forms here: rows are picked
with `torch.gather` (not a one-hot contraction) and the top-k is a stable
descending sort (not ApproxTopK). Both keep `lax.top_k`'s lowest-index-first
order among equal scores.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import os

import numpy as np
import torch

from yolo_infer_tpu_torch.ops.decode import anchor_rows_from_idx, dfl_expectation, dist2bbox
from yolo_infer_tpu_torch.ops.iou import box_iou_matrix
from yolo_infer_tpu_torch.ops.kernels.greedy_nms import greedy_nms_keep
from yolo_infer_tpu_torch.ops.kernels.nms_fused import nms_keep
from yolo_infer_tpu_torch.ops.kernels.nms_walk import threshold_tensor

MAX_WH = 7680.0  # class-offset stride for class-aware suppression
Threshold = Union[float, torch.Tensor]  # a Python number or a 0-d f32 tensor on the scores' device


def _nms_fixpoint(iou: torch.Tensor, valid: torch.Tensor, iou_thres: Threshold, max_sweeps: int) -> torch.Tensor:
    """Greedy NMS keep mask over score-sorted candidates via fixpoint sweeps.

    iou (..., K, K) f32, valid (..., K) bool -> (..., K) bool. This is the
    plain version of the keep kernel.
    """
    k = iou.shape[-1]
    higher = torch.ones((k, k), dtype=torch.bool, device=iou.device).triu(1)  # [i, j]: i outranks j
    overlap = (iou > threshold_tensor(iou_thres, iou.device)) & higher
    kept = valid.clone()  # a new tensor even when no sweep changes it (an op's output may not alias its input)
    for _ in range(max_sweeps):
        suppressed = (overlap & kept[..., :, None]).any(dim=-2)
        new_kept = valid & ~suppressed
        if torch.equal(new_kept, kept):
            break
        kept = new_kept
    return kept


def nms_keep_mask(sup_boxes: torch.Tensor, valid: torch.Tensor, iou_thres: Threshold) -> torch.Tensor:
    """Greedy-NMS keep mask (B, K) bool over (B, K, 4) score-sorted,
    class-offset candidates: the CUDA kernel for a CUDA tensor, the fixpoint
    for a CPU tensor (`ops.kernels.nms_fused.nms_keep`)."""
    return nms_keep(sup_boxes, valid, iou_thres)


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-k along dim 1; equal values keep ascending index order."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _presel_finish(cboxes, ccls, top_scores, top_idx, iou_thres, *, max_det: int, class_aware: bool = True):
    """Keep mask over the score-sorted (B, K) candidates, then the fixed
    max_det output layout."""
    valid = top_scores > 0
    sup_boxes = cboxes + ccls[..., None] * MAX_WH if class_aware else cboxes
    kept = nms_keep_mask(sup_boxes.contiguous(), valid, iou_thres)
    return _keep_layout(kept, cboxes, ccls, top_scores, top_idx, max_det)


def _keep_layout(kept, cboxes, ccls, top_scores, top_idx, max_det: int) -> Dict[str, torch.Tensor]:
    """The kept candidates, best first, in fixed (B, max_det) slots: boxes
    (B, max_det, D), scores, classes, valid, num (B,) int32, anchor_idx;
    empty slots are zero / -1."""
    b, k = top_scores.shape
    final = torch.where(kept, top_scores, torch.full_like(top_scores, -1.0))
    if k < max_det:  # fewer candidates than output slots: pad before top_k
        pad = max_det - k
        final = torch.cat([final, final.new_full((b, pad), -1.0)], dim=1)
        cboxes = torch.cat([cboxes, cboxes.new_zeros((b, pad, cboxes.shape[-1]))], dim=1)
        ccls = torch.cat([ccls, ccls.new_zeros((b, pad))], dim=1)
        top_idx = torch.cat([top_idx, top_idx.new_zeros((b, pad))], dim=1)
    out_scores, sel = _topk_stable(final, max_det)
    out_valid = out_scores > 0
    zero = torch.zeros((), dtype=torch.float32, device=final.device)
    return {
        "boxes": torch.where(out_valid[..., None],
                             torch.gather(cboxes, 1, sel[..., None].expand(-1, -1, cboxes.shape[-1])), zero),
        "scores": torch.where(out_valid, out_scores, zero),
        "classes": torch.where(out_valid, torch.gather(ccls, 1, sel), torch.full_like(out_scores, -1.0)),
        "valid": out_valid,
        "num": out_valid.sum(dim=1, dtype=torch.int32),
        "anchor_idx": torch.where(out_valid, torch.gather(top_idx, 1, sel), 0).to(torch.int32),
    }


def batched_nms_seldec(
    box_dist: torch.Tensor,  # (B, A, 4*reg_max) RAW head dist logits (any float dtype)
    best: torch.Tensor,  # (B, A) best-class scores (sigmoided)
    cls: torch.Tensor,  # (B, A) best-class ids (float)
    conf_thres: Threshold = 0.25,
    iou_thres: Threshold = 0.45,
    *,
    feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int] = (8, 16, 32),
    reg_max: int = 16,
    pre_topk: int = 512,
    max_det: int = 300,
    class_aware: bool = True,
) -> Dict[str, torch.Tensor]:
    """Select-then-decode single-label NMS (pairs with `decode_scores_raw`).

    Candidates are chosen on scores alone; the DFL expectation then decodes
    the `pre_topk` selected rows only, in the head's dtype, with anchors from
    index arithmetic. Outputs: boxes (B, max_det, 4), scores, classes,
    valid, num (B,) int32, anchor_idx; invalid slots are zero / -1.
    """
    best = best.float()
    cls = cls.float()
    a = best.shape[1]
    k = min(pre_topk, a)
    cand = torch.where(best > threshold_tensor(conf_thres, best.device), best, torch.full_like(best, -1.0))
    top_scores, top_idx = _topk_stable(cand, k)
    sel_dist = torch.gather(box_dist, 1, top_idx[..., None].expand(-1, -1, box_dist.shape[-1]))
    ap, st = anchor_rows_from_idx(top_idx, feat_shapes, strides)
    dist = dfl_expectation(sel_dist, reg_max, dtype=sel_dist.dtype)
    cboxes = dist2bbox(dist, ap) * st
    ccls = torch.gather(cls, 1, top_idx)
    return _presel_finish(cboxes, ccls, top_scores, top_idx, iou_thres, max_det=max_det, class_aware=class_aware)


def _multi_label_topc() -> int:
    """Per-anchor class cap of multi-label NMS (the val protocol): 8, or the
    `YOLO_MULTI_LABEL_TOPC` environment variable (>= nc disables the cap)."""
    return int(os.environ.get("YOLO_MULTI_LABEL_TOPC", "8"))


def _topc_per_anchor(scores: torch.Tensor, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-C (values, indices) along the last axis: C rounds of max/argmax,
    each masking its pick to -inf. Values descend along C; ties go to the
    lowest class index (`torch.max` returns the first maximum on both
    devices), as `lax.top_k` orders them."""
    cur = scores.clone()  # masked in place below
    vals, idxs = [], []
    for _ in range(c):
        v, i = cur.max(dim=-1)
        vals.append(v)
        idxs.append(i)
        cur.scatter_(-1, i[..., None], float("-inf"))
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def batched_nms(
    boxes: torch.Tensor,  # (B, A, 4) xyxy, letterboxed pixels
    scores: torch.Tensor,  # (B, A, nc) sigmoided
    conf_thres: Threshold = 0.25,
    iou_thres: Threshold = 0.45,
    *,
    pre_topk: int = 1024,
    max_det: int = 300,
    class_aware: bool = True,
    multi_label: bool = False,
    multi_label_topc: int = 8,
) -> Dict[str, torch.Tensor]:
    """Class-aware greedy NMS over a batch (the validation program's NMS).

    Multi-label (nc > 1): each anchor's top-`multi_label_topc` classes (all
    nc when the cap is >= nc) form a pool of (anchor, class) pairs, of which
    the `pre_topk` best above `conf_thres` are candidates; single-label: each
    anchor's best class. The class-offset IoU matrix of the K candidates is
    built in plain torch (as the JAX package builds it) and the keep mask is
    kernel G (`greedy_nms_keep`). Outputs: boxes (B, max_det, 4), scores,
    classes, valid, num (B,) int32, anchor_idx; invalid slots are zero / -1.
    """
    boxes = boxes.float()
    scores = scores.float()
    b, a, nc = scores.shape
    conf = threshold_tensor(conf_thres, scores.device)
    if multi_label and nc > 1:
        c = multi_label_topc
        if c < nc:
            cls_scores, cls_idx = _topc_per_anchor(scores, c)  # (B, A, c)
            flat = cls_scores.reshape(b, -1)
            k = min(pre_topk, a * c)
            top_scores, top_idx = _topk_stable(torch.where(flat > conf, flat, torch.full_like(flat, -1.0)), k)
            anchor_idx = torch.div(top_idx, c, rounding_mode="floor")
            cls = torch.gather(cls_idx.reshape(b, -1), 1, top_idx).float()
        else:
            flat = scores.reshape(b, -1)
            k = min(pre_topk, a * nc)
            top_scores, top_idx = _topk_stable(torch.where(flat > conf, flat, torch.full_like(flat, -1.0)), k)
            anchor_idx = torch.div(top_idx, nc, rounding_mode="floor")
            cls = (top_idx % nc).float()
    else:
        best, cls_best = scores.max(dim=-1)
        k = min(pre_topk, a)
        top_scores, anchor_idx = _topk_stable(torch.where(best > conf, best, torch.full_like(best, -1.0)), k)
        cls = torch.gather(cls_best, 1, anchor_idx).float()
    cboxes = torch.gather(boxes, 1, anchor_idx[..., None].expand(-1, -1, 4))
    valid = top_scores > 0
    sup_boxes = cboxes + cls[..., None] * MAX_WH if class_aware else cboxes
    iou = box_iou_matrix(sup_boxes, sup_boxes)
    kept = greedy_nms_keep(iou, valid, iou_thres)
    return _keep_layout(kept, cboxes, cls, top_scores, anchor_idx, max_det)


def nms_numpy_reference(boxes, scores, iou_thres):
    """O(K²) sequential greedy NMS on host — the oracle for tests."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(boxes), dtype=bool)
    for pos, i in enumerate(order):
        if suppressed[i]:
            continue
        keep.append(i)
        for j in order[pos + 1:]:
            if suppressed[j]:
                continue
            xx1 = max(boxes[i, 0], boxes[j, 0])
            yy1 = max(boxes[i, 1], boxes[j, 1])
            xx2 = min(boxes[i, 2], boxes[j, 2])
            yy2 = min(boxes[i, 3], boxes[j, 3])
            inter = max(0.0, xx2 - xx1) * max(0.0, yy2 - yy1)
            area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
            area_j = (boxes[j, 2] - boxes[j, 0]) * (boxes[j, 3] - boxes[j, 1])
            iou = inter / (area_i + area_j - inter + 1e-7)
            if iou > iou_thres:
                suppressed[j] = True
    return np.array(keep, dtype=np.int64)
