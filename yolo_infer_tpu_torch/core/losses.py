"""YOLO11 training losses: task-aligned assignment + CIoU + DFL + BCE, and
the classify cross-entropy.

Port of `yolo_infer_tpu/core/losses.py` (`DEFAULT_HYP`, `_assign_from_align`,
`task_aligned_assigner`, `_dfl_loss`, `detection_loss`, `optax_sigmoid_bce`,
`classification_loss`). Ground truth is padded to `max_boxes` per image with
a validity mask, and the assigner is one batched (B, M, A) tensor program, as
there. It runs under `torch.no_grad` on detached predictions (the JAX
package's `stop_gradient`): its targets are constants of the backward.

Where the JAX package gathers through one-hot contractions at
`Precision.HIGHEST` (a TPU layout choice), the port gathers with
`torch.gather`: the same values bit for bit (at most one positive gt per
anchor), and no matmul that TF32 or bf16 could round. The assigner never
builds a (B, M, A, nc) tensor: at b16, M = 120, A = 8400 one (B, M, A) f32
tensor is 64.5 MB.

Not ported yet, and raising: the OBB, segment and pose losses (ROADMAP
Queue 1 item 8.2) and the distillation losses (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from yolo_infer_tpu_torch.ops.decode import dist2bbox, make_anchors
from yolo_infer_tpu_torch.ops.iou import bbox_iou_aligned

# hyperparameters (the reference's configs/default.yaml:48-50)
DEFAULT_HYP = {
    "box": 7.5,
    "cls": 0.5,
    "dfl": 1.5,
    "tal_topk": 10,
    "tal_alpha": 0.5,
    "tal_beta": 6.0,
}
EPS = 1e-9


def _gather_gt(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, M, *F) at idx (B, A) -> (B, A, *F)."""
    tail = t.shape[2:]
    ix = idx.reshape(*idx.shape, *([1] * len(tail))).expand(*idx.shape, *tail)
    return torch.gather(t, 1, ix)


def _assign_from_align(
    align: torch.Tensor,  # (B, M, A) alignment metric cls^alpha * ovl^beta
    overlaps: torch.Tensor,  # (B, M, A) gt-vs-pred overlap
    gate: torch.Tensor,  # (B, M, A) bool: anchor inside gt AND gt valid
    gt_labels: torch.Tensor,  # (B, M) int
    gt_boxes: torch.Tensor,  # (B, M, F) target geometry
    nc: int,
    topk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k gating, multi-gt conflict resolution, target gathers and
    soft-score normalization. Returns (target_boxes (B, A, F), target_scores
    (B, A, nc), fg_mask (B, A), target_gt_idx (B, A))."""
    m, a = align.shape[1], align.shape[2]
    cand = torch.where(gate, align, -1.0)
    # only the k-th best value per gt matters: ties at it are all taken either way
    kth = torch.topk(cand, min(topk, a), dim=-1).values[..., -1:]
    mask_pos = (cand >= kth.clamp(min=0.0)) & (cand > 0) & gate

    # an anchor claimed by several gts keeps the one of largest overlap
    # (argmax takes the first maximum in both libraries)
    multi = mask_pos.sum(1, keepdim=True) > 1  # (B, 1, A)
    max_overlap_gt = torch.argmax(torch.where(mask_pos, overlaps, -1.0), dim=1)  # (B, A)
    is_max = torch.arange(m, device=align.device)[None, :, None] == max_overlap_gt[:, None, :]
    mask_pos = torch.where(multi, mask_pos & is_max, mask_pos)
    fg_mask = mask_pos.any(1)  # (B, A)
    target_gt_idx = torch.argmax(mask_pos.to(torch.uint8), dim=1)  # (B, A)

    # background anchors read zeros, as the JAX package's one-hot contraction gives them
    tgt_labels = torch.where(fg_mask, _gather_gt(gt_labels.clamp(min=0), target_gt_idx), 0)
    tgt_boxes = torch.where(fg_mask[..., None], _gather_gt(gt_boxes, target_gt_idx), 0.0)
    tgt_scores = F.one_hot(tgt_labels.long(), nc).float() * fg_mask[..., None]

    # soft targets: normalised by each gt's best alignment
    align_pos = torch.where(mask_pos, align, 0.0)
    ovl_pos = torch.where(mask_pos, overlaps, 0.0)
    per_gt_max_align = align_pos.amax(-1, keepdim=True)  # (B, M, 1)
    per_gt_max_ovl = ovl_pos.amax(-1, keepdim=True)
    norm = (align_pos * per_gt_max_ovl / (per_gt_max_align + EPS)).amax(1)  # (B, A)
    return tgt_boxes, tgt_scores * norm[..., None], fg_mask, target_gt_idx


@torch.no_grad()
def task_aligned_assigner(
    pd_scores: torch.Tensor,  # (B, A, nc) sigmoided
    pd_bboxes: torch.Tensor,  # (B, A, 4) xyxy pixels
    anc_points: torch.Tensor,  # (A, 2) pixels
    gt_labels: torch.Tensor,  # (B, M) int
    gt_bboxes: torch.Tensor,  # (B, M, 4) xyxy pixels
    mask_gt: torch.Tensor,  # (B, M) bool
    *,
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (target_bboxes (B, A, 4), target_scores (B, A, nc), fg_mask
    (B, A), target_gt_idx (B, A))."""
    nc = pd_scores.shape[-1]
    lt = anc_points[None, None] - gt_bboxes[:, :, None, :2]
    rb = gt_bboxes[:, :, None, 2:] - anc_points[None, None]
    mask_in_gts = torch.minimum(lt.amin(-1), rb.amin(-1)) > EPS  # (B, M, A)
    b, mm = gt_labels.shape
    cls_idx = gt_labels.clamp(min=0).long()[:, :, None].expand(b, mm, pd_scores.shape[1])
    cls_scores = torch.gather(pd_scores.transpose(1, 2), 1, cls_idx)  # (B, M, A)
    overlaps = bbox_iou_aligned(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], kind="ciou").clamp(min=0)
    align = cls_scores.pow(alpha) * overlaps.pow(beta)
    gate = mask_in_gts & mask_gt[:, :, None]
    return _assign_from_align(align, overlaps, gate, gt_labels, gt_bboxes, nc, topk)


def _dfl_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution focal loss per element: pred_dist (..., 4, reg_max),
    target ltrb (..., 4) in grid units, already clamped to [0, reg_max-1).
    The two bins' log-probabilities are gathered: the same sum as the JAX
    package's interpolation-weight form, whose other terms are zero."""
    tl = torch.floor(target)
    wr = target - tl
    wl = 1.0 - wr
    tr = torch.clamp(tl + 1.0, max=reg_max - 1)
    logp = torch.log_softmax(pred_dist, dim=-1)
    lp_l = torch.gather(logp, -1, tl.long()[..., None])[..., 0]
    lp_r = torch.gather(logp, -1, tr.long()[..., None])[..., 0]
    return (-(lp_l * wl + lp_r * wr)).mean(-1)  # mean over 4 sides


def detection_loss(
    feats: List[torch.Tensor],  # per-level (B, H, W, 4*reg_max+nc) raw head maps
    batch: Dict[str, torch.Tensor],  # boxes (B,M,4) xyxy px, classes (B,M), mask (B,M)
    *,
    nc: int,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
    hyp: Dict[str, float] = DEFAULT_HYP,
    return_aux: bool = False,
):
    """Total detection loss (a 0-d tensor) and per-component metrics (and the
    assigner's outputs with `return_aux`)."""
    b = feats[0].shape[0]
    device = feats[0].device
    anchor_points, strd = make_anchors([(f.shape[1], f.shape[2]) for f in feats], strides, device=device)
    flat = torch.cat([f.reshape(b, -1, f.shape[-1]) for f in feats], dim=1).float()
    cls_logits = flat[..., 4 * reg_max:]
    a = flat.shape[1]

    dist = flat[..., : 4 * reg_max].reshape(b, a, 4, reg_max)
    bins = torch.arange(reg_max, dtype=torch.float32, device=device)
    ltrb = (torch.softmax(dist, dim=-1) * bins).sum(-1)  # elementwise: no TF32 matmul
    pred_boxes_grid = dist2bbox(ltrb, anchor_points[None])  # (B, A, 4) grid units

    tgt_bboxes_px, tgt_scores, fg_mask, tgt_idx = task_aligned_assigner(
        torch.sigmoid(cls_logits.detach()),
        pred_boxes_grid.detach() * strd[None],
        anchor_points * strd,
        batch["classes"].long(),
        batch["boxes"].float(),
        batch["mask"].bool(),
        topk=int(hyp.get("tal_topk", 10)),
        alpha=float(hyp.get("tal_alpha", 0.5)),
        beta=float(hyp.get("tal_beta", 6.0)),
    )
    tgt_scores_sum = torch.clamp(tgt_scores.sum(), min=1.0)

    loss_cls = optax_sigmoid_bce(cls_logits, tgt_scores).sum() / tgt_scores_sum

    weight = tgt_scores.sum(-1) * fg_mask  # (B, A)
    tgt_boxes_grid = tgt_bboxes_px / strd[None]
    iou = bbox_iou_aligned(pred_boxes_grid, tgt_boxes_grid, kind="ciou")
    loss_box = ((1.0 - iou) * weight).sum() / tgt_scores_sum

    tgt_ltrb = torch.cat([anchor_points[None] - tgt_boxes_grid[..., :2], tgt_boxes_grid[..., 2:] - anchor_points[None]],
                         dim=-1).clamp(0, reg_max - 1 - 0.01)
    loss_dfl = (_dfl_loss(dist, tgt_ltrb, reg_max) * weight).sum() / tgt_scores_sum

    total = (hyp["box"] * loss_box + hyp["cls"] * loss_cls + hyp["dfl"] * loss_dfl) * b
    metrics = {
        "loss": total,
        "loss_box": loss_box,
        "loss_cls": loss_cls,
        "loss_dfl": loss_dfl,
        "num_fg": fg_mask.sum().to(torch.int32),
    }
    if return_aux:
        aux = {
            "fg_mask": fg_mask,
            "target_gt_idx": tgt_idx,
            "weight": weight,
            "tgt_scores_sum": tgt_scores_sum,
            "tgt_bboxes_px": tgt_bboxes_px,
            "anchor_points": anchor_points,
            "strd": strd,
        }
        return total, metrics, aux
    return total, metrics


def obb_loss(*args, **kw):
    raise NotImplementedError("the OBB loss is not ported yet (ROADMAP Queue 1 item 8.2)")


def segmentation_loss(*args, **kw):
    raise NotImplementedError("the segmentation loss is not ported yet (ROADMAP Queue 1 item 8.2)")


def pose_loss(*args, **kw):
    raise NotImplementedError("the pose loss is not ported yet (ROADMAP Queue 1 item 8.2)")


def optax_sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE (no reduction), optax's form."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax cross-entropy of the classify task, and its top-1 accuracy."""
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, -1, labels.long()[:, None])[:, 0].mean()
    acc = (torch.argmax(logits, -1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def distill_classify_loss(*args, **kw):
    raise NotImplementedError("the distillation losses are not ported yet (ROADMAP Queue 1 item 7)")


def distill_detect_loss(*args, **kw):
    raise NotImplementedError("the distillation losses are not ported yet (ROADMAP Queue 1 item 7)")
