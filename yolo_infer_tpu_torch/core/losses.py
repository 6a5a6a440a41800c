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

The task losses (`obb_loss`, `segmentation_loss`, `pose_loss`) and the
distillation losses (`distill_classify_loss`, `_binary_kl_from_logits`,
`distill_detect_loss`) follow the JAX package term for term. The OBB
assigner's (B, M, A) probIoU broadcasts (B, M, 1) gt terms against (B, 1, A)
prediction terms: no (B, M, A, 5) copy of either. The segment loss takes its
`mask_fg_cap` anchors by a stable sort (value, then lower index: the order
`lax.top_k` gives ties on the CPU), and crops the (B, F, Hm, Wm) mask logits
to their boxes by a product with the in-box indicator, not a gather.

In a meshed training step (`parallel/mesh.py data_parallel`) each rank
computes the losses of its slice of the batch, with every normalizer and the
batch factor of the global batch, as GSPMD computes them over a sharded
batch: the target-score sums (clamped to >= 1 after the sum), the segment
and pose denominators, the batch size and the classify and distillation
means (`data_sum`, `global_batch`, `_global_mean`). The normalizers are
detached sums (the JAX package's are constants of the backward too), so the
ranks' losses and gradients sum to the JAX package's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from yolo_infer_tpu_torch.ops.decode import dist2bbox, make_anchors
from yolo_infer_tpu_torch.ops.iou import bbox_iou_aligned
from yolo_infer_tpu_torch.ops.nms import _topk_stable
from yolo_infer_tpu_torch.ops.rotated import dist2rbox, probiou_pairs
from yolo_infer_tpu_torch.parallel.mesh import current_mesh, data_sum, global_batch

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
    tgt_scores_sum = torch.clamp(data_sum(tgt_scores.sum()), min=1.0)

    loss_cls = optax_sigmoid_bce(cls_logits, tgt_scores).sum() / tgt_scores_sum

    weight = tgt_scores.sum(-1) * fg_mask  # (B, A)
    tgt_boxes_grid = tgt_bboxes_px / strd[None]
    iou = bbox_iou_aligned(pred_boxes_grid, tgt_boxes_grid, kind="ciou")
    loss_box = ((1.0 - iou) * weight).sum() / tgt_scores_sum

    tgt_ltrb = torch.cat([anchor_points[None] - tgt_boxes_grid[..., :2], tgt_boxes_grid[..., 2:] - anchor_points[None]],
                         dim=-1).clamp(0, reg_max - 1 - 0.01)
    loss_dfl = (_dfl_loss(dist, tgt_ltrb, reg_max) * weight).sum() / tgt_scores_sum

    total = (hyp["box"] * loss_box + hyp["cls"] * loss_cls + hyp["dfl"] * loss_dfl) * global_batch(b)
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


def _flat_levels(maps: List[torch.Tensor]) -> torch.Tensor:
    """Per-level (B, Hi, Wi, C) maps -> (B, A, C) f32."""
    return torch.cat([m.reshape(m.shape[0], -1, m.shape[-1]) for m in maps], dim=1).float()


def _dist_ltrb(flat: torch.Tensor, reg_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DFL logits (B, A, 4, reg_max) of a flat head map and their expected
    distances (B, A, 4)."""
    b, a = flat.shape[:2]
    dist = flat[..., : 4 * reg_max].reshape(b, a, 4, reg_max)
    bins = torch.arange(reg_max, dtype=torch.float32, device=flat.device)
    return dist, (torch.softmax(dist, dim=-1) * bins).sum(-1)


def obb_loss(
    out: Dict[str, List[torch.Tensor]],  # {"feats", "angle"}
    batch: Dict[str, torch.Tensor],  # boxes (B, M, 5) cx, cy, w, h, rad px | classes | mask
    *,
    nc: int,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
    hyp: Dict[str, float] = DEFAULT_HYP,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Oriented-box loss: TAL assignment under probIoU, probIoU box loss,
    DFL on rotated-frame distances, BCE cls."""
    feats = out["feats"]
    b = feats[0].shape[0]
    device = feats[0].device
    anchor_points, strd = make_anchors([(f.shape[1], f.shape[2]) for f in feats], strides, device=device)
    flat = _flat_levels(feats)
    cls_logits = flat[..., 4 * reg_max:]
    angle = (torch.sigmoid(_flat_levels(out["angle"])[..., 0]) - 0.25) * math.pi  # (B, A)
    dist, ltrb = _dist_ltrb(flat, reg_max)
    rb_grid = dist2rbox(ltrb, angle, anchor_points[None])  # (B, A, 4) grid units
    pred_rbox_px = torch.cat([rb_grid * strd[None], angle[..., None]], dim=-1)  # (B, A, 5)

    gt = batch["boxes"].float()  # (B, M, 5)
    gt_cls = batch["classes"].long()
    mask_gt = batch["mask"].bool()
    with torch.no_grad():  # the detached assigner
        pd_scores = torch.sigmoid(cls_logits)
        anc_px = anchor_points * strd  # (A, 2)
        # anchors inside the rotated gt: the anchor rotated into the gt's frame
        dx = anc_px[None, None, :, 0] - gt[:, :, None, 0]  # (B, M, A)
        dy = anc_px[None, None, :, 1] - gt[:, :, None, 1]
        cos = torch.cos(gt[:, :, None, 4])
        sin = torch.sin(gt[:, :, None, 4])
        lx = dx * cos + dy * sin
        ly = -dx * sin + dy * cos
        mask_in = (lx.abs() < gt[:, :, None, 2] / 2) & (ly.abs() < gt[:, :, None, 3] / 2)
        overlaps = probiou_pairs(gt[:, :, None, :], pred_rbox_px[:, None, :, :]).clamp(min=0)  # (B, M, A)
        idx = gt_cls.clamp(min=0)[:, :, None].expand(-1, -1, pd_scores.shape[1])
        cls_scores = torch.gather(pd_scores.transpose(1, 2), 1, idx)
        align = cls_scores.pow(hyp.get("tal_alpha", 0.5)) * overlaps.pow(hyp.get("tal_beta", 6.0))
        # background anchors read zero rboxes: probIoU's determinant clamps keep
        # those backward-finite, and the box loss weight is 0 there
        tgt_rbox, tgt_scores, fg, _ = _assign_from_align(align, overlaps, mask_in & mask_gt[:, :, None], gt_cls, gt,
                                                         nc, int(hyp.get("tal_topk", 10)))
    tss = torch.clamp(data_sum(tgt_scores.sum()), min=1.0)

    loss_cls = optax_sigmoid_bce(cls_logits, tgt_scores).sum() / tss
    weight = tgt_scores.sum(-1) * fg
    loss_box = ((1.0 - probiou_pairs(pred_rbox_px, tgt_rbox)) * weight).sum() / tss

    # DFL target: anchor-to-edge distances in the gt's rotated frame
    tgt_grid = torch.cat([tgt_rbox[..., :4] / strd[None], tgt_rbox[..., 4:]], dim=-1)
    dxa = anchor_points[None, :, 0] - tgt_grid[..., 0]
    dya = anchor_points[None, :, 1] - tgt_grid[..., 1]
    cos_a = torch.cos(tgt_rbox[..., 4])
    sin_a = torch.sin(tgt_rbox[..., 4])
    lxa = dxa * cos_a + dya * sin_a
    lya = -dxa * sin_a + dya * cos_a
    half_w = tgt_grid[..., 2] / 2
    half_h = tgt_grid[..., 3] / 2
    tgt_ltrb = torch.stack([half_w + lxa, half_h + lya, half_w - lxa, half_h - lya], dim=-1).clamp(0, reg_max - 1 - 0.01)
    loss_dfl = (_dfl_loss(dist, tgt_ltrb, reg_max) * weight).sum() / tss

    total = (hyp["box"] * loss_box + hyp["cls"] * loss_cls + hyp["dfl"] * loss_dfl) * global_batch(b)
    return total, {
        "loss": total,
        "loss_box": loss_box,
        "loss_cls": loss_cls,
        "loss_dfl": loss_dfl,
        "num_fg": fg.sum().to(torch.int32),
    }


# COCO-17 keypoint sigmas (the OKS constants)
KPT_SIGMAS = (0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
              0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089)


def segmentation_loss(
    out: Dict[str, List[torch.Tensor]],  # {"feats", "mc", "proto"}
    batch: Dict[str, torch.Tensor],  # + masks (B, Hm, Wm) int32 instance ids
    *,
    nc: int,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
    hyp: Dict[str, float] = DEFAULT_HYP,
    mask_fg_cap: int = 160,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Detection losses + per-instance mask BCE (the overlap-mask form).

    Per image the `mask_fg_cap` anchors of largest weight (ties: lower index
    first) give a mask loss: sigmoid(proto @ coefs) against (mask ==
    instance id), cropped to the target box on the stride-4 grid and
    normalised by the box's area there."""
    det_total, metrics, aux = detection_loss(out["feats"], batch, nc=nc, reg_max=reg_max, strides=strides, hyp=hyp,
                                             return_aux=True)
    proto = out["proto"].float()  # (B, Hm, Wm, nm)
    _, hm, wm, _ = proto.shape
    mc = _flat_levels(out["mc"])  # (B, A, nm)
    f = min(mask_fg_cap, mc.shape[1])

    top_w, top_idx = _topk_stable(aux["weight"], f)  # (B, F)
    coefs = torch.gather(mc, 1, top_idx[..., None].expand(-1, -1, mc.shape[-1]))  # (B, F, nm)
    pred = torch.einsum("bhwn,bfn->bfhw", proto, coefs)  # (B, F, Hm, Wm) logits
    gid = torch.gather(aux["target_gt_idx"], 1, top_idx) + 1  # (B, F)
    gt = (batch["masks"][:, None, :, :] == gid[:, :, None, None]).float()

    # crop to the target box (letterbox px -> the stride-4 mask grid)
    tb_m = torch.gather(aux["tgt_bboxes_px"], 1, top_idx[..., None].expand(-1, -1, 4)) / 4.0  # (B, F, 4)
    ys = torch.arange(hm, dtype=torch.float32, device=proto.device)[None, None, :, None]
    xs = torch.arange(wm, dtype=torch.float32, device=proto.device)[None, None, None, :]
    in_box = ((xs >= tb_m[..., 0, None, None]) & (xs < tb_m[..., 2, None, None])
              & (ys >= tb_m[..., 1, None, None]) & (ys < tb_m[..., 3, None, None])).float()

    bce = optax_sigmoid_bce(pred, gt) * in_box  # (B, F, Hm, Wm)
    area = torch.clamp((tb_m[..., 2] - tb_m[..., 0]) * (tb_m[..., 3] - tb_m[..., 1]), min=1.0)
    per_anchor = bce.sum((2, 3)) / area  # (B, F)
    valid = (top_w > 0).float()
    loss_mask = (per_anchor * valid).sum() / torch.clamp(data_sum(valid.sum()), min=1.0)

    total = det_total + hyp["box"] * loss_mask * global_batch(out["feats"][0].shape[0])
    metrics = dict(metrics)
    metrics["loss_mask"] = loss_mask
    metrics["loss"] = total
    return total, metrics


def pose_loss(
    out: Dict[str, List[torch.Tensor]],  # {"feats", "kpts"}
    batch: Dict[str, torch.Tensor],  # + kpts (B, M, K, 3) letterboxed px
    *,
    nc: int,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
    hyp: Dict[str, float] = DEFAULT_HYP,
    pose_weight: float = 12.0,
    kobj_weight: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Detection losses + the OKS-style keypoint location loss + visibility BCE."""
    det_total, metrics, aux = detection_loss(out["feats"], batch, nc=nc, reg_max=reg_max, strides=strides, hyp=hyp,
                                             return_aux=True)
    b_sz = out["feats"][0].shape[0]
    kraw = _flat_levels(out["kpts"])  # (B, A, K*3)
    a = kraw.shape[1]
    k = batch["kpts"].shape[2]
    kraw = kraw.reshape(b_sz, a, k, 3)
    ap, strd = aux["anchor_points"], aux["strd"]  # grid units, (A, 1)
    pred_xy = (kraw[..., :2] * 2.0 + (ap[None, :, None, :] - 0.5)) * strd[None, :, None, :]
    pred_conf = kraw[..., 2]

    kp = batch["kpts"].float()
    tgt = torch.gather(kp, 1, aux["target_gt_idx"][:, :, None, None].expand(-1, -1, k, 3))  # (B, A, K, 3)
    vis = (tgt[..., 2] > 0).float()  # (B, A, K)
    fg = aux["fg_mask"].float()[:, :, None]

    tb = aux["tgt_bboxes_px"]
    area = torch.clamp((tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1]), min=1.0)[:, :, None]  # (B, A, 1)
    d2 = ((pred_xy - tgt[..., :2]) ** 2).sum(-1)  # (B, A, K)
    sig = torch.tensor(KPT_SIGMAS[:k], dtype=torch.float32, device=kraw.device)[None, None, :]
    e = d2 / (8.0 * (sig ** 2) * area + 1e-9)
    w = vis * fg
    loss_kpt = ((1.0 - torch.exp(-e)) * w).sum() / torch.clamp(data_sum(w.sum()), min=1.0)
    loss_kobj = (optax_sigmoid_bce(pred_conf, vis) * fg).sum() / torch.clamp(data_sum(fg.sum()) * k, min=1.0)

    total = det_total + (pose_weight * loss_kpt + kobj_weight * loss_kobj) * global_batch(b_sz)
    metrics = dict(metrics)
    metrics["loss_kpt"] = loss_kpt
    metrics["loss_kobj"] = loss_kobj
    metrics["loss"] = total
    return total, metrics


def _global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the global batch: in a meshed step this rank's
    sum over the global element count, so that the ranks' values sum to it."""
    mesh = current_mesh()
    return x.mean() if mesh is None else x.sum() / (x.numel() * mesh.shape["data"])


def optax_sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE (no reduction), optax's form."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax cross-entropy of the classify task, and its top-1 accuracy."""
    logp = torch.log_softmax(logits, dim=-1)
    loss = -_global_mean(torch.gather(logp, -1, labels.long()[:, None])[:, 0])
    acc = _global_mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"loss": loss, "accuracy": acc}


# ------------------------------------------------------------- distillation
# soft (teacher -> student) losses of `optimization/distillation.py`; the
# reference declares alpha 0.7 and temperature 4.0 (reference
# optimization/base.py:290-314)


def distill_classify_loss(s_logits: torch.Tensor, t_logits: torch.Tensor, temperature: float = 4.0) -> torch.Tensor:
    """Hinton KD: T^2 * KL(softmax(t/T) || softmax(s/T)), mean over the batch."""
    t = torch.softmax(t_logits / temperature, dim=-1)
    logp_t = torch.log_softmax(t_logits / temperature, dim=-1)
    logp_s = torch.log_softmax(s_logits / temperature, dim=-1)
    return temperature ** 2 * _global_mean((t * (logp_t - logp_s)).sum(-1))


def _binary_kl_from_logits(t_logits: torch.Tensor, s_logits: torch.Tensor) -> torch.Tensor:
    """KL(sigmoid(t) || sigmoid(s)) per element, by the BCE identity
    KL(p || q) = H(p, q) - H(p) with H(p, sigmoid(l)) = BCE(l, p)."""
    p = torch.sigmoid(t_logits)
    return optax_sigmoid_bce(s_logits, p) - optax_sigmoid_bce(t_logits, p)


def distill_detect_loss(
    s_feats: List[torch.Tensor],
    t_feats: List[torch.Tensor],
    *,
    nc: int,
    reg_max: int = 16,
    temperature: float = 4.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Soft KD loss between the student's and the teacher's raw detect-head
    maps, which align per anchor at every YOLO11 size:

      cls  the temperature-scaled binary KL between per-class sigmoids over
           every anchor;
      box  the KL between the DFL bin distributions, weighted by the
           teacher's per-anchor confidence (its largest class sigmoid).

    Both carry the T^2 gradient rescale."""
    s_flat, t_flat = _flat_levels(s_feats), _flat_levels(t_feats)
    b = s_flat.shape[0]
    s_cls, t_cls = s_flat[..., 4 * reg_max:], t_flat[..., 4 * reg_max:]
    s_box = s_flat[..., : 4 * reg_max].reshape(b, -1, 4, reg_max)
    t_box = t_flat[..., : 4 * reg_max].reshape(b, -1, 4, reg_max)

    kd_cls = temperature ** 2 * _global_mean(_binary_kl_from_logits(t_cls / temperature, s_cls / temperature).sum(-1))

    w = torch.sigmoid(t_cls).amax(-1)  # (B, A): the teacher's objectness proxy
    w = w / torch.clamp(data_sum(w.sum()), min=1e-6)
    p_t = torch.softmax(t_box / temperature, dim=-1)
    logp_t = torch.log_softmax(t_box / temperature, dim=-1)
    logp_s = torch.log_softmax(s_box / temperature, dim=-1)
    kl_box = (p_t * (logp_t - logp_s)).sum(-1).mean(-1)  # (B, A)
    kd_box = temperature ** 2 * (kl_box * w).sum()
    return kd_cls + kd_box, {"kd_cls": kd_cls, "kd_box": kd_box}
