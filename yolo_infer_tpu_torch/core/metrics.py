"""Detection metrics: COCO-style mAP50-95 / mAP50 / mAP75, precision, recall.

A copy of `yolo_infer_tpu/core/metrics.py` (pure numpy), kept in the port so
that it never imports the JAX package: greedy IoU matching at 10 thresholds
in the ultralytics val engine's order, 101-point interpolated AP, OKS and
mask IoU for pose and segment. The per-image matching is host work that the
validator overlaps with the next batch on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


def box_iou_np(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU, a (N,4) x b (M,4) xyxy -> (N,M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clip(0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    return inter / (area_a + area_b - inter + eps)


def match_from_iou(iou: np.ndarray, iou_thresholds: np.ndarray = IOU_THRESHOLDS) -> np.ndarray:
    """TP matrix (N, T) from a (class-gated) pred-x-gt IoU matrix, predictions
    sorted by confidence descending.

    Reproduces the ultralytics val engine's matching order bit-for-bit (the
    reference's accuracy authority — reference core/validator.py:339-361):
    candidate pairs sorted by IoU descending, deduplicated per-pred then
    per-gt with np.unique. The np.unique re-ordering side effect is part of
    the protocol: after the pred dedup the pairs sit in pred-index order, so
    the gt dedup is confidence-greedy. The JAX package cross-checks it against
    an independent brute-force oracle (its core/ap_oracle.py)."""
    n, m = iou.shape
    t = len(iou_thresholds)
    tp = np.zeros((n, t), dtype=bool)
    if n == 0 or m == 0:
        return tp
    iou_gp = iou.T  # ultralytics operates on (gt, pred)
    for ti, thr in enumerate(iou_thresholds):
        matches = np.argwhere(iou_gp >= thr)  # (k, 2): [gt, pred]
        if matches.shape[0]:
            if matches.shape[0] > 1:
                matches = matches[iou_gp[matches[:, 0], matches[:, 1]].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            tp[matches[:, 1], ti] = True
    return tp


def match_predictions(
    pred_boxes: np.ndarray,  # (N, 4) xyxy, sorted by confidence desc
    pred_cls: np.ndarray,  # (N,)
    gt_boxes: np.ndarray,  # (M, 4)
    gt_cls: np.ndarray,  # (M,)
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
) -> np.ndarray:
    """TP matrix (N, T): pred i is a true positive at threshold t.

    Greedy: predictions in confidence order claim the best unmatched
    same-class GT with IoU >= threshold.
    """
    if len(pred_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(pred_boxes), len(iou_thresholds)), dtype=bool)
    iou = box_iou_np(pred_boxes, gt_boxes)
    iou = iou * (pred_cls[:, None] == gt_cls[None, :])
    return match_from_iou(iou, iou_thresholds)


def mask_iou_matrix(pred_masks: np.ndarray, gt_masks: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Binary mask IoU: (N, H, W) x (M, H, W) -> (N, M)."""
    if len(pred_masks) == 0 or len(gt_masks) == 0:
        return np.zeros((len(pred_masks), len(gt_masks)), np.float32)
    p = pred_masks.reshape(len(pred_masks), -1).astype(np.float32)
    g = gt_masks.reshape(len(gt_masks), -1).astype(np.float32)
    inter = p @ g.T
    union = p.sum(1)[:, None] + g.sum(1)[None, :] - inter
    return inter / (union + eps)


# COCO-17 OKS sigmas
OKS_SIGMAS = np.array(
    [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
     0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089], np.float32
)


def oks_matrix(
    pred_kpts: np.ndarray,  # (N, K, >=2)
    gt_kpts: np.ndarray,  # (M, K, 3) with visibility
    gt_areas: np.ndarray,  # (M,)
    sigmas: Optional[np.ndarray] = None,
    eps: float = 1e-7,
) -> np.ndarray:
    """Object Keypoint Similarity matrix (COCO convention)."""
    n, m = len(pred_kpts), len(gt_kpts)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    k = gt_kpts.shape[1]
    if sigmas is None:
        sigmas = OKS_SIGMAS[:k] if k <= len(OKS_SIGMAS) else np.full(k, 0.05, np.float32)
    d2 = ((pred_kpts[:, None, :, :2] - gt_kpts[None, :, :, :2]) ** 2).sum(-1)  # (N, M, K)
    vis = (gt_kpts[None, :, :, 2] > 0).astype(np.float32)  # (1->N, M, K)
    s2 = (2 * sigmas[None, None, :]) ** 2
    # COCO scale convention: object scale = 0.53 * bbox area (ultralytics
    # kpt_iou applies the same factor — keeps pose mAP comparable).
    e = d2 / (s2 * (0.53 * gt_areas[None, :, None] + eps) * 2)
    oks = (np.exp(-e) * vis).sum(-1) / np.maximum(vis.sum(-1), eps)
    return oks.astype(np.float32)


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """AP via the ultralytics 'interp' method: trapezoidal integration of the
    precision envelope interpolated at 101 recall points. This is what the
    reference's val engine reports (its box.map numbers); the strict COCO
    step-sampled variant (the JAX package's core/ap_oracle.py) differs by <~0.01."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))  # precision envelope
    x = np.linspace(0, 1, 101)
    trapz = getattr(np, "trapezoid", None) or np.trapz
    return float(trapz(np.interp(x, mrec, mpre), x))


class ConfusionMatrix:
    """Detection confusion matrix with a background class (row = predicted,
    col = actual; index nc = background). Mirrors the capability surfaced by
    the reference's val_matrix recipe (reference official_scripts/
    val_matrix.py:1-6)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), dtype=np.int64)

    def process_batch(
        self,
        pred_boxes: np.ndarray,
        pred_scores: np.ndarray,
        pred_cls: np.ndarray,
        gt_boxes: np.ndarray,
        gt_cls: np.ndarray,
    ) -> None:
        keep = pred_scores >= self.conf
        pred_boxes, pred_cls = pred_boxes[keep], pred_cls[keep].astype(int)
        gt_cls = gt_cls.astype(int)
        if len(gt_boxes) == 0:
            for c in pred_cls:
                self.matrix[c, self.nc] += 1  # false positive vs background
            return
        if len(pred_boxes) == 0:
            for c in gt_cls:
                self.matrix[self.nc, c] += 1  # missed gt
            return
        iou = box_iou_np(pred_boxes, gt_boxes)
        matched_gt = np.full(len(gt_boxes), -1)
        matched_pred = np.full(len(pred_boxes), False)
        # greedy by IoU
        pairs = np.argwhere(iou >= self.iou_thres)
        if len(pairs):
            order = np.argsort(-iou[pairs[:, 0], pairs[:, 1]], kind="stable")
            for pi, gi in pairs[order]:
                if matched_gt[gi] == -1 and not matched_pred[pi]:
                    matched_gt[gi] = pi
                    matched_pred[pi] = True
                    self.matrix[pred_cls[pi], gt_cls[gi]] += 1
        for gi, c in enumerate(gt_cls):
            if matched_gt[gi] == -1:
                self.matrix[self.nc, c] += 1
        for pi, c in enumerate(pred_cls):
            if not matched_pred[pi]:
                self.matrix[c, self.nc] += 1

    def to_text(self, names: Optional[Dict[int, str]] = None) -> str:
        labels = [(names or {}).get(i, str(i)) for i in range(self.nc)] + ["bg"]
        width = max(len(l) for l in labels) + 1
        lines = [" " * width + "".join(f"{l:>{width}}" for l in labels) + "  (actual)"]
        for i, row in enumerate(self.matrix):
            lines.append(f"{labels[i]:>{width}}" + "".join(f"{v:>{width}}" for v in row))
        return "\n".join(lines)


class DetMetrics:
    """Accumulates per-image matches, computes mAP and P/R at best-F1 conf."""

    def __init__(self, nc: int, iou_thresholds: np.ndarray = IOU_THRESHOLDS):
        self.nc = nc
        self.iou_thresholds = iou_thresholds
        self._tp: List[np.ndarray] = []
        self._conf: List[np.ndarray] = []
        self._pred_cls: List[np.ndarray] = []
        self._gt_cls: List[np.ndarray] = []

    def update(
        self,
        pred_boxes: np.ndarray,
        pred_scores: np.ndarray,
        pred_cls: np.ndarray,
        gt_boxes: np.ndarray,
        gt_cls: np.ndarray,
    ) -> None:
        order = np.argsort(-pred_scores, kind="stable")
        pred_boxes, pred_scores, pred_cls = pred_boxes[order], pred_scores[order], pred_cls[order]
        tp = match_predictions(pred_boxes, pred_cls, gt_boxes, gt_cls, self.iou_thresholds)
        self._tp.append(tp)
        self._conf.append(pred_scores)
        self._pred_cls.append(pred_cls)
        self._gt_cls.append(gt_cls)

    def update_from_iou(
        self,
        iou: np.ndarray,  # (N, M) pred-x-gt similarity (mask IoU, OKS, ...)
        pred_scores: np.ndarray,
        pred_cls: np.ndarray,
        gt_cls: np.ndarray,
    ) -> None:
        """Accumulate with a caller-provided similarity matrix (predictions in
        any order; sorted here). Enables mask-mAP and OKS pose-mAP."""
        order = np.argsort(-pred_scores, kind="stable")
        iou = iou[order] if len(iou) else iou
        pred_scores, pred_cls = pred_scores[order], pred_cls[order]
        gated = iou * (pred_cls[:, None] == gt_cls[None, :]) if len(iou) and len(gt_cls) else iou
        tp = match_from_iou(gated, self.iou_thresholds) if gated.size else np.zeros((len(pred_scores), len(self.iou_thresholds)), bool)
        self._tp.append(tp)
        self._conf.append(pred_scores)
        self._pred_cls.append(pred_cls)
        self._gt_cls.append(gt_cls)

    def compute(self) -> Dict[str, float]:
        if not self._tp:
            return {"map": 0.0, "map50": 0.0, "map75": 0.0, "precision": 0.0, "recall": 0.0}
        tp = np.concatenate(self._tp)  # (N, T)
        conf = np.concatenate(self._conf)
        pred_cls = np.concatenate(self._pred_cls)
        gt_cls = np.concatenate(self._gt_cls) if self._gt_cls else np.zeros((0,))
        order = np.argsort(-conf, kind="stable")
        tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

        classes = np.unique(gt_cls).astype(int)
        t = len(self.iou_thresholds)
        ap = np.zeros((len(classes), t))
        p_curve, r_curve = [], []
        for ci, c in enumerate(classes):
            mask = pred_cls == c
            n_gt = int((gt_cls == c).sum())
            if n_gt == 0:
                continue
            if mask.sum() == 0:
                p_curve.append(np.zeros(1))
                r_curve.append(np.zeros(1))
                continue
            tpc = tp[mask].cumsum(axis=0)  # (Nc, T)
            fpc = (~tp[mask]).cumsum(axis=0)
            recall = tpc / (n_gt + 1e-16)  # ultralytics ap_per_class eps
            precision = tpc / np.maximum(tpc + fpc, 1e-9)
            for ti in range(t):
                ap[ci, ti] = compute_ap(recall[:, ti], precision[:, ti])
            p_curve.append(precision[:, 0])
            r_curve.append(recall[:, 0])

        # P/R at the confidence maximizing F1 (IoU=0.5), averaged over classes
        precision_out, recall_out = 0.0, 0.0
        if p_curve:
            ps, rs = [], []
            for pc, rc in zip(p_curve, r_curve):
                f1 = 2 * pc * rc / np.maximum(pc + rc, 1e-9)
                i = int(np.argmax(f1)) if len(f1) else 0
                ps.append(pc[i] if len(pc) else 0.0)
                rs.append(rc[i] if len(rc) else 0.0)
            precision_out = float(np.mean(ps))
            recall_out = float(np.mean(rs))

        i75 = int(np.argmin(np.abs(self.iou_thresholds - 0.75)))
        return {
            "map": float(ap.mean()) if ap.size else 0.0,
            "map50": float(ap[:, 0].mean()) if ap.size else 0.0,
            "map75": float(ap[:, i75].mean()) if ap.size else 0.0,
            "precision": precision_out,
            "recall": recall_out,
            "per_class_ap50": {int(c): float(ap[ci, 0]) for ci, c in enumerate(classes)},
        }

    def reset(self) -> None:
        self._tp, self._conf, self._pred_cls, self._gt_cls = [], [], [], []
