"""Brute-force COCO-protocol AP oracle — the independent accuracy authority.

Two deliberately slow, loop-based implementations of detection AP:

* ``protocol="coco"`` — pycocotools semantics: per (image, class), greedy
  matching of score-sorted detections to the best still-unmatched GT above the
  IoU threshold; AP is the mean of precision sampled at 101 recall points
  (step interpolation: precision at recall r is the max precision achieved at
  any recall >= r).
* ``protocol="ultralytics"`` — the exact matching order of the ultralytics
  val engine, which is the reference's accuracy authority (reference
  core/validator.py:339-361 reads box.map/map50/map75 out of it): per image,
  candidate (gt, pred) pairs across all classes at once, sorted by IoU
  descending, deduplicated per-pred then per-gt with ``np.unique`` (including
  its re-ordering side effect — after the pred dedup the pairs are in
  pred-index order, so the gt dedup is confidence-greedy, not IoU-greedy),
  then trapezoidal integration of the 101-point interpolated precision
  envelope (ultralytics ``compute_ap`` method='interp').

This module intentionally shares NO code with :mod:`yolo_infer_tpu_torch.core.metrics`
— no IoU helper, no matcher, no AP routine. It exists to catch protocol drift
there: tests/test_torch_eval.py cross-checks the port's DetMetrics against it
on randomized scenes (exact equality for the ultralytics protocol). The port
keeps its own copy of the JAX package's `core/ap_oracle.py` (it imports
nothing of that package).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

ORACLE_IOU_THRESHOLDS = [0.5 + 0.05 * i for i in range(10)]


def _iou_single(a: Sequence[float], b: Sequence[float]) -> float:
    """IoU of two xyxy boxes, scalar math only."""
    ix1 = max(a[0], b[0])
    iy1 = max(a[1], b[1])
    ix2 = min(a[2], b[2])
    iy2 = min(a[3], b[3])
    iw = max(0.0, ix2 - ix1)
    ih = max(0.0, iy2 - iy1)
    inter = iw * ih
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def _image_sim(img: Dict[str, np.ndarray]) -> np.ndarray:
    """(N_pred, M_gt) similarity matrix for one image: precomputed ``sim``
    (mask IoU, OKS, probIoU, ...) if present, else box IoU."""
    if "sim" in img:
        return np.asarray(img["sim"], np.float64)
    pb = np.asarray(img["pred_boxes"], np.float64).reshape(-1, 4)
    gb = np.asarray(img["gt_boxes"], np.float64).reshape(-1, 4)
    out = np.zeros((len(pb), len(gb)))
    for i in range(len(pb)):
        for j in range(len(gb)):
            out[i, j] = _iou_single(pb[i], gb[j])
    return out


# ---------------------------------------------------------------------------
# COCO (pycocotools) protocol
# ---------------------------------------------------------------------------


def _coco_match_image_class(
    sim: np.ndarray,  # (N_pred_c, M_gt_c) for ONE class on ONE image
    scores: np.ndarray,
    thr: float,
) -> List[bool]:
    """pycocotools evaluateImg: detections in score order each claim the
    still-unmatched GT with the highest IoU, if that IoU >= thr."""
    order = np.argsort(-scores, kind="mergesort")
    gt_taken = [False] * sim.shape[1]
    tp = [False] * sim.shape[0]
    for di in order:
        best_iou = min(thr, 1 - 1e-10)  # pycocotools: must reach the threshold
        best_gt = -1
        for gi in range(sim.shape[1]):
            if gt_taken[gi] or sim[di, gi] < best_iou:
                continue
            best_iou = sim[di, gi]
            best_gt = gi
        if best_gt >= 0:
            gt_taken[best_gt] = True
            tp[di] = True
    return tp


def _coco_ap(recall_sorted_tp: List[bool], scores: np.ndarray, npos: int) -> float:
    """pycocotools accumulate: 101-point step-sampled AP for one class/thr."""
    if npos == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    tp_sorted = [recall_sorted_tp[i] for i in order]
    tps = np.cumsum([1.0 if t else 0.0 for t in tp_sorted])
    fps = np.cumsum([0.0 if t else 1.0 for t in tp_sorted])
    rc = tps / npos
    pr = tps / np.maximum(tps + fps, np.spacing(1))
    # precision envelope, computed backwards as pycocotools does
    pr = pr.tolist()
    for i in range(len(pr) - 1, 0, -1):
        if pr[i] > pr[i - 1]:
            pr[i - 1] = pr[i]
    rec_thrs = np.linspace(0.0, 1.0, 101)
    q = np.zeros(101)
    inds = np.searchsorted(rc, rec_thrs, side="left")
    for ri, pi in enumerate(inds):
        if pi < len(pr):
            q[ri] = pr[pi]
    return float(q.mean())


def _oracle_map_coco(images: List[Dict[str, np.ndarray]], thresholds) -> Dict[str, float]:
    classes = sorted(
        {int(c) for img in images for c in np.asarray(img["gt_cls"]).reshape(-1)}
    )
    t = len(thresholds)
    ap = np.zeros((len(classes), t))
    for ci, c in enumerate(classes):
        npos = sum(int((np.asarray(img["gt_cls"]).reshape(-1) == c).sum()) for img in images)
        all_scores: List[float] = []
        per_thr_tp: List[List[bool]] = [[] for _ in range(t)]  # parallel to all_scores
        for img in images:
            p_cls = np.asarray(img["pred_cls"]).reshape(-1)
            g_cls = np.asarray(img["gt_cls"]).reshape(-1)
            p_sel = np.where(p_cls == c)[0]
            g_sel = np.where(g_cls == c)[0]
            sim = _image_sim(img)[np.ix_(p_sel, g_sel)] if len(p_sel) and len(g_sel) else np.zeros((len(p_sel), len(g_sel)))
            scores = np.asarray(img["pred_scores"]).reshape(-1)[p_sel]
            all_scores.extend(scores.tolist())
            for ti, thr in enumerate(thresholds):
                per_thr_tp[ti].extend(_coco_match_image_class(sim, scores, float(thr)))
        scores_np = np.asarray(all_scores)
        for ti in range(t):
            ap[ci, ti] = _coco_ap(per_thr_tp[ti], scores_np, npos)
    return _summarize(ap, classes, thresholds)


# ---------------------------------------------------------------------------
# ultralytics protocol
# ---------------------------------------------------------------------------


def _ultra_match_image(img: Dict[str, np.ndarray], thresholds) -> np.ndarray:
    """ultralytics ``match_predictions`` verbatim (numpy branch), including the
    np.unique re-ordering quirk. Returns (N_pred, T) bool."""
    p_cls = np.asarray(img["pred_cls"]).reshape(-1)
    g_cls = np.asarray(img["gt_cls"]).reshape(-1)
    n, m = len(p_cls), len(g_cls)
    correct = np.zeros((n, len(thresholds)), bool)
    if n == 0 or m == 0:
        return correct
    # ultralytics: iou is (L_gt, D_pred), zeroed where classes differ
    iou = _image_sim(img).T * (g_cls[:, None] == p_cls[None, :])
    for ti, threshold in enumerate(thresholds):
        matches = np.nonzero(iou >= threshold)
        matches = np.array(matches).T
        if matches.shape[0]:
            if matches.shape[0] > 1:
                matches = matches[iou[matches[:, 0], matches[:, 1]].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), ti] = True
    return correct


def _ultra_compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """ultralytics ``compute_ap`` method='interp' verbatim."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    trapz = getattr(np, "trapezoid", None) or np.trapz
    return float(trapz(np.interp(x, mrec, mpre), x))


def _oracle_map_ultralytics(images: List[Dict[str, np.ndarray]], thresholds) -> Dict[str, float]:
    tp_all, conf_all, pcls_all, gcls_all = [], [], [], []
    for img in images:
        tp_all.append(_ultra_match_image(img, thresholds))
        conf_all.append(np.asarray(img["pred_scores"]).reshape(-1))
        pcls_all.append(np.asarray(img["pred_cls"]).reshape(-1))
        gcls_all.append(np.asarray(img["gt_cls"]).reshape(-1))
    tp = np.concatenate(tp_all) if tp_all else np.zeros((0, len(thresholds)), bool)
    conf = np.concatenate(conf_all) if conf_all else np.zeros(0)
    pred_cls = np.concatenate(pcls_all) if pcls_all else np.zeros(0)
    target_cls = np.concatenate(gcls_all) if gcls_all else np.zeros(0)

    # ultralytics ap_per_class
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    ap = np.zeros((len(unique_classes), len(thresholds)))
    eps = 1e-16
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = nt[ci]
        if sel.sum() == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        for ti in range(len(thresholds)):
            ap[ci, ti] = _ultra_compute_ap(recall[:, ti], precision[:, ti])
    return _summarize(ap, [int(c) for c in unique_classes], thresholds)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def _summarize(ap: np.ndarray, classes, thresholds) -> Dict[str, float]:
    ap = np.nan_to_num(ap, nan=0.0)
    thr = list(thresholds)
    i50 = min(range(len(thr)), key=lambda i: abs(thr[i] - 0.50))
    i75 = min(range(len(thr)), key=lambda i: abs(thr[i] - 0.75))
    return {
        "map": float(ap.mean()) if ap.size else 0.0,
        "map50": float(ap[:, i50].mean()) if ap.size else 0.0,
        "map75": float(ap[:, i75].mean()) if ap.size else 0.0,
        "per_class_ap50": {int(c): float(ap[ci, i50]) for ci, c in enumerate(classes)},
    }


def oracle_map(
    images: List[Dict[str, np.ndarray]],
    protocol: str = "coco",
    iou_thresholds: Optional[Sequence[float]] = None,
) -> Dict[str, float]:
    """Compute mAP50-95 / mAP50 / mAP75 from raw per-image predictions.

    ``images``: list of dicts with keys ``pred_boxes`` (N,4 xyxy),
    ``pred_scores`` (N,), ``pred_cls`` (N,), ``gt_boxes`` (M,4),
    ``gt_cls`` (M,) — or a precomputed ``sim`` (N, M) similarity matrix in
    place of the boxes (mask IoU / OKS / probIoU mAP).
    """
    thresholds = list(iou_thresholds) if iou_thresholds is not None else ORACLE_IOU_THRESHOLDS
    if protocol == "coco":
        return _oracle_map_coco(images, thresholds)
    if protocol == "ultralytics":
        return _oracle_map_ultralytics(images, thresholds)
    raise ValueError(f"unknown protocol {protocol!r}")
