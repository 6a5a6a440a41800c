"""Training augmentation: mosaic, random affine, HSV, flip, mixup, for every
task (detect, segment, pose, obb), with exact label transforms.

Port of `yolo_infer_tpu/data/augment.py`, whole, without OpenCV: the HSV
conversions, `getRotationMatrix2D` and `warpAffine` are the numpy copies in
`data/cv_ops.py`, `LUT` is numpy indexing, and the mosaic tiles' resize is
`resize_linear_u8` (`ops/letterbox.py`), each bit-equal to OpenCV 5.0.
Host-side work, overlapped with the device steps by the loader
(`data/train_loader.py`); the device only ever sees fixed-shape batches.

Labels travel as a dict of pixel-space arrays on the CURRENT canvas:
  boxes (n, 4) xyxy | classes (n,)
  polygons: list of (k_i, 2) instance polygons        (segment)
  keypoints (n, K, 3) with visibility                 (pose)
  rboxes (n, 5) cx, cy, w, h, angle[rad]              (obb)
Geometric transforms are exact: polygons and keypoints are point-mapped
through the affine; rotated boxes go corners -> affine -> minimum-area
rectangle refit (`data/dataset.py corners_to_rbox`); detect boxes are
corner-refit AABBs; segment boxes are recomputed from the transformed polygon
extents.

The random draws of a sample depend only on the configuration and on earlier
draws, never on pixels or labels; the loader relies on that to build a
batch's samples in parallel (`data/train_loader.py`).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Tuple

import numpy as np

from yolo_infer_tpu_torch.data.cv_ops import (
    hsv2rgb_u8,
    rgb2hsv_u8,
    rotation_matrix_2d,
    warp_affine_linear_u8,
)
from yolo_infer_tpu_torch.data.dataset import corners_to_rbox
from yolo_infer_tpu_torch.ops.letterbox import letterbox, resize_linear_u8

Labels = Dict[str, Any]

DEFAULT_AUG = {
    "hsv_h": 0.015,
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "translate": 0.1,
    "scale": 0.5,
    "shear": 0.0,
    "fliplr": 0.5,
    "flipud": 0.0,
    "mosaic": 1.0,
    "mixup": 0.0,
    "close_mosaic": 10,
}


def hsv_augment(img: np.ndarray, rng: random.Random, h: float, s: float, v: float) -> np.ndarray:
    if h == 0 and s == 0 and v == 0:
        return img
    gains = np.array([rng.uniform(-1, 1) * h + 1, rng.uniform(-1, 1) * s + 1, rng.uniform(-1, 1) * v + 1])
    hsv = rgb2hsv_u8(img)
    lut_hue = ((np.arange(256) * gains[0]) % 180).astype(np.uint8)
    lut_sat = np.clip(np.arange(256) * gains[1], 0, 255).astype(np.uint8)
    lut_val = np.clip(np.arange(256) * gains[2], 0, 255).astype(np.uint8)
    hsv = np.stack([lut_hue[hsv[..., 0]], lut_sat[hsv[..., 1]], lut_val[hsv[..., 2]]], -1)  # cv2.LUT
    return hsv2rgb_u8(hsv)


def random_affine(
    img: np.ndarray,
    boxes: np.ndarray,
    classes: np.ndarray,
    rng: random.Random,
    *,
    imgsz: int,
    degrees: float = 0.0,
    translate: float = 0.1,
    scale: float = 0.5,
    shear: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random scale/rotate/translate to an (imgsz, imgsz) canvas; boxes follow."""
    h, w = img.shape[:2]
    # center to origin
    C = np.eye(3)
    C[0, 2] = -w / 2
    C[1, 2] = -h / 2
    # rotation + scale
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R = np.eye(3)
    R[:2] = rotation_matrix_2d((0, 0), a, s)
    # shear
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    # translate to canvas center +/- jitter
    T = np.eye(3)
    T[0, 2] = imgsz / 2 + rng.uniform(0.5 - translate, 0.5 + translate) * imgsz - imgsz / 2
    T[1, 2] = imgsz / 2 + rng.uniform(0.5 - translate, 0.5 + translate) * imgsz - imgsz / 2
    M = T @ S @ R @ C
    out = warp_affine_linear_u8(img, M[:2], (imgsz, imgsz))

    if len(boxes):
        n = len(boxes)
        corners = np.ones((n * 4, 3))
        corners[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        corners = corners @ M.T
        corners = corners[:, :2].reshape(n, 8)
        xs = corners[:, [0, 2, 4, 6]]
        ys = corners[:, [1, 3, 5, 7]]
        new = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, imgsz)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, imgsz)
        # drop degenerate boxes
        wh = new[:, 2:] - new[:, :2]
        keep = (wh > 2).all(axis=1)
        boxes, classes = new[keep].astype(np.float32), classes[keep]
    return out, boxes, classes


def mosaic4(
    records: List[Dict[str, np.ndarray]],
    rng: random.Random,
    imgsz: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Classic 4-image mosaic on a 2x2 canvas of 2*imgsz, centered randomly."""
    s = imgsz
    yc = int(rng.uniform(s * 0.5, s * 1.5))
    xc = int(rng.uniform(s * 0.5, s * 1.5))
    canvas = np.full((2 * s, 2 * s, 3), 114, np.uint8)
    all_boxes, all_cls = [], []
    for i, r in enumerate(records[:4]):
        img = r["image"]
        h, w = img.shape[:2]
        scale = min(s / h, s / w)
        nh, nw = int(h * scale), int(w * scale)
        img = resize_linear_u8(img, nw, nh)
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(xc - nw, 0), max(yc - nh, 0), xc, yc
            x1b, y1b = nw - (x2a - x1a), nh - (y2a - y1a)
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - nh, 0), min(xc + nw, 2 * s), yc
            x1b, y1b = 0, nh - (y2a - y1a)
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - nw, 0), yc, xc, min(yc + nh, 2 * s)
            x1b, y1b = nw - (x2a - x1a), 0
        else:  # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + nw, 2 * s), min(yc + nh, 2 * s)
            x1b, y1b = 0, 0
        canvas[y1a:y2a, x1a:x2a] = img[y1b : y1b + (y2a - y1a), x1b : x1b + (x2a - x1a)]
        if len(r["boxes"]):
            b = r["boxes"] * scale
            b[:, [0, 2]] += x1a - x1b
            b[:, [1, 3]] += y1a - y1b
            all_boxes.append(b)
            all_cls.append(r["classes"])
    boxes = np.concatenate(all_boxes, 0).astype(np.float32) if all_boxes else np.zeros((0, 4), np.float32)
    cls = np.concatenate(all_cls, 0) if all_cls else np.zeros((0,), np.int32)
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * s)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * s)
    return canvas, boxes, cls


# ---------------------------------------------------------------------------
# Task-label machinery (exact geometric transforms for every label type)
# ---------------------------------------------------------------------------

# COCO-17 left/right keypoint swap for horizontal flips
COCO_FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


def record_to_labels(r: Dict[str, Any], task: str) -> Labels:
    """Dataset record -> pixel-space label dict on the record's image."""
    h, w = r["image"].shape[:2]
    lab: Labels = {
        "boxes": r["boxes"].copy() if len(r.get("boxes", ())) else np.zeros((0, 4), np.float32),
        "classes": r["classes"].astype(np.int32).copy() if len(r.get("classes", ())) else np.zeros((0,), np.int32),
    }
    if task == "segment":
        polys = r.get("polygons", [])
        # dataset polygons are normalized to the original image -> pixels
        lab["polygons"] = [p * np.array([w, h], np.float32) for p in polys]
    elif task == "pose":
        kp = r.get("keypoints", np.zeros((0, 17, 3), np.float32))
        lab["keypoints"] = kp.copy().astype(np.float32)
    elif task == "obb":
        lab["rboxes"] = r.get("rboxes", np.zeros((0, 5), np.float32)).copy().astype(np.float32)
    return lab


def _filter_labels(lab: Labels, keep: np.ndarray) -> Labels:
    out: Labels = {"boxes": lab["boxes"][keep], "classes": lab["classes"][keep]}
    if "polygons" in lab:
        out["polygons"] = [p for p, k in zip(lab["polygons"], keep) if k]
    if "keypoints" in lab:
        out["keypoints"] = lab["keypoints"][keep] if len(lab["keypoints"]) else lab["keypoints"]
    if "rboxes" in lab:
        out["rboxes"] = lab["rboxes"][keep]
    return out


def scale_shift_labels(lab: Labels, scale: float, dx: float, dy: float) -> Labels:
    """Uniform scale + translation (mosaic tile placement / letterbox)."""
    out: Labels = {"classes": lab["classes"]}
    b = lab["boxes"].copy()
    if len(b):
        b *= scale
        b[:, [0, 2]] += dx
        b[:, [1, 3]] += dy
    out["boxes"] = b
    if "polygons" in lab:
        out["polygons"] = [p * scale + np.array([dx, dy], np.float32) for p in lab["polygons"]]
    if "keypoints" in lab:
        kp = lab["keypoints"].copy()
        if len(kp):
            kp[..., 0] = kp[..., 0] * scale + dx
            kp[..., 1] = kp[..., 1] * scale + dy
        out["keypoints"] = kp
    if "rboxes" in lab:
        rb = lab["rboxes"].copy()
        if len(rb):
            rb[:, 0] = rb[:, 0] * scale + dx
            rb[:, 1] = rb[:, 1] * scale + dy
            rb[:, 2:4] *= scale
        out["rboxes"] = rb
    return out


def concat_labels(labs: List[Labels]) -> Labels:
    out: Labels = {
        "boxes": np.concatenate([l["boxes"] for l in labs], 0) if labs else np.zeros((0, 4), np.float32),
        "classes": np.concatenate([l["classes"] for l in labs], 0) if labs else np.zeros((0,), np.int32),
    }
    if labs and "polygons" in labs[0]:
        out["polygons"] = [p for l in labs for p in l["polygons"]]
    if labs and "keypoints" in labs[0]:
        ks = [l["keypoints"] for l in labs if len(l["keypoints"])]
        out["keypoints"] = np.concatenate(ks, 0) if ks else labs[0]["keypoints"]
    if labs and "rboxes" in labs[0]:
        out["rboxes"] = np.concatenate([l["rboxes"] for l in labs], 0)
    return out


def _rbox_corners(rb: np.ndarray) -> np.ndarray:
    """(n, 5) -> (n, 4, 2) corner points."""
    cx, cy, w, h, a = (rb[:, i] for i in range(5))
    cos, sin = np.cos(a), np.sin(a)
    dx = np.stack([w / 2 * cos, w / 2 * sin], -1)  # half-edge along box x
    dy = np.stack([-h / 2 * sin, h / 2 * cos], -1)  # half-edge along box y
    c = np.stack([cx, cy], -1)
    return np.stack([c - dx - dy, c + dx - dy, c + dx + dy, c - dx + dy], axis=1).astype(np.float32)


def transform_labels(lab: Labels, M: np.ndarray, imgsz: int) -> Labels:
    """Apply a full 3x3 affine to every label type; clip + drop degenerates.

    Degenerate filtering uses one keep mask across all arrays so instance
    correspondence (box row i <-> polygon/kpt/rbox i) survives.
    """
    A, t = M[:2, :2], M[:2, 2]

    def pts(p):
        return p @ A.T + t

    n = len(lab["boxes"])
    if n == 0:
        return lab
    out = dict(lab)

    if "polygons" in lab:
        polys = [pts(p) for p in lab["polygons"]]
        out["polygons"] = polys
        # segment boxes are recomputed from transformed polygon extents
        boxes = np.zeros((n, 4), np.float32)
        for i, p in enumerate(polys):
            xs = p[:, 0].clip(0, imgsz)
            ys = p[:, 1].clip(0, imgsz)
            boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
        out["boxes"] = boxes
    else:
        corners = np.ones((n * 4, 3), np.float32)
        b = lab["boxes"]
        corners[:, :2] = b[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        c = (corners @ M.T)[:, :2].reshape(n, 8)
        xs, ys = c[:, [0, 2, 4, 6]], c[:, [1, 3, 5, 7]]
        boxes = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1)
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, imgsz)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, imgsz)
        out["boxes"] = boxes.astype(np.float32)

    if "keypoints" in lab and len(lab["keypoints"]):
        kp = lab["keypoints"].copy()
        xy = pts(kp[..., :2].reshape(-1, 2)).reshape(kp.shape[0], -1, 2)
        kp[..., :2] = xy
        inside = (xy[..., 0] >= 0) & (xy[..., 0] < imgsz) & (xy[..., 1] >= 0) & (xy[..., 1] < imgsz)
        kp[..., 2] = np.where(inside, kp[..., 2], 0.0)  # off-canvas -> invisible
        out["keypoints"] = kp

    if "rboxes" in lab and len(lab["rboxes"]):
        corners = _rbox_corners(lab["rboxes"])  # (n, 4, 2)
        tc = pts(corners.reshape(-1, 2)).reshape(n, 4, 2)
        out["rboxes"] = corners_to_rbox(tc)

    # visibility filter on the CLIPPED axis-aligned extents (candidates with
    # <2px visible area are dropped; partially-visible instances are kept —
    # matches ultralytics' area-based box_candidates, not a center rule)
    wh = out["boxes"][:, 2:] - out["boxes"][:, :2]
    keep = (wh > 2).all(axis=1)
    if "rboxes" in out and len(out["rboxes"]):
        keep &= (out["rboxes"][:, 2:4] > 2).all(axis=1)
    return _filter_labels(out, keep)


def flip_labels(lab: Labels, imgsz: int, *, vertical: bool = False) -> Labels:
    out = dict(lab)
    b = lab["boxes"].copy()
    if len(b):
        if vertical:
            b[:, [1, 3]] = imgsz - b[:, [3, 1]]
        else:
            b[:, [0, 2]] = imgsz - b[:, [2, 0]]
    out["boxes"] = b
    ax = 1 if vertical else 0
    if "polygons" in lab:
        flipped = []
        for p in lab["polygons"]:
            p = p.copy()
            p[:, ax] = imgsz - p[:, ax]
            flipped.append(p)
        out["polygons"] = flipped
    if "keypoints" in lab and len(lab["keypoints"]):
        kp = lab["keypoints"].copy()
        kp[..., ax] = np.where(kp[..., 2] > 0, imgsz - kp[..., ax], kp[..., ax])
        if not vertical and kp.shape[1] == len(COCO_FLIP_IDX):
            kp = kp[:, COCO_FLIP_IDX]  # left/right joints swap
        out["keypoints"] = kp
    if "rboxes" in lab and len(lab["rboxes"]):
        rb = lab["rboxes"].copy()
        rb[:, ax] = imgsz - rb[:, ax]
        rb[:, 4] = -rb[:, 4]  # mirror reflection negates the angle
        rb[:, 4] = np.where(rb[:, 4] < -np.pi / 4, rb[:, 4] + np.pi, rb[:, 4])
        out["rboxes"] = rb
    return out


def _affine_matrix(rng: random.Random, src_hw: Tuple[int, int], imgsz: int, hyp: Dict[str, float]) -> np.ndarray:
    h, w = src_hw
    C = np.eye(3)
    C[0, 2], C[1, 2] = -w / 2, -h / 2
    a = rng.uniform(-hyp["degrees"], hyp["degrees"])
    s = rng.uniform(1 - hyp["scale"], 1 + hyp["scale"])
    R = np.eye(3)
    R[:2] = rotation_matrix_2d((0, 0), a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-hyp["shear"], hyp["shear"]) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-hyp["shear"], hyp["shear"]) * math.pi / 180)
    T = np.eye(3)
    tr = hyp["translate"]
    T[0, 2] = imgsz / 2 + rng.uniform(0.5 - tr, 0.5 + tr) * imgsz - imgsz / 2
    T[1, 2] = imgsz / 2 + rng.uniform(0.5 - tr, 0.5 + tr) * imgsz - imgsz / 2
    return T @ S @ R @ C


def mosaic4_labels(
    records: List[Dict[str, Any]], rng: random.Random, imgsz: int, task: str
) -> Tuple[np.ndarray, Labels]:
    """4-image mosaic carrying full task labels (2x2 canvas of 2*imgsz)."""
    s = imgsz
    yc = int(rng.uniform(s * 0.5, s * 1.5))
    xc = int(rng.uniform(s * 0.5, s * 1.5))
    canvas = np.full((2 * s, 2 * s, 3), 114, np.uint8)
    labs: List[Labels] = []
    for i, r in enumerate(records[:4]):
        img = r["image"]
        h, w = img.shape[:2]
        scale = min(s / h, s / w)
        nh, nw = int(h * scale), int(w * scale)
        img = resize_linear_u8(img, nw, nh)
        if i == 0:
            x1a, y1a, x2a, y2a = max(xc - nw, 0), max(yc - nh, 0), xc, yc
            x1b, y1b = nw - (x2a - x1a), nh - (y2a - y1a)
        elif i == 1:
            x1a, y1a, x2a, y2a = xc, max(yc - nh, 0), min(xc + nw, 2 * s), yc
            x1b, y1b = 0, nh - (y2a - y1a)
        elif i == 2:
            x1a, y1a, x2a, y2a = max(xc - nw, 0), yc, xc, min(yc + nh, 2 * s)
            x1b, y1b = nw - (x2a - x1a), 0
        else:
            x1a, y1a, x2a, y2a = xc, yc, min(xc + nw, 2 * s), min(yc + nh, 2 * s)
            x1b, y1b = 0, 0
        canvas[y1a:y2a, x1a:x2a] = img[y1b : y1b + (y2a - y1a), x1b : x1b + (x2a - x1a)]
        labs.append(scale_shift_labels(record_to_labels(r, task), scale, x1a - x1b, y1a - y1b))
    return canvas, concat_labels(labs)


def letterbox_labels(r: Dict[str, Any], imgsz: int, task: str) -> Tuple[np.ndarray, Labels]:
    img, ratio, pad = letterbox(r["image"], imgsz)
    return img, scale_shift_labels(record_to_labels(r, task), ratio, pad[0], pad[1])


def augment_full(
    records: List[Dict[str, Any]],
    rng: random.Random,
    *,
    imgsz: int,
    hyp: Dict[str, float],
    use_mosaic: bool,
    task: str = "detect",
) -> Tuple[np.ndarray, Labels]:
    """One augmented training sample with full task labels.

    Mosaic path: mosaic4 -> random affine (exact label transforms).
    Plain path: letterbox. Both: HSV + flips.
    """
    if use_mosaic and len(records) >= 4:
        img, lab = mosaic4_labels(records, rng, imgsz, task)
        M = _affine_matrix(rng, img.shape[:2], imgsz, hyp)
        img = warp_affine_linear_u8(img, M[:2], (imgsz, imgsz))
        lab = transform_labels(lab, M, imgsz)
    else:
        img, lab = letterbox_labels(records[0], imgsz, task)
    img = hsv_augment(img, rng, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"])
    if rng.random() < hyp["fliplr"]:
        img = np.ascontiguousarray(img[:, ::-1])
        lab = flip_labels(lab, imgsz)
    if rng.random() < hyp.get("flipud", 0.0):
        img = np.ascontiguousarray(img[::-1])
        lab = flip_labels(lab, imgsz, vertical=True)
    return img, lab


def augment_sample(
    records: List[Dict[str, np.ndarray]],
    rng: random.Random,
    *,
    imgsz: int,
    hyp: Dict[str, float],
    use_mosaic: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build one augmented training sample from 1 (plain) or 4 (mosaic) records."""
    if use_mosaic and len(records) >= 4:
        img, boxes, cls = mosaic4(records, rng, imgsz)
        img, boxes, cls = random_affine(
            img, boxes, cls, rng, imgsz=imgsz,
            degrees=hyp["degrees"], translate=hyp["translate"], scale=hyp["scale"], shear=hyp["shear"],
        )
    else:
        r = records[0]
        img, ratio, pad = letterbox(r["image"], imgsz)
        boxes = r["boxes"].copy() if len(r["boxes"]) else np.zeros((0, 4), np.float32)
        if len(boxes):
            boxes = boxes * ratio
            boxes[:, [0, 2]] += pad[0]
            boxes[:, [1, 3]] += pad[1]
        cls = r["classes"]
    img = hsv_augment(img, rng, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"])
    if rng.random() < hyp["fliplr"]:
        img = np.ascontiguousarray(img[:, ::-1])
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, [0, 2]] = img.shape[1] - boxes[:, [2, 0]]
    if rng.random() < hyp.get("flipud", 0.0):
        img = np.ascontiguousarray(img[::-1])
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, [1, 3]] = img.shape[0] - boxes[:, [3, 1]]
    return img, boxes.astype(np.float32), cls.astype(np.int32)
