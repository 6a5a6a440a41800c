"""YOLO-format dataset (images/ + labels/*.txt with normalized coordinates).

Port of `yolo_infer_tpu/data/dataset.py` for every task: the dataset config
(a dict, or a YAML file read by the port's own `utils/yaml_io.py`: PyYAML
is not needed), the per-image label files (`cls cx cy w h`; segment
polygons `cls x1 y1 x2 y2 ...`; OBB corners `cls x1 y1 ... x4 y4`;
keypoint triplets for pose), and the
host-letterboxed val batches (the port's OpenCV-free `letterbox`). The JAX
package fills polygons and fits minimum-area rectangles with OpenCV; the
port takes `fill_poly`, `contour_area` and `min_area_rect` from
`data/polygon.py`, numpy copies of OpenCV's routines that give the same
masks and rotated boxes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Generator, List, Optional, Tuple, Union

import numpy as np

from yolo_infer_tpu_torch.data.loader import IMAGE_EXTS, load_image
from yolo_infer_tpu_torch.data.polygon import contour_area, fill_polys, min_area_rect
from yolo_infer_tpu_torch.ops.letterbox import letterbox
from yolo_infer_tpu_torch.utils import yaml_io

TASKS = ("detect", "segment", "pose", "obb")


def parse_dataset_config(data: Union[str, Path, Dict[str, Any]]) -> Dict[str, Any]:
    if isinstance(data, (str, Path)):
        cfg = yaml_io.load(data)
        if not isinstance(cfg, dict):
            raise ValueError(f"{data}: a dataset config must be a mapping")
        cfg["_base"] = Path(data).parent
    else:
        cfg = dict(data)
        cfg.setdefault("_base", Path("."))
    names = cfg.get("names", {})
    if isinstance(names, list):
        names = {i: n for i, n in enumerate(names)}
    cfg["names"] = {int(k): str(v) for k, v in names.items()}
    cfg["nc"] = cfg.get("nc", len(cfg["names"]) or 80)
    return cfg


def _resolve_split_dir(cfg: Dict[str, Any], split: str) -> Path:
    """A split's directory: absolute as given, else under `path` (itself
    under the config's directory when relative), else under the config's
    directory. (The JAX package joins the config's directory twice when
    `path` is missing and the config was named by a relative path.)"""
    base = Path(cfg["_base"])
    if "path" in cfg:
        base = base / cfg["path"]  # an absolute `path` replaces the base
    p = Path(cfg.get(split, split))
    return p if p.is_absolute() else base / p


def label_path_for(image_path: Path) -> Path:
    """images/.../x.jpg -> labels/.../x.txt (YOLO layout convention)."""
    parts = list(image_path.parts)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "images":
            parts[i] = "labels"
            break
    return Path(*parts).with_suffix(".txt")


def load_labels(label_path: Path, nc: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (classes (M,), xywhn (M,4)); empty arrays if no label file."""
    if not label_path.exists():
        return np.zeros((0,), np.int32), np.zeros((0, 4), np.float32)
    cls_list, box_list = [], []
    for line in label_path.read_text().splitlines():
        parts = line.split()
        if len(parts) < 5:
            continue
        c = int(float(parts[0]))
        if nc is not None and not (0 <= c < nc):
            continue
        box = [float(v) for v in parts[1:5]]
        if not all(0.0 <= v <= 1.0 for v in box):
            continue
        cls_list.append(c)
        box_list.append(box)
    if not cls_list:
        return np.zeros((0,), np.int32), np.zeros((0, 4), np.float32)
    return np.asarray(cls_list, np.int32), np.asarray(box_list, np.float32)


def load_labels_segments(label_path: Path, nc: Optional[int] = None):
    """Segment labels: `cls x1 y1 x2 y2 ...` normalized polygons.

    Returns (classes (M,), polygons: list of (P_i, 2) arrays in [0,1]).
    """
    if not label_path.exists():
        return np.zeros((0,), np.int32), []
    cls_list, polys = [], []
    for line in label_path.read_text().splitlines():
        parts = line.split()
        if len(parts) < 7 or (len(parts) - 1) % 2 != 0:  # need >=3 points
            continue
        c = int(float(parts[0]))
        if nc is not None and not (0 <= c < nc):
            continue
        coords = np.asarray([float(v) for v in parts[1:]], np.float32).reshape(-1, 2)
        if coords.min() < 0.0 or coords.max() > 1.0:
            continue
        cls_list.append(c)
        polys.append(coords)
    return np.asarray(cls_list, np.int32), polys


def load_labels_keypoints(label_path: Path, kpt_shape=(17, 3), nc: Optional[int] = None):
    """Pose labels: `cls cx cy w h x1 y1 [v1] ...` normalized.

    Returns (classes (M,), xywhn (M,4), kpts (M, K, 3) with x,y in [0,1]).
    """
    k, d = kpt_shape
    if not label_path.exists():
        return np.zeros((0,), np.int32), np.zeros((0, 4), np.float32), np.zeros((0, k, 3), np.float32)
    cls_list, boxes, kpts = [], [], []
    for line in label_path.read_text().splitlines():
        parts = line.split()
        if len(parts) < 5 + k * d:
            continue
        c = int(float(parts[0]))
        if nc is not None and not (0 <= c < nc):
            continue
        box = [float(v) for v in parts[1:5]]
        if not all(0.0 <= v <= 1.0 for v in box):
            continue
        raw = np.asarray([float(v) for v in parts[5: 5 + k * d]], np.float32).reshape(k, d)
        kp = np.zeros((k, 3), np.float32)
        kp[:, :2] = raw[:, :2]
        kp[:, 2] = raw[:, 2] if d == 3 else 1.0  # visibility
        cls_list.append(c)
        boxes.append(box)
        kpts.append(kp)
    if not cls_list:
        return np.zeros((0,), np.int32), np.zeros((0, 4), np.float32), np.zeros((0, k, 3), np.float32)
    return np.asarray(cls_list, np.int32), np.asarray(boxes, np.float32), np.stack(kpts)


def load_labels_obb(label_path: Path, nc: Optional[int] = None):
    """OBB labels (DOTA-in-YOLO): `cls x1 y1 x2 y2 x3 y3 x4 y4` normalized corners.

    Returns (classes (M,), corners (M, 4, 2) in [0,1]).
    """
    if not label_path.exists():
        return np.zeros((0,), np.int32), np.zeros((0, 4, 2), np.float32)
    cls_list, corners = [], []
    for line in label_path.read_text().splitlines():
        parts = line.split()
        if len(parts) != 9:
            continue
        c = int(float(parts[0]))
        if nc is not None and not (0 <= c < nc):
            continue
        pts = np.asarray([float(v) for v in parts[1:]], np.float32).reshape(4, 2)
        if pts.min() < 0.0 or pts.max() > 1.0:
            continue
        cls_list.append(c)
        corners.append(pts)
    if not cls_list:
        return np.zeros((0,), np.int32), np.zeros((0, 4, 2), np.float32)
    return np.asarray(cls_list, np.int32), np.stack(corners)


def corners_to_rbox(corners_px: np.ndarray) -> np.ndarray:
    """(M, 4, 2) pixel corners -> (M, 5) cx, cy, w, h, angle[rad in [-pi/4, 3pi/4))."""
    out = np.zeros((len(corners_px), 5), np.float32)
    for i, pts in enumerate(corners_px):
        (cx, cy), (w, h), deg = min_area_rect(pts.astype(np.float32))
        rad = np.deg2rad(deg)
        # canonicalize to the head's angle range
        if w < h:
            w, h = h, w
            rad += np.pi / 2
        while rad >= 3 * np.pi / 4:
            rad -= np.pi
        while rad < -np.pi / 4:
            rad += np.pi
        out[i] = [cx, cy, w, h, rad]
    return out


def polygons_to_boxes(polys, w: int, h: int) -> np.ndarray:
    """Polygon extents -> xyxy pixel boxes."""
    if not polys:
        return np.zeros((0, 4), np.float32)
    out = np.zeros((len(polys), 4), np.float32)
    for i, poly in enumerate(polys):
        xs, ys = poly[:, 0] * w, poly[:, 1] * h
        out[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return out


def rasterize_instance_mask(polys, shape_hw, scale: float = 1.0, pad=(0.0, 0.0), out_hw=None,
                            downsample: int = 4) -> np.ndarray:
    """Rasterize polygons into one overlap mask with instance ids 1..M.

    Polygons are normalized to the ORIGINAL image (shape_hw); `scale`/`pad`
    map through the letterbox; the mask is drawn at 1/downsample resolution
    (the proto grid). Later instances overwrite earlier (ultralytics overlap
    semantics: sorted by area descending so small objects stay visible).
    """
    h, w = shape_hw
    oh, ow = out_hw if out_hw else (int(h * scale), int(w * scale))
    mh, mw = oh // downsample, ow // downsample
    mask = np.zeros((mh, mw), np.int32)
    areas = []
    pts_scaled = []
    for poly in polys:
        pts = poly.copy()
        pts[:, 0] = (pts[:, 0] * w * scale + pad[0]) / downsample
        pts[:, 1] = (pts[:, 1] * h * scale + pad[1]) / downsample
        pts_i = np.round(pts).astype(np.int32)
        pts_scaled.append(pts_i)
        areas.append(contour_area(pts_i))
    filled = fill_polys((mh, mw), pts_scaled)  # each polygon's pixels, as cv2.fillPoly sets them
    for idx in np.argsort(-np.asarray(areas)) if areas else []:
        mask[filled[idx]] = int(idx) + 1
    return mask


def xywhn_to_xyxy(xywhn: np.ndarray, w: int, h: int) -> np.ndarray:
    """Normalized center-format -> absolute xyxy pixels."""
    out = np.empty_like(xywhn)
    cx, cy = xywhn[:, 0] * w, xywhn[:, 1] * h
    bw, bh = xywhn[:, 2] * w, xywhn[:, 3] * h
    out[:, 0] = cx - bw / 2
    out[:, 1] = cy - bh / 2
    out[:, 2] = cx + bw / 2
    out[:, 3] = cy + bh / 2
    return out


class YOLODataset:
    """Image+label pairs for one split of a YOLO-format dataset.

    task='detect'   labels: cls cx cy w h
    task='segment'  labels: cls x1 y1 x2 y2 ... (polygons; boxes derived)
    task='pose'     labels: cls cx cy w h x1 y1 v1 ... (keypoint triplets)
    task='obb'      labels: cls x1 y1 ... x4 y4 (corners; rotated and envelope boxes derived)
    """

    def __init__(self, data: Union[str, Path, Dict[str, Any]], split: str = "val", task: str = "detect",
                 kpt_shape=(17, 3)):
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {task!r}")
        self.cfg = parse_dataset_config(data)
        self.task = task
        self.kpt_shape = tuple(self.cfg.get("kpt_shape", kpt_shape))
        self.names = self.cfg["names"]
        self.nc = self.cfg["nc"]
        img_dir = _resolve_split_dir(self.cfg, split)
        if not img_dir.exists():
            raise FileNotFoundError(f"dataset split dir not found: {img_dir}")
        self.images: List[Path] = sorted(p for p in img_dir.rglob("*") if p.suffix.lower() in IMAGE_EXTS)
        if not self.images:
            raise ValueError(f"no images under {img_dir}")

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        path = self.images[i]
        img = load_image(path)
        h, w = img.shape[:2]
        lp = label_path_for(path)
        rec: Dict[str, Any] = {"image": img, "path": path, "orig_shape": (h, w)}
        if self.task == "segment":
            cls, polys = load_labels_segments(lp, self.nc)
            rec["classes"] = cls
            rec["boxes"] = polygons_to_boxes(polys, w, h)
            rec["polygons"] = polys
        elif self.task == "obb":
            cls, corners = load_labels_obb(lp, self.nc)
            rec["classes"] = cls
            corners_px = corners.copy()
            corners_px[..., 0] *= w
            corners_px[..., 1] *= h
            rec["corners"] = corners_px
            rec["rboxes"] = corners_to_rbox(corners_px) if len(cls) else np.zeros((0, 5), np.float32)
            # axis-aligned envelopes for the box metrics
            if len(cls):
                rec["boxes"] = np.stack([corners_px[..., 0].min(1), corners_px[..., 1].min(1),
                                         corners_px[..., 0].max(1), corners_px[..., 1].max(1)], axis=1)
            else:
                rec["boxes"] = np.zeros((0, 4), np.float32)
        elif self.task == "pose":
            cls, xywhn, kpts = load_labels_keypoints(lp, self.kpt_shape, self.nc)
            rec["classes"] = cls
            rec["boxes"] = xywhn_to_xyxy(xywhn, w, h) if len(cls) else np.zeros((0, 4), np.float32)
            kp = kpts.copy()
            kp[..., 0] *= w
            kp[..., 1] *= h
            rec["keypoints"] = kp  # pixels
        else:
            cls, xywhn = load_labels(lp, self.nc)
            rec["classes"] = cls
            rec["boxes"] = xywhn_to_xyxy(xywhn, w, h) if len(cls) else np.zeros((0, 4), np.float32)
        return rec

    def iter_val_batches(self, batch_size: int = 16, imgsz: int = 640) -> Generator[Dict[str, Any], None, None]:
        """Host-letterboxed uint8 batches + per-image geometry for un-mapping."""
        yield from iter_letterboxed_batches(self, batch_size, imgsz)


def iter_letterboxed_batches(dataset, batch_size: int, imgsz: int) -> Generator[Dict[str, Any], None, None]:
    """Val batching over any dataset-like (__len__/__getitem__) object: every
    image letterboxed to (imgsz, imgsz) on the host, the last batch padded
    with zero frames to the static batch size."""
    for start in range(0, len(dataset), batch_size):
        records = [dataset[i] for i in range(start, min(start + batch_size, len(dataset)))]
        imgs, metas = [], []
        for r in records:
            lb, ratio, pad = letterbox(r["image"], imgsz)
            imgs.append(lb)
            metas.append({"ratio": ratio, "pad": pad,
                          **{k: r[k] for k in ("path", "orig_shape", "classes", "boxes", "polygons", "keypoints")
                             if k in r}})
        n = len(imgs)
        if n < batch_size:  # pad batch to static shape
            imgs.extend([np.zeros_like(imgs[0])] * (batch_size - n))
        yield {"images": np.stack(imgs), "metas": metas, "n": n}


def polygons_to_instance_masks(polys, orig_shape_hw, ratio: float, pad, imgsz: int, downsample: int = 4) -> np.ndarray:
    """Per-instance binary masks at the letterboxed proto grid: (M, S/d, S/d)."""
    h, w = orig_shape_hw
    m = imgsz // downsample
    scaled = []
    for poly in polys:
        pts = poly.copy()
        pts[:, 0] = (pts[:, 0] * w * ratio + pad[0]) / downsample
        pts[:, 1] = (pts[:, 1] * h * ratio + pad[1]) / downsample
        scaled.append(np.round(pts).astype(np.int32))
    return fill_polys((m, m), scaled)
