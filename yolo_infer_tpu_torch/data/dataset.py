"""YOLO-format dataset (images/ + labels/*.txt with normalized xywh).

Port of `yolo_infer_tpu/data/dataset.py` for the detect and pose tasks: the
dataset config (a dict, or a YAML file read with `yaml` on first use), the
per-image label files (`cls cx cy w h`, plus keypoint triplets for pose),
and the host-letterboxed val batches (the port's OpenCV-free `letterbox`).
Segment ground truth needs a polygon fill and OBB labels a minimum-area
rectangle, which the JAX package takes from OpenCV; both raise
`NotImplementedError` here (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Generator, List, Optional, Tuple, Union

import numpy as np

from yolo_infer_tpu_torch.data.loader import IMAGE_EXTS, load_image
from yolo_infer_tpu_torch.ops.letterbox import letterbox

TASKS = ("detect", "pose")
_UNPORTED_TASKS = ("segment", "obb")


def parse_dataset_config(data: Union[str, Path, Dict[str, Any]]) -> Dict[str, Any]:
    if isinstance(data, (str, Path)):
        import yaml

        cfg = yaml.safe_load(Path(data).read_text())
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
    base = Path(cfg.get("path", cfg["_base"]))
    if not base.is_absolute():
        base = Path(cfg["_base"]) / base
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
    task='pose'     labels: cls cx cy w h x1 y1 v1 ... (keypoint triplets)
    """

    def __init__(self, data: Union[str, Path, Dict[str, Any]], split: str = "val", task: str = "detect",
                 kpt_shape=(17, 3)):
        if task in _UNPORTED_TASKS:
            raise NotImplementedError(f"{task} datasets are not ported yet (ROADMAP Queue 1 item 5: "
                                      "segment needs a polygon fill, OBB a minimum-area rectangle)")
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
        if self.task == "pose":
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
                          **{k: r[k] for k in ("path", "orig_shape", "classes", "boxes", "keypoints") if k in r}})
        n = len(imgs)
        if n < batch_size:  # pad batch to static shape
            imgs.extend([np.zeros_like(imgs[0])] * (batch_size - n))
        yield {"images": np.stack(imgs), "metas": metas, "n": n}
