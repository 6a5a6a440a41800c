"""Classification dataset (image-folder layout), prefetching loader and evaluation.

Port of `yolo_infer_tpu/data/classify.py`. Layout: root/{train,val}/<class
name>/*.png (the YOLO-cls / ImageFolder convention), or the class
directories straight under root. Each image is resized so its short side is
`imgsz` and centre-cropped (`_resize_center_crop`, on the port's
`resize_linear_u8`, bit-equal to `cv2.resize`'s bilinear). `ClassifyLoader`
builds fixed-shape, optionally flipped uint8 batches on a background thread
(host only; it serves training; an exception while building one is raised
in the consumer). `evaluate_classifier` gives top-1 and top-5
accuracy over every image once: frames go to the predictor's device, the
ragged last batch is padded to the static batch and its padding left out.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, Iterator, List, Tuple, Union

import numpy as np
import torch

from yolo_infer_tpu_torch.data.loader import IMAGE_EXTS, load_image
from yolo_infer_tpu_torch.data.train_loader import prefetch
from yolo_infer_tpu_torch.ops.letterbox import resize_linear_u8


class ClassifyDataset:
    """Images + integer labels from a class-per-directory tree."""

    def __init__(self, root: Union[str, Path], split: str = "train"):
        base = Path(root)
        if (base / split).exists():
            split_dir = base / split
        elif any((base / s).exists() for s in ("train", "val", "test")):
            # a split layout without the requested split: the root's
            # directories are splits, not classes
            raise FileNotFoundError(f"split {split!r} not found under {base}")
        else:
            split_dir = base  # flat class-per-dir layout
        classes = sorted(d.name for d in split_dir.iterdir() if d.is_dir())
        if not classes:
            raise ValueError(f"no class directories under {split_dir}")
        self.names = {i: c for i, c in enumerate(classes)}
        self.nc = len(classes)
        self.samples: List[Tuple[Path, int]] = []
        for i, c in enumerate(classes):
            for p in sorted((split_dir / c).rglob("*")):
                if p.suffix.lower() in IMAGE_EXTS:
                    self.samples.append((p, i))
        if not self.samples:
            raise ValueError(f"no images under {split_dir}")

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Dict:
        path, label = self.samples[i]
        return {"image": load_image(path), "label": label, "path": path}


def _resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    scale = size / min(h, w)
    img = resize_linear_u8(img, max(size, round(w * scale)), max(size, round(h * scale)))
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top: top + size, left: left + size]


class ClassifyLoader:
    """Fixed-shape augmented batches with background prefetch."""

    def __init__(self, dataset: ClassifyDataset, batch_size: int = 64, imgsz: int = 224, augment: bool = True,
                 fliplr: float = 0.5, seed: int = 0, prefetch: int = 2):
        self.ds = dataset
        self.batch_size = batch_size
        self.imgsz = imgsz
        self.augment = augment
        self.fliplr = fliplr
        self.seed = seed
        self.prefetch = prefetch

    def __len__(self) -> int:
        return max(len(self.ds) // self.batch_size, 1)

    def _build(self, rng: random.Random, idxs) -> Dict[str, np.ndarray]:
        imgs, labels = [], []
        for i in idxs:
            r = self.ds[i]
            img = _resize_center_crop(r["image"], self.imgsz)
            if self.augment and rng.random() < self.fliplr:
                img = np.ascontiguousarray(img[:, ::-1])
            imgs.append(img)
            labels.append(r["label"])
        # uint8 frames: the model's preprocess normalizes them on the device
        return {"images": np.stack(imgs), "labels": np.asarray(labels, np.int32)}

    def epoch_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = random.Random(self.seed + epoch * 7919)
        order = list(range(len(self.ds)))
        rng.shuffle(order)
        chunks = [order[i: i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        chunks = [c for c in chunks if len(c) == self.batch_size] or chunks[:1]
        if len(chunks[0]) < self.batch_size:
            chunks[0] = (chunks[0] * self.batch_size)[: self.batch_size]
        # an exception while building a batch is raised here, in the train loop
        yield from prefetch(chunks, lambda c: self._build(rng, c), self.prefetch)

    def close_mosaic(self) -> None:  # the train loader's interface
        pass


def evaluate_classifier(model, dataset: ClassifyDataset, imgsz: int = 224, batch: int = 64,
                        predictor=None) -> Dict[str, float]:
    """Top-1 / top-5 accuracy over EVERY image exactly once (the final ragged
    batch is padded to the static batch shape and the padding is masked out)."""
    predictor = predictor or model.predictor
    top1 = top5 = n = 0
    total = len(dataset)
    for start in range(0, total, batch):
        idxs = list(range(start, min(start + batch, total)))
        imgs, labels = [], []
        for i in idxs:
            r = dataset[i]
            imgs.append(_resize_center_crop(r["image"], imgsz))
            labels.append(r["label"])
        n_real = len(idxs)
        if n_real < batch:
            imgs.extend([np.zeros_like(imgs[0])] * (batch - n_real))
        frames = torch.from_numpy(np.stack(imgs)).to(predictor.device)
        out = predictor.predict_raw(frames, 0.0, 0.0, imgsz)
        probs = out["probs"].float().cpu().numpy()[:n_real]
        labels_np = np.asarray(labels, np.int64)
        order = np.argsort(-probs, axis=-1)
        top1 += int((order[:, 0] == labels_np).sum())
        top5 += int((order[:, :5] == labels_np[:, None]).any(axis=1).sum())
        n += n_real
    return {"top1": top1 / max(n, 1), "top5": top5 / max(n, 1), "num_images": n}
