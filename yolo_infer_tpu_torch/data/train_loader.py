"""Training batch pipeline: augment on host threads, prefetch ahead of the steps.

Port of `yolo_infer_tpu/data/train_loader.py` (`pad_labels`, `TrainLoader`):
fixed-shape batches (uint8 (B, S, S, 3) images, labels padded to
`max_boxes` with a validity mask), built on a background thread while the
card runs the previous step, behind a bounded queue. An epoch's batches are
a function of (seed + epoch * 9973) alone, as in the JAX package, and equal
its batches bit for bit.

The port builds a batch's samples in parallel (`workers` threads: numpy
releases the interpreter lock in its array work). Every random draw of a
sample comes from the epoch's one `random.Random`, in sample order, and
depends on no pixel or label (`data/augment.py`). So the producer first
draws each sample's values in order (`_record_draws`, which takes exactly
the draws `_build_sample` takes), then the threads build the samples from
those values (`_Replay`); the result does not depend on `workers`. A replay
that does not use up its draws, or runs past them, raises.

Unlike the JAX loader, an exception while building a batch is raised in the
consumer (the train loop), not logged as the end of the epoch. A sample
whose image or labels fail to load is still replaced by an empty gray frame
and counted (`corrupt_samples`): the host half of robust training.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from yolo_infer_tpu_torch.data.augment import DEFAULT_AUG, augment_full, concat_labels
from yolo_infer_tpu_torch.data.dataset import YOLODataset, rasterize_instance_mask

logger = logging.getLogger(__name__)


def pad_labels(boxes: np.ndarray, classes: np.ndarray, max_boxes: int):
    """Fixed-shape (max_boxes, ...) label tensors + validity mask."""
    n = min(len(boxes), max_boxes)
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_cls = np.zeros((max_boxes,), np.int32)
    mask = np.zeros((max_boxes,), bool)
    if n:
        out_boxes[:n] = boxes[:n]
        out_cls[:n] = classes[:n]
        mask[:n] = True
    return out_boxes, out_cls, mask


def prefetch(items: Iterable[Any], build: Callable[[Any], Any], depth: int) -> Iterator[Any]:
    """Yield `build(item)` for each item, built on a background thread up to
    `depth` items ahead. An exception in `build` is raised here; closing the
    iterator early stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def producer():
        try:
            for it in items:
                if stop.is_set():
                    return
                q.put((True, build(it)))
        except Exception as e:  # noqa: BLE001 -- handed to the consumer, which raises it
            q.put((False, e))
            return
        q.put((False, None))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            ok, value = q.get()
            if ok:
                yield value
            elif value is None:
                return
            else:
                raise value
    finally:
        stop.set()
        while t.is_alive():  # free a producer blocked on a full queue
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass


class _Replay:
    """The `random.Random` calls of `_build_sample`, answered from recorded
    draws in order: `random()` and `uniform(a, b)` (CPython's
    `a + (b - a) * random()`) from a recorded `random()`, `randrange` from
    its recorded result."""

    def __init__(self, draws: List[float]):
        self._draws = draws
        self._i = 0

    def _next(self):
        if self._i >= len(self._draws):
            raise RuntimeError("a sample took more random draws than were recorded for it")
        v = self._draws[self._i]
        self._i += 1
        return v

    def random(self) -> float:
        return self._next()

    def uniform(self, a: float, b: float) -> float:
        return a + (b - a) * self._next()

    def randrange(self, n: int) -> int:
        return self._next()

    def check_done(self) -> None:
        if self._i != len(self._draws):
            raise RuntimeError(f"a sample took {self._i} of the {len(self._draws)} random draws recorded for it")


class TrainLoader:
    """Iterates augmented fixed-shape batches with background prefetch.

    Every task gets the full mosaic/affine/mixup/HSV/flip pipeline with exact
    label geometry (`data/augment.py`). Task targets: 'masks' (B, S/4, S/4)
    int32 instance-id overlap masks for segment (rasterized from the
    augmented polygons), 'kpts' (B, M, K, 3) canvas-pixel keypoints for pose,
    5-column rotated 'boxes' for obb.
    """

    def __init__(
        self,
        dataset: YOLODataset,
        batch_size: int = 16,
        imgsz: int = 640,
        max_boxes: int = 120,
        hyp: Optional[Dict[str, float]] = None,
        seed: int = 0,
        prefetch: int = 2,
        workers: int = 1,
        task: str = "detect",
        shard: Tuple[int, int] = (0, 1),  # (process index, process count): each a disjoint slice of the batches
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.imgsz = imgsz
        self.max_boxes = max_boxes
        self.hyp = {**DEFAULT_AUG, **(hyp or {})}
        self.seed = seed
        self.prefetch = prefetch
        self.workers = max(int(workers), 1)
        self.epoch = 0
        self.shard = shard
        self.task = task if task != "detect" else getattr(dataset, "task", "detect")
        self.mosaic_enabled = self.hyp["mosaic"] > 0
        self.corrupt_samples = 0  # host-side sanitation counter (robust training)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        # must match epoch_batches exactly (ragged final chunk is dropped
        # when full batches exist; tiny datasets yield one padded batch)
        n = max(len(self.ds) // self.batch_size, 1)
        rank, world = self.shard
        if world > 1 and n >= world:
            n = n // world  # equal per-process step counts (ragged dropped)
        return n

    def close_mosaic(self) -> None:
        """Disable mosaic for the final close_mosaic epochs."""
        if self.mosaic_enabled:
            logger.info("closing mosaic augmentation")
        self.mosaic_enabled = False

    def _hsv_on(self) -> bool:
        return not (self.hyp["hsv_h"] == 0 and self.hyp["hsv_s"] == 0 and self.hyp["hsv_v"] == 0)

    def _record_draws(self, rng: random.Random, out: List[float]) -> None:
        """Append to `out`, from `rng`, the draws `_build_sample` takes, in its
        order: mosaic choice and its three extra indices, the mosaic centre,
        the affine's six, the HSV gains, the two flips, then mixup's choice,
        index, the mixed sample's own draws and the beta seed."""
        use_mosaic = False
        if self.mosaic_enabled:
            out.append(rng.random())
            use_mosaic = out[-1] < self.hyp["mosaic"]
        n = 0
        if use_mosaic:
            out.extend(rng.randrange(len(self.ds)) for _ in range(3))
            n += 2 + 6  # mosaic4_labels: yc, xc; _affine_matrix: angle, scale, 2 shears, 2 translations
        n += 3 if self._hsv_on() else 0
        n += 2  # fliplr, flipud
        out.extend(rng.random() for _ in range(n))
        if self.hyp.get("mixup", 0.0) > 0:
            out.append(rng.random())
            if out[-1] < self.hyp["mixup"]:
                out.append(rng.randrange(len(self.ds)))
                self._record_draws(rng, out)
                out.append(rng.randrange(1 << 31))

    def _build_sample(self, rng, i: int):
        """One augmented (image, labels) for any task (mosaic/affine/mixup)."""
        use_mosaic = self.mosaic_enabled and rng.random() < self.hyp["mosaic"]
        if use_mosaic:
            extra = [rng.randrange(len(self.ds)) for _ in range(3)]
            records = [self._safe_record(j) for j in [i, *extra]]
        else:
            records = [self._safe_record(i)]
        img, lab = augment_full(
            records, rng, imgsz=self.imgsz, hyp=self.hyp, use_mosaic=use_mosaic, task=self.task
        )
        if self.hyp.get("mixup", 0.0) > 0 and rng.random() < self.hyp["mixup"]:
            # mixup: beta(32,32) image blend, label union (YOLO convention)
            img2, lab2 = self._build_sample(rng, rng.randrange(len(self.ds)))
            lam = np.random.default_rng(rng.randrange(1 << 31)).beta(32.0, 32.0)
            img = (img.astype(np.float32) * lam + img2.astype(np.float32) * (1 - lam)).astype(np.uint8)
            lab = concat_labels([lab, lab2])
        return img, lab

    def _replayed_sample(self, plan: Tuple[int, List[float]]):
        i, draws = plan
        rng = _Replay(draws)
        out = self._build_sample(rng, i)
        rng.check_done()
        return out

    def _build_batch(self, rng: random.Random, indices, pool: Optional[ThreadPoolExecutor] = None
                     ) -> Dict[str, np.ndarray]:
        plans = []
        for i in indices:
            draws: List[float] = []
            self._record_draws(rng, draws)
            plans.append((i, draws))
        samples = list(pool.map(self._replayed_sample, plans) if pool else map(self._replayed_sample, plans))

        images, boxes_l, cls_l, valid_l, seg_masks, kpts_l = [], [], [], [], [], []
        k = getattr(self.ds, "kpt_shape", (17, 3))[0]
        size = np.array([self.imgsz, self.imgsz], np.float32)
        for img, lab in samples:
            images.append(img)
            if self.task == "obb":
                # fixed-shape (max_boxes, 5) rotated boxes replace xyxy
                rb = lab["rboxes"]
                b = np.zeros((self.max_boxes, 5), np.float32)
                c = np.zeros((self.max_boxes,), np.int32)
                m = np.zeros((self.max_boxes,), bool)
                n = min(len(rb), self.max_boxes)
                if n:
                    b[:n] = rb[:n]
                    c[:n] = lab["classes"][:n]
                    m[:n] = True
                boxes_l.append(b)
                cls_l.append(c)
                valid_l.append(m)
                continue
            b, c, m = pad_labels(lab["boxes"], lab["classes"], self.max_boxes)
            boxes_l.append(b)
            cls_l.append(c)
            valid_l.append(m)
            if self.task == "segment":
                # the augmented polygons on the final canvas; mask id i+1 is padded label row i
                polys_n = [p / size for p in lab["polygons"]]
                mask = rasterize_instance_mask(
                    polys_n, (self.imgsz, self.imgsz), out_hw=(self.imgsz, self.imgsz), downsample=4
                )
                seg_masks.append(np.where(mask > self.max_boxes, 0, mask))  # truncated instances
            elif self.task == "pose":
                kp = np.zeros((self.max_boxes, k, 3), np.float32)
                kpts = lab.get("keypoints", np.zeros((0, k, 3), np.float32))
                n = min(len(kpts), self.max_boxes)
                if n:
                    kp[:n] = kpts[:n]
                kpts_l.append(kp)
        out = {
            "images": np.stack(images),  # uint8: the train step normalises on the device
            "boxes": np.stack(boxes_l),
            "classes": np.stack(cls_l),
            "mask": np.stack(valid_l),
        }
        if seg_masks:
            out["masks"] = np.stack(seg_masks).astype(np.int32)
        if kpts_l:
            out["kpts"] = np.stack(kpts_l)
        return out

    def _safe_record(self, i: int) -> Dict[str, np.ndarray]:
        """Batch sanitation: a corrupt image or label never reaches the
        device; it is logged, counted and replaced by an empty gray frame."""
        try:
            return self.ds[i]
        except Exception as e:  # noqa: BLE001 -- any unreadable sample is replaced, not fatal
            with self._lock:
                self.corrupt_samples += 1
            logger.warning("skipping corrupt sample %d (%s)", i, e)
            return {
                "image": np.full((self.imgsz, self.imgsz, 3), 114, np.uint8),
                "boxes": np.zeros((0, 4), np.float32),
                "classes": np.zeros((0,), np.int32),
                "orig_shape": (self.imgsz, self.imgsz),
                "path": None,
            }

    def chunks(self, rng: random.Random) -> List[List[int]]:
        """The epoch's batches of dataset indices (shuffled by `rng`)."""
        order = list(range(len(self.ds)))
        rng.shuffle(order)
        chunks = [order[i: i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        # drop the ragged final chunk only if there are other chunks (static shapes)
        chunks = [c for c in chunks if len(c) == self.batch_size] or chunks[:1]
        if len(chunks[0]) < self.batch_size:  # tiny dataset: repeat to fill
            chunks[0] = (chunks[0] * self.batch_size)[: self.batch_size]
        rank, world = self.shard
        if world > 1 and len(chunks) >= world:
            per = len(chunks) // world
            chunks = chunks[rank * per: (rank + 1) * per]
        return chunks

    def epoch_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator over one epoch (deterministic per (seed, epoch))."""
        rng = random.Random(self.seed + epoch * 9973)
        chunks = self.chunks(rng)
        pool = ThreadPoolExecutor(self.workers, thread_name_prefix="augment") if self.workers > 1 else None
        try:
            yield from prefetch(chunks, lambda c: self._build_batch(rng, c, pool), self.prefetch)
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
