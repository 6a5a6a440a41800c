"""YOLO11Validator: batched validation with the in-repo mAP computation.

Port of `yolo_infer_tpu/core/validator.py` for detect and pose. Per batch of
host-letterboxed frames the card runs letterbox -> forward -> full-grid f32
decode (kernel F) -> multi-label NMS (kernel G), enqueued without a host
sync; the host then matches the previous batch against its labels while the
card works, and only then waits for this batch's detections. Box mAP for
every task, OKS mAP for pose (`core/metrics.py`).

`model` is any object with a `.predictor` (the port's `YOLO11Model`), or a
port `Predictor` itself; with none, `model_path` names a seeded
`YOLO11Model` (a checkpoint file raises until ROADMAP Queue 1 item 5).
`benchmark_speed` times the model through `YOLO11Model.benchmark`.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from yolo_infer_tpu_torch.core.metrics import ConfusionMatrix, DetMetrics, oks_matrix
from yolo_infer_tpu_torch.core.predictor import Predictor
from yolo_infer_tpu_torch.data.dataset import YOLODataset, iter_letterboxed_batches
from yolo_infer_tpu_torch.ops.letterbox import scale_boxes

logger = logging.getLogger(__name__)

def _to_host(dets: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, np.ndarray]:
    """Copy a dets dict to numpy; on the card, the wait for the batch."""
    out = {k: v.cpu().numpy() for k, v in dets.items() if v is not None}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


class YOLO11Validator:
    """Validate a model on a YOLO-format dataset."""

    def __init__(
        self,
        model: Any = None,
        model_path: Optional[str] = None,
        output_dir: Union[str, Path] = "validation_results",
        device: Optional[str] = None,
    ):
        if model is None:
            from yolo_infer_tpu_torch.core.model import YOLO11Model

            model = YOLO11Model(model_path or "yolo11n", device=device)
        self.model = model
        self.device = device  # for the models compare_models builds
        self.output_dir = Path(output_dir)

    @property
    def predictor(self) -> Predictor:
        return self.model if isinstance(self.model, Predictor) else self.model.predictor

    # ------------------------------------------------------------------ val

    def validate(
        self,
        data: Union[str, Path, Dict[str, Any]],
        imgsz: int = 640,
        batch: int = 16,
        conf: float = 0.001,
        iou: float = 0.6,
        max_det: int = 300,
        split: str = "val",
        save_json: bool = False,
        multi_label: bool = True,
        verbose: bool = True,
        confusion_matrix: bool = False,
        pre_topk: int = 4096,
        limit: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Run validation; returns {metrics, speed, num_images, ...}.

        `limit` caps the split to its first N images (deterministic order)."""
        predictor = self.predictor
        task = getattr(self.model, "task", None) or predictor.spec.task
        ds_task = task if task in ("segment", "pose", "obb") else "detect"
        kpt_shape = getattr(predictor.spec, "kpt_shape", (17, 3))
        ds = YOLODataset(data, split=split, task=ds_task, kpt_shape=kpt_shape)
        if limit is not None:
            ds.images = ds.images[:limit]
        metrics = DetMetrics(nc=ds.nc)
        task_metrics = DetMetrics(nc=ds.nc) if ds_task == "pose" else None
        cm = ConfusionMatrix(nc=ds.nc) if confusion_matrix else None

        t_start = time.perf_counter()
        n_images = 0
        infer_time = 0.0
        pending = None  # (dets_np, metas, n) of the previous batch

        def drain(dets_np, metas, n):
            for i in range(n):
                m = metas[i]
                k = int(dets_np["num"][i])
                boxes = scale_boxes(dets_np["boxes"][i, :k], m["ratio"], m["pad"], m["orig_shape"])
                metrics.update(boxes, dets_np["scores"][i, :k], dets_np["classes"][i, :k].astype(np.int32),
                               m["boxes"], m["classes"])
                if cm is not None:
                    cm.process_batch(boxes, dets_np["scores"][i, :k], dets_np["classes"][i, :k],
                                     m["boxes"], m["classes"])
                if task_metrics is not None:
                    self._update_task_metrics(task_metrics, ds_task, dets_np, i, k, m, imgsz)

        for batch_data in ds.iter_val_batches(batch_size=batch, imgsz=imgsz):
            t0 = time.perf_counter()
            # pre_topk 4096: at conf 0.001 the multi-label candidate pool
            # exceeds the serving cap
            frames = torch.from_numpy(batch_data["images"]).to(predictor.device)
            dets = predictor.predict_raw(frames, conf, iou, imgsz, max_det, multi_label=multi_label, pre_topk=pre_topk)
            if pending is not None:
                drain(*pending)  # the host matches the previous batch while the card runs
            dets_np = _to_host(dets, predictor.device)
            infer_time += time.perf_counter() - t0
            pending = (dets_np, batch_data["metas"], batch_data["n"])
            n_images += batch_data["n"]
        if pending is not None:
            drain(*pending)

        results = metrics.compute()
        task_results = task_metrics.compute() if task_metrics is not None else None
        total_time = time.perf_counter() - t_start
        out = {
            "metrics": {
                "mAP50-95": results["map"],
                "mAP50": results["map50"],
                "mAP75": results["map75"],
                "precision": results["precision"],
                "recall": results["recall"],
            },
            "per_class_ap50": results.get("per_class_ap50", {}),
            "num_images": n_images,
            "speed": {
                "total_s": total_time,
                "inference_ms_per_image": infer_time / max(n_images, 1) * 1e3,
                "images_per_s": n_images / max(total_time, 1e-9),
            },
            "config": {"imgsz": imgsz, "batch": batch, "conf": conf, "iou": iou, "split": split},
        }
        if task_results is not None:
            out["pose_metrics"] = {
                "mAP50-95": task_results["map"],
                "mAP50": task_results["map50"],
                "mAP75": task_results["map75"],
            }
        if verbose:
            logger.info("validated %d images: mAP50-95=%.4f mAP50=%.4f", n_images, results["map"], results["map50"])
        self._save_validation_summary(out)
        if cm is not None:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            (self.output_dir / "confusion_matrix.txt").write_text(cm.to_text(ds.names) + "\n")
            out["confusion_matrix"] = cm.matrix.tolist()
        if save_json:
            (self.output_dir / "validation_results.json").write_text(json.dumps(out, indent=2, default=float))
        return out

    def _update_task_metrics(self, task_metrics, ds_task, dets_np, i, k, m, imgsz):
        """OKS (pose) matching for image i of a batch, in letterboxed pixels
        (segment's mask IoU waits with its dataset: ROADMAP Queue 1 item 4.1)."""
        scores = dets_np["scores"][i, :k]
        cls = dets_np["classes"][i, :k].astype(np.int32)
        gt_kpts = m.get("keypoints", np.zeros((0, 17, 3), np.float32)).copy()
        if len(gt_kpts):
            gt_kpts[..., 0] = gt_kpts[..., 0] * m["ratio"] + m["pad"][0]
            gt_kpts[..., 1] = gt_kpts[..., 1] * m["ratio"] + m["pad"][1]
        gt_boxes_lb = m["boxes"] * m["ratio"]
        areas = ((gt_boxes_lb[:, 2] - gt_boxes_lb[:, 0]) * (gt_boxes_lb[:, 3] - gt_boxes_lb[:, 1])
                 if len(gt_boxes_lb) else np.zeros((0,)))
        pred_kpts = (dets_np["kpts"][i, :k] if "kpts" in dets_np
                     else np.zeros((0, gt_kpts.shape[1] if len(gt_kpts) else 17, 3)))
        task_metrics.update_from_iou(oks_matrix(pred_kpts, gt_kpts, areas), scores, cls, m["classes"])

    # ------------------------------------------------- speed and comparison

    def benchmark_speed(self, imgsz_list: Sequence[int] = (320, 640, 1280),
                        batch_sizes: Sequence[int] = (1, 8, 16, 32), runs: int = 50) -> Dict[str, Any]:
        """`YOLO11Model.benchmark` over imgsz x batch; a setting that fails
        (out of memory) is recorded as an error and the sweep goes on."""
        results: Dict[str, Any] = {}
        for imgsz in imgsz_list:
            for b in batch_sizes:
                key = f"imgsz{imgsz}_batch{b}"
                try:
                    results[key] = self.model.benchmark(imgsz=imgsz, batch=b, runs=runs, warmup=5)
                except Exception as e:  # noqa: BLE001 -- the sweep survives a setting that fails
                    logger.warning("benchmark %s failed: %s", key, e)
                    results[key] = {"error": str(e)}
        self.output_dir.mkdir(parents=True, exist_ok=True)
        (self.output_dir / "speed_benchmark.json").write_text(json.dumps(results, indent=2, default=float))
        return results

    def compare_models(self, model_paths: Sequence[str], data: Union[str, Path, Dict[str, Any]],
                       **val_kw) -> Dict[str, Any]:
        """Validate several models (`YOLO11Model` names) on the same data and rank them by mAP50-95."""
        from yolo_infer_tpu_torch.core.model import YOLO11Model

        rows = {}
        for path in model_paths:
            r = YOLO11Validator(model=YOLO11Model(path, device=self.device), output_dir=self.output_dir).validate(
                data, verbose=False, **val_kw)
            rows[str(path)] = {"mAP50-95": r["metrics"]["mAP50-95"], "mAP50": r["metrics"]["mAP50"],
                               "images_per_s": r["speed"]["images_per_s"]}
        ranking = sorted(rows, key=lambda k: rows[k]["mAP50-95"], reverse=True)
        out = {"results": rows, "ranking": ranking, "best": ranking[0] if ranking else None}
        self.output_dir.mkdir(parents=True, exist_ok=True)
        (self.output_dir / "model_comparison.json").write_text(json.dumps(out, indent=2, default=float))
        return out

    # ------------------------------------------------------------- k-fold

    def cross_validate(
        self,
        data: Union[str, Path, Dict[str, Any]],
        k: int = 5,
        split: str = "val",
        **val_kw,
    ) -> Dict[str, Any]:
        """K-fold over the split's images (seeded shuffle, box metrics)."""
        ds = YOLODataset(data, split=split)
        idx = np.arange(len(ds))
        rng = np.random.default_rng(0)
        rng.shuffle(idx)
        folds = np.array_split(idx, k)
        scores = []
        for fi, fold in enumerate(folds):
            sub = _SubsetDataset(ds, fold.tolist())
            metrics = self._validate_dataset(sub, **val_kw)
            scores.append(metrics["metrics"]["mAP50-95"])
            logger.info("fold %d/%d: mAP50-95=%.4f (%d imgs)", fi + 1, k, scores[-1], len(fold))
        return {
            "folds": scores,
            "mean_mAP50-95": float(np.mean(scores)),
            "std_mAP50-95": float(np.std(scores)),
            "k": k,
        }

    def _validate_dataset(self, ds, predictor=None, imgsz: int = 640, batch: int = 16, conf: float = 0.001,
                          iou: float = 0.6, pre_topk: int = 4096, **kw) -> Dict[str, Any]:
        predictor = predictor or self.predictor
        metrics = DetMetrics(nc=ds.nc)
        n_images = 0
        for batch_data in ds.iter_val_batches(batch_size=batch, imgsz=imgsz):
            frames = torch.from_numpy(batch_data["images"]).to(predictor.device)
            dets = predictor.predict_raw(frames, conf, iou, imgsz, multi_label=True, pre_topk=pre_topk,
                                         mask_out="none" if predictor.spec.task == "segment" else None)
            dets_np = _to_host(dets, predictor.device)
            for i in range(batch_data["n"]):
                m = batch_data["metas"][i]
                kk = int(dets_np["num"][i])
                boxes = scale_boxes(dets_np["boxes"][i, :kk], m["ratio"], m["pad"], m["orig_shape"])
                metrics.update(boxes, dets_np["scores"][i, :kk], dets_np["classes"][i, :kk].astype(np.int32),
                               m["boxes"], m["classes"])
            n_images += batch_data["n"]
        r = metrics.compute()
        return {"metrics": {"mAP50-95": r["map"], "mAP50": r["map50"], "mAP75": r["map75"],
                            "precision": r["precision"], "recall": r["recall"]}, "num_images": n_images}

    # ------------------------------------------------------------- reporting

    def _save_validation_summary(self, results: Dict[str, Any]) -> None:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        lines = ["Validation Summary", "=" * 40]
        for k, v in results["metrics"].items():
            lines.append(f"{k:>12}: {v:.4f}")
        sp = results["speed"]
        lines += [
            f"{'images':>12}: {results['num_images']}",
            f"{'img/s':>12}: {sp['images_per_s']:.1f}",
            f"{'ms/img':>12}: {sp['inference_ms_per_image']:.2f}",
        ]
        (self.output_dir / "validation_summary.txt").write_text("\n".join(lines) + "\n")


class _SubsetDataset:
    """View over a subset of a YOLODataset's images (for cross-validation)."""

    def __init__(self, ds: YOLODataset, indices: List[int]):
        self._ds = ds
        self._indices = indices
        self.nc = ds.nc
        self.names = ds.names

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        return self._ds[self._indices[i]]

    def iter_val_batches(self, batch_size=16, imgsz=640):
        yield from iter_letterboxed_batches(self, batch_size, imgsz)


def create_validator(model_path: str = "yolo11n", **kw) -> YOLO11Validator:
    return YOLO11Validator(model_path=model_path, **kw)
