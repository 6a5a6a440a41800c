"""Quantizers: dynamic int8, post-training static int8 (static8), QAT.

Port of `yolo_infer_tpu/optimization/quantization/quantizers.py`
(`DynamicQuantizer`, `PostTrainingQuantizer`, `QATQuantizer`,
`_quantized_clone`, `QuantizationUtils`, `create_quantizer`). Each quantizes
the deploy model's convs per output channel (`models/yolo11.py
quantize_model`). PTQ then runs "observe8" forwards of the quantized model
over at most 100 calibration batches and keeps the largest (input, output)
absmax of each quantized conv: the (n, 2) scales that static8 serving
consumes in the same order. The dynamic model has no scales: its activation
scales are taken on the device at every call. QAT trains the model with
fake-quant in the step (`TrainingConfig.qat`), then quantizes it as the
dynamic quantizer does.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from yolo_infer_tpu_torch.optimization.base import BaseOptimizer, OptimizationRegistry, QuantizationOptimizer

logger = logging.getLogger(__name__)

MAX_CALIBRATION_BATCHES = 100


def _quantized_clone(model, act_scales=None, qmodel=None):
    """A YOLO11Model around the int8 deploy form of `model` (and PTQ scales)."""
    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.models.yolo11 import quantize_model

    if qmodel is None:
        qmodel = quantize_model(copy.deepcopy(model.deploy_model))
    return YOLO11Model.from_params(
        qmodel, task=model.task, size=model.size, nc=model.nc, names=model.names, fused=True,
        quant_act_scales=None if act_scales is None else np.asarray(act_scales, np.float32),
        compute_dtype=model.compute_dtype, model_path=f"{model.model_path}-int8", device=model.device,
        mask_mode=model.mask_mode,
    )


class DynamicQuantizer(QuantizationOptimizer):
    """Weights int8 offline; activation scales computed on the device at every call."""

    def optimize(self) -> Any:
        t0 = time.perf_counter()
        self.optimized_model = _quantized_clone(self.model)
        self.optimization_info = {
            "method": "dynamic",
            "dtype": self.dtype,
            "activation_scales": "dynamic (per-tensor absmax, on-device)",
            "weight_scales": "per-output-channel",
            "time_s": time.perf_counter() - t0,
        }
        logger.info("dynamic int8 quantization done in %.1fs", self.optimization_info["time_s"])
        return self.optimized_model


class QATQuantizer(QuantizationOptimizer):
    """Quantization-aware training: fake-quant (straight-through) inside the
    real training step and loss, then int8 conversion of the trained EMA
    weights. Config keys: epochs (10), lr (1e-4), data."""

    def __init__(self, model: Any, config: Optional[Dict[str, Any]] = None):
        super().__init__(model, config)
        self.epochs = int(self.config.get("epochs", 10))
        self.lr = float(self.config.get("lr", 1e-4))

    def optimize(self, data: Optional[str] = None, resume: bool = False, checkpoint_period: int = 1,
                 **train_kw) -> Any:
        data = data or self.config.get("data")
        if not data:
            raise RuntimeError("QAT needs a dataset: pass data=... (YOLO yaml)")
        from yolo_infer_tpu_torch.core.trainer import TrainingConfig, YOLO11Trainer

        t0 = time.perf_counter()
        kw = {"mosaic": 0.0, "name": "qat"}  # defaults the caller may override
        kw.update(train_kw)
        cfg = TrainingConfig(data=str(data), epochs=self.epochs, lr0=self.lr, cos_lr=True,
                             save_period=checkpoint_period, resume=resume, qat=True, **kw)
        train_result = YOLO11Trainer(model=self.model, config=cfg).train()
        self.optimized_model = _quantized_clone(self.model)
        self.optimization_info = {
            "method": "qat",
            "dtype": self.dtype,
            "epochs": self.epochs,
            "train_status": train_result.get("status"),
            "time_s": time.perf_counter() - t0,
        }
        return self.optimized_model


class PostTrainingQuantizer(QuantizationOptimizer):
    """PTQ: observe activation ranges over calibration batches, bake static scales."""

    def __init__(self, model: Any, config: Optional[Dict[str, Any]] = None):
        super().__init__(model, config)
        self.num_calibration_batches = int(self.config.get("num_calibration_batches", MAX_CALIBRATION_BATCHES))
        self.imgsz = int(self.config.get("imgsz", 640))

    def optimize(self) -> Any:
        if not self.calibration_data:
            raise RuntimeError("set_calibration_data() first (PTQ needs calibration batches)")
        from yolo_infer_tpu_torch.models.yolo11 import quantize_model

        t0 = time.perf_counter()
        # quantize FIRST, then calibrate the quantized model: observe8 records
        # (in, out) absmax at exactly the convs static8 consumes, with the
        # int8 weights' activation statistics
        qmodel = quantize_model(copy.deepcopy(self.model.deploy_model))
        scales = self._calibrate(qmodel)  # (n_quantized_convs, 2)
        self.optimized_model = _quantized_clone(self.model, act_scales=scales, qmodel=qmodel)
        self.optimization_info = {
            "method": "ptq",
            "dtype": self.dtype,
            "num_calibration_batches": min(len(self.calibration_data), self.num_calibration_batches),
            "num_observed_convs": int(len(scales)),
            "activation_path": "int8 residency (static in/out scales, fused requant)",
            "time_s": time.perf_counter() - t0,
        }
        logger.info("PTQ done: %d convs calibrated in %.1fs", len(scales), self.optimization_info["time_s"])
        return self.optimized_model

    @torch.inference_mode()
    def _calibrate(self, qmodel) -> np.ndarray:
        """observe8 forwards of the quantized model on the model's device;
        per-conv (input, output) absmax, the max over the batches."""
        from yolo_infer_tpu_torch.core.predictor import Predictor
        from yolo_infer_tpu_torch.nn.quantize import QuantContext, quant_context
        from yolo_infer_tpu_torch.ops.preprocess import preprocess_batch

        model = self.model
        pred = Predictor(qmodel, model.spec, device=model.device, compute_dtype=model.compute_dtype)
        agg: Optional[np.ndarray] = None
        for batch in self.calibration_data[: self.num_calibration_batches]:
            batch = np.asarray(batch)
            if batch.ndim == 3:
                batch = batch[None]
            if batch.dtype != np.uint8:
                batch = np.clip(batch * 255 if batch.max() <= 1.0 else batch, 0, 255).astype(np.uint8)
            frames = torch.from_numpy(np.ascontiguousarray(batch)).to(pred.device)
            x = preprocess_batch(frames, out_hw=(self.imgsz, self.imgsz), dtype=model.compute_dtype)
            with quant_context(QuantContext("observe8")) as ctx:
                pred.model(x)
            absmax = torch.stack(ctx.collected).cpu().numpy()
            agg = absmax if agg is None else np.maximum(agg, absmax)
        return agg


class QuantizationUtils:
    """Size and introspection helpers."""

    @staticmethod
    def compare_model_sizes(original, quantized) -> Dict[str, float]:
        from yolo_infer_tpu_torch.utils.helpers import calculate_model_size

        a = calculate_model_size(original.deploy_model)
        b = calculate_model_size(quantized.deploy_model)
        return {"original_mb": a["size_mb"], "quantized_mb": b["size_mb"],
                "compression_ratio": a["size_mb"] / max(b["size_mb"], 1e-9)}

    @staticmethod
    def benchmark_inference_speed(original, quantized, imgsz: int = 640, batch: int = 8,
                                  runs: int = 20) -> Dict[str, Any]:
        """`YOLO11Model.benchmark` of both models and the speedup (original / quantized time)."""
        a = original.benchmark(imgsz=imgsz, batch=batch, runs=runs, warmup=5)
        b = quantized.benchmark(imgsz=imgsz, batch=batch, runs=runs, warmup=5)
        return {"original": a, "quantized": b, "speedup": a["avg_time_s"] / b["avg_time_s"]}

    @staticmethod
    def is_quantized(model) -> bool:
        return any(t.dtype == torch.int8 for t in model.deploy_model.state_dict().values())


OptimizationRegistry.register("dynamic", DynamicQuantizer)
OptimizationRegistry.register("ptq", PostTrainingQuantizer)
OptimizationRegistry.register("qat", QATQuantizer)


def create_quantizer(method: str, model: Any, config: Optional[Dict[str, Any]] = None) -> BaseOptimizer:
    """'ptq' | 'dynamic' | 'qat' -> the quantizer."""
    mapping = {"ptq": PostTrainingQuantizer, "dynamic": DynamicQuantizer, "qat": QATQuantizer}
    if method not in mapping:
        raise ValueError(f"unknown quantization method {method!r}; expected one of {sorted(mapping)}")
    return mapping[method](model, config)
