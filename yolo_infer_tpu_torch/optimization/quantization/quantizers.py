"""Quantizers: post-training static int8 (static8).

Port of `yolo_infer_tpu/optimization/quantization/quantizers.py`
(`PostTrainingQuantizer`, `_quantized_clone`, `QuantizationUtils`,
`create_quantizer`). PTQ quantizes the deploy model's convs per output
channel (`models/yolo11.py quantize_model`), then runs "observe8" forwards
of the quantized model over at most 100 calibration batches and keeps the
largest (input, output) absmax of each quantized conv: the (n, 2) scales
that static8 serving consumes in the same order.

`DynamicQuantizer` and `QATQuantizer` are not ported and raise (ROADMAP
Queue 1 item 7).
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
_UNPORTED = "is not ported yet (ROADMAP Queue 1 item 7: dynamic and QAT int8)"


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
    def optimize(self) -> Any:
        raise NotImplementedError(f"dynamic int8 quantization {_UNPORTED}")


class QATQuantizer(QuantizationOptimizer):
    def optimize(self, *args, **kwargs) -> Any:
        raise NotImplementedError(f"quantization-aware training {_UNPORTED}")


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
    def benchmark_inference_speed(original, quantized, imgsz: int = 640, batch: int = 8, runs: int = 20):
        raise NotImplementedError("timing needs YOLO11Model.benchmark (ROADMAP Queue 1 item 6)")

    @staticmethod
    def is_quantized(model) -> bool:
        return any(t.dtype == torch.int8 for t in model.deploy_model.state_dict().values())


OptimizationRegistry.register("dynamic", DynamicQuantizer)
OptimizationRegistry.register("ptq", PostTrainingQuantizer)
OptimizationRegistry.register("qat", QATQuantizer)


def create_quantizer(method: str, model: Any, config: Optional[Dict[str, Any]] = None) -> BaseOptimizer:
    """'ptq' -> PostTrainingQuantizer ('dynamic' and 'qat' construct, and raise on optimize)."""
    mapping = {"ptq": PostTrainingQuantizer, "dynamic": DynamicQuantizer, "qat": QATQuantizer}
    if method not in mapping:
        raise ValueError(f"unknown quantization method {method!r}; expected one of {sorted(mapping)}")
    return mapping[method](model, config)
