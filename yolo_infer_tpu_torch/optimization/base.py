"""Optimization framework: base classes, pipeline, registry.

Port of `yolo_infer_tpu/optimization/base.py`: `BaseOptimizer` (optimize,
evaluate, get_optimization_info), `QuantizationOptimizer`
(set_calibration_data), `OptimizationPipeline` and `OptimizationRegistry`.
Models are the port's `YOLO11Model` wrappers; an optimized model saves as a
fused native checkpoint with its optimization info beside it in JSON.
`evaluate` without data and `compare_models` time through
`YOLO11Model.benchmark`.
"""

from __future__ import annotations

import abc
import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Type, Union

import numpy as np

logger = logging.getLogger(__name__)

class BaseOptimizer(abc.ABC):
    """Abstract model optimizer."""

    def __init__(self, model: Any, config: Optional[Dict[str, Any]] = None):
        self.model = model
        self.config = config or {}
        self.optimized_model: Optional[Any] = None
        self.optimization_info: Dict[str, Any] = {}

    @abc.abstractmethod
    def optimize(self, *args, **kwargs) -> Any:
        """Produce and return the optimized model."""

    def evaluate(self, data: Optional[Any] = None, imgsz: int = 640, batch: int = 16) -> Dict[str, Any]:
        """Accuracy of the optimized model on a dataset (the port's validator),
        or with no dataset its speed (`YOLO11Model.benchmark`)."""
        if self.optimized_model is None:
            raise RuntimeError("call optimize() first")
        if data:
            from yolo_infer_tpu_torch.core.validator import YOLO11Validator

            return YOLO11Validator(model=self.optimized_model).validate(data, imgsz=imgsz, batch=batch, verbose=False)
        return self.optimized_model.benchmark(imgsz=imgsz, batch=batch, runs=20, warmup=5)

    def get_optimization_info(self) -> Dict[str, Any]:
        return dict(self.optimization_info)

    def save_optimized_model(self, path: Union[str, Path]) -> Path:
        """The optimized model as a fused native checkpoint (PTQ scales
        included), and `optimization_info` in `<path stem>.info.json`."""
        if self.optimized_model is None:
            raise RuntimeError("call optimize() first")
        path = Path(path)
        out = self.optimized_model.save(path, fused=True)
        path.with_suffix(".info.json").write_text(json.dumps(self.optimization_info, indent=2, default=float))
        return out

    @staticmethod
    def load_optimized_model(path: Union[str, Path]) -> Any:
        from yolo_infer_tpu_torch.core.model import YOLO11Model

        return YOLO11Model(path)

    def compare_models(self, imgsz: int = 640, batch: int = 8, runs: int = 20) -> Dict[str, Any]:
        """Original against optimized: time (`YOLO11Model.benchmark`) and size."""
        if self.optimized_model is None:
            raise RuntimeError("call optimize() first")
        from yolo_infer_tpu_torch.utils.helpers import calculate_model_size

        orig = self.model.benchmark(imgsz=imgsz, batch=batch, runs=runs, warmup=5)
        opt = self.optimized_model.benchmark(imgsz=imgsz, batch=batch, runs=runs, warmup=5)
        size_orig = calculate_model_size(self.model.deploy_model)
        size_opt = calculate_model_size(self.optimized_model.deploy_model)
        return {
            "original": {"avg_time_s": orig["avg_time_s"], "fps": orig["fps"], "size_mb": size_orig["size_mb"]},
            "optimized": {"avg_time_s": opt["avg_time_s"], "fps": opt["fps"], "size_mb": size_opt["size_mb"]},
            "speedup": orig["avg_time_s"] / opt["avg_time_s"],
            "compression_ratio": size_orig["size_mb"] / max(size_opt["size_mb"], 1e-9),
        }


class QuantizationOptimizer(BaseOptimizer):
    """Shared quantization config: int8 only."""

    SUPPORTED_DTYPES = ("int8",)

    def __init__(self, model: Any, config: Optional[Dict[str, Any]] = None):
        super().__init__(model, config)
        self.dtype = self.config.get("dtype", "int8")
        if self.dtype not in self.SUPPORTED_DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not in {self.SUPPORTED_DTYPES}")
        self.calibration_data: Optional[Sequence[np.ndarray]] = None

    def set_calibration_data(self, data: Sequence[np.ndarray]) -> None:
        self.calibration_data = data


class OptimizationPipeline:
    """Chain of optimizers applied in order."""

    def __init__(self, model: Any):
        self.model = model
        self.steps: List[BaseOptimizer] = []
        self.results: List[Dict[str, Any]] = []

    def add_step(self, optimizer: BaseOptimizer) -> "OptimizationPipeline":
        self.steps.append(optimizer)
        return self

    def run(self, **kwargs) -> Any:
        current = self.model
        for i, step in enumerate(self.steps):
            step.model = current
            t0 = time.perf_counter()
            current = step.optimize(**kwargs)
            self.results.append({"step": i, "optimizer": type(step).__name__, "time_s": time.perf_counter() - t0,
                                 "info": step.get_optimization_info()})
        return current


class OptimizationRegistry:
    """Name -> optimizer class registry."""

    _registry: Dict[str, Type[BaseOptimizer]] = {}

    @classmethod
    def register(cls, name: str, optimizer_cls: Type[BaseOptimizer]) -> None:
        cls._registry[name] = optimizer_cls

    @classmethod
    def get(cls, name: str) -> Type[BaseOptimizer]:
        if name not in cls._registry:
            raise KeyError(f"unknown optimizer {name!r}; registered: {sorted(cls._registry)}")
        return cls._registry[name]

    @classmethod
    def available(cls) -> List[str]:
        return sorted(cls._registry)
