"""PyTorch + CUDA port of yolo_infer_tpu for one NVIDIA H100.

Module names follow the JAX package's, so each module's counterpart is easy
to find. Plain tensor code is PyTorch; the JAX package's Pallas kernels are
hand-written CUDA C++ under `csrc/`, built with nvcc at first use
(`ops/kernels/_build.py`). This package never imports `jax` or
`yolo_infer_tpu`.
"""

from yolo_infer_tpu_torch.core.predictor import Predictor, Results
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.models.yolo11 import YOLO11, build_model, fold_model

__all__ = ["Predictor", "Results", "YOLO11", "build_model", "build_spec", "fold_model"]
