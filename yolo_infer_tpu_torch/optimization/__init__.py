"""optimization of the PyTorch port: quantization (dynamic, PTQ, QAT), pruning
(masks and surgery), distillation, the pipeline and the registry.

Importing this package registers every optimizer with `OptimizationRegistry`:
'dynamic' | 'ptq' | 'qat' | 'prune' | 'distill'.
"""

from yolo_infer_tpu_torch.optimization.base import (
    BaseOptimizer,
    OptimizationPipeline,
    OptimizationRegistry,
    QuantizationOptimizer,
)
from yolo_infer_tpu_torch.optimization.distillation import DistillationOptimizer, create_distiller
from yolo_infer_tpu_torch.optimization.pruning import PruningOptimizer, create_pruner
from yolo_infer_tpu_torch.optimization.quantization.quantizers import (
    DynamicQuantizer,
    PostTrainingQuantizer,
    QATQuantizer,
    create_quantizer,
)

__all__ = [
    "BaseOptimizer",
    "QuantizationOptimizer",
    "PruningOptimizer",
    "DistillationOptimizer",
    "OptimizationPipeline",
    "OptimizationRegistry",
    "DynamicQuantizer",
    "PostTrainingQuantizer",
    "QATQuantizer",
    "create_quantizer",
    "create_pruner",
    "create_distiller",
]
