"""Knowledge distillation: a teacher trains a student.

Port of `yolo_infer_tpu/optimization/distillation.py`
(`DistillationOptimizer`, `create_distiller`). The frozen teacher runs
inside the student's train step (`core/train_step.py distill`): its folded
deploy module in eval mode, under `torch.no_grad`, so on the card its C2PSA
attention is kernel B inside the step. Every YOLO11 size has the same head
layout (4 * reg_max + nc channels at strides 8/16/32), so a larger teacher's
raw maps align with the student's per anchor and the KD loss
(`core/losses.py distill_detect_loss`) needs no projection; classify
distills the softened-softmax KL (`distill_classify_loss`). The loss is
alpha * soft + (1 - alpha) * hard, with the reference's declared defaults
alpha 0.7 and temperature 4.0.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, Optional

from yolo_infer_tpu_torch.optimization.base import BaseOptimizer, OptimizationRegistry

logger = logging.getLogger(__name__)


def _param_count(model) -> int:
    return sum(p.numel() for p in model.parameters())


class DistillationOptimizer(BaseOptimizer):
    """Distill a (larger) teacher into `self.model`. Config keys: teacher (a
    `YOLO11Model`, or a name or path such as "yolo11s" or "best.msgpack";
    or pass it to `optimize`), temperature (4.0), alpha (0.7).

    `optimize(data, teacher=None, epochs=10, **train_kw)` trains a copy of
    `self.model` (the original stays for `compare_models`) and returns it."""

    def __init__(self, model: Any, config: Optional[Dict[str, Any]] = None):
        super().__init__(model, config)
        self.temperature = float(self.config.get("temperature", 4.0))
        self.alpha = float(self.config.get("alpha", 0.7))
        self.teacher = self.config.get("teacher")

    def _resolve_teacher(self, teacher: Any):
        from yolo_infer_tpu_torch.core.model import YOLO11Model

        teacher = teacher if teacher is not None else self.teacher
        if teacher is None:
            raise ValueError("distillation needs a teacher (config['teacher'] or optimize(teacher=...))")
        s = self.model
        if isinstance(teacher, str):
            teacher = YOLO11Model(teacher, task=s.task, nc=s.nc, device=s.device, compute_dtype=s.compute_dtype)
        if teacher.task != s.task:
            raise ValueError(f"teacher task {teacher.task!r} != student task {s.task!r}")
        if teacher.nc != s.nc:
            raise ValueError(f"teacher nc {teacher.nc} != student nc {s.nc}")
        if teacher.task != "classify" and (
                teacher.spec.reg_max != s.spec.reg_max or tuple(teacher.spec.strides) != tuple(s.spec.strides)):
            raise ValueError("teacher/student head layouts differ (reg_max or strides)")
        return teacher

    def _student_copy(self):
        from yolo_infer_tpu_torch.core.model import YOLO11Model, _has_batch_norms

        m = self.model
        if not _has_batch_norms(m.model):
            raise ValueError("distillation trains the student; training-form (unfused) params are "
                             f"required but {m.model_path!r} was loaded fused")
        return YOLO11Model.from_params(copy.deepcopy(m.model), task=m.task, size=m.size, nc=m.nc, names=m.names,
                                       fused=False, compute_dtype=m.compute_dtype,
                                       model_path=f"{m.model_path}-distilled", device=m.device,
                                       mask_mode=m.mask_mode)

    def optimize(self, data: str, teacher: Any = None, epochs: int = 10, **train_kw) -> Any:
        from yolo_infer_tpu_torch.core.trainer import TrainingConfig, YOLO11Trainer

        teacher = self._resolve_teacher(teacher)
        student = self._student_copy()
        trainer = YOLO11Trainer(model=student, config=TrainingConfig(data=data, epochs=epochs, **train_kw))
        trainer.distill = {"model": teacher.deploy_model, "temperature": self.temperature, "alpha": self.alpha}
        out = trainer.train()
        self.optimized_model = student
        hist = out.get("history") or []
        self.optimization_info = {
            "teacher": teacher.model_path,
            "teacher_params": _param_count(teacher.model),
            "student_params": _param_count(student.model),
            "temperature": self.temperature,
            "alpha": self.alpha,
            "epochs_completed": out.get("epochs_completed"),
            "best_fitness": out.get("best_fitness"),
            "final_loss": hist[-1].get("loss") if hist else None,
            "final_loss_kd": hist[-1].get("loss_kd") if hist else None,
        }
        return student


OptimizationRegistry.register("distill", DistillationOptimizer)


def create_distiller(model: Any, config: Optional[Dict[str, Any]] = None) -> DistillationOptimizer:
    return DistillationOptimizer(model, config)
