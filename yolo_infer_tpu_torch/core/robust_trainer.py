"""Robust (error-skipping) trainer.

Port of `yolo_infer_tpu/core/robust_trainer.py` (`classify_training_error`,
`RobustYOLO11Trainer`, `create_robust_trainer`). Robustness comes in three
layers, as there:

1. host-side batch sanitation: a sample that fails to load is replaced and
   counted (`data/train_loader.py TrainLoader._safe_record`);
2. the step's finite guard: a non-finite loss or gradient norm drops the
   update and counts the step (`core/train_step.py`, `skipped`);
3. the run-level envelope, this class: with `skip_errors=True` an exception
   that ends the run is classified and reported as a "failed" status (with
   its traceback) instead of raised. The command line exits 1 on it.
"""

from __future__ import annotations

import logging
import traceback
from typing import Any, Dict, Optional, Union

from yolo_infer_tpu_torch.core.trainer import TrainingConfig, YOLO11Trainer

logger = logging.getLogger(__name__)


def classify_training_error(exc: Exception) -> str:
    """Map an exception to a coarse cause."""
    msg = f"{type(exc).__name__}: {exc}".lower()
    if "shape" in msg or "dimension" in msg or "broadcast" in msg:
        return "shape_mismatch"
    if "memory" in msg or "resource exhausted" in msg or "oom" in msg:
        return "out_of_memory"
    if "nan" in msg or "inf" in msg or "finite" in msg:
        return "numeric"
    if isinstance(exc, (FileNotFoundError, ValueError)):
        return "data"
    return "unknown"


class RobustYOLO11Trainer(YOLO11Trainer):
    """Trainer that reports a failed run instead of raising, and marks a run
    with dropped (non-finite) steps."""

    def __init__(self, *args, skip_errors: bool = True, **kw):
        super().__init__(*args, **kw)
        self.skip_errors = skip_errors

    def train(self, **kw) -> Dict[str, Any]:
        try:
            result = super().train(**kw)
        except Exception as exc:  # noqa: BLE001 -- the run-level envelope: classified, logged and reported
            cause = classify_training_error(exc)
            logger.error("training failed (%s): %s", cause, exc)
            if not self.skip_errors:
                raise
            return {
                "status": "failed",
                "error": str(exc),
                "error_type": cause,
                "error_skipped": True,
                "traceback": traceback.format_exc(),
            }
        skipped = result.get("skipped_steps", 0)
        if skipped:
            result["status"] = "completed_with_skipped_errors"
            result["skipped_batches"] = skipped
            logger.warning("training completed with %d skipped (non-finite) steps", skipped)
        return result


def create_robust_trainer(
    model_path: str = "yolo11n",
    config: Optional[Union[TrainingConfig, Dict[str, Any]]] = None,
    skip_errors: bool = True,
    **kw,
) -> RobustYOLO11Trainer:
    """Factory."""
    if isinstance(config, dict):
        config = TrainingConfig.from_dict(config)
    return RobustYOLO11Trainer(model_path=model_path, config=config, skip_errors=skip_errors, **kw)
