"""Small helpers: the model size (port of `yolo_infer_tpu/utils/helpers.py calculate_model_size`)."""

from __future__ import annotations

from typing import Dict

import torch.nn as nn

_STATE = ("running_mean", "running_var", "num_batches_tracked")  # batch-norm state, not parameters


def calculate_model_size(model: nn.Module) -> Dict[str, float]:
    """Parameter count and bytes of a module's weights (float and int8
    tensors of its state dict, batch-norm statistics excluded)."""
    tensors = [t for k, t in model.state_dict().items() if not k.endswith(_STATE)]
    n_params = sum(t.numel() for t in tensors)
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    return {"parameters": n_params, "size_mb": round(n_bytes / (1024 * 1024), 3), "size_bytes": n_bytes}
