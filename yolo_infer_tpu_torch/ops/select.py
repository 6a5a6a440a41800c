"""Anchor-row selection for the serving tails (pose keypoints, segment coefficients).

Port of `yolo_infer_tpu/ops/select.py` `select_anchor_rows` as a plain
gather. The JAX package's one-hot contraction only dodges the TPU's
narrow-row gather and picks the same rows exactly.
"""

from __future__ import annotations

import torch


def select_anchor_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `x[b, idx[b, k], :]` as (B, K, D).

    x: (B, A, D) per-batch grid, or (A, D) shared across the batch (anchor
    point / stride tables). idx: (B, K) integer.
    """
    idx = idx.long()
    if x.dim() == 2:
        return x[idx]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
