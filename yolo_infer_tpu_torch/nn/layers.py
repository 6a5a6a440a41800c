"""NN primitives of the YOLO11 family on NCHW tensors.

Port of `yolo_infer_tpu/nn/layers.py` (the float deploy path only; its
`conv_transpose2x` and `dense` are `nn.ConvTranspose2d(c, c, 2, 2)` and
`nn.Linear` in `models/blocks.py`). The JAX
package keeps activations NHWC with HWIO kernels; inside the port's modules
activations are NCHW (a channels_last view where the caller hands in NHWC)
and kernels OIHW, the layout `torch.nn.functional.conv2d` takes. Public
functions of the port convert at their edges.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# BatchNorm hyperparameters used throughout the YOLO11 family
# (ultralytics Conv uses BatchNorm2d(eps=1e-3, momentum=0.03)).
BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def autopad(k: int, d: int = 1) -> int:
    """Symmetric padding that keeps spatial dims for stride 1 (torch-style)."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2


def max_pool(x: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """Max-pool with k//2 padding; padded cells are -inf, as in the JAX path."""
    return F.max_pool2d(x, k, stride=stride, padding=k // 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (exact integer-factor semantics)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def adaptive_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average pool of an NCHW map -> (N, C)."""
    return x.mean(dim=(2, 3))


def bn_scale_bias(
    gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode batch norm as f32 (scale, bias): y = x * scale + bias."""
    scale = gamma.float() * torch.rsqrt(var.float() + BN_EPS)
    bias = beta.float() - mean.float() * scale
    return scale, bias


def fold_batchnorm(
    w: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BN running stats into an OIHW conv weight and a bias.

    w' = w * gamma/sqrt(var+eps), b' = beta - mean*gamma/sqrt(var+eps),
    computed in f32 and returned in the weight's dtype.
    """
    scale, bias = bn_scale_bias(gamma, beta, mean, var)
    wf = w.float() * scale[:, None, None, None]  # broadcast over O (first axis of OIHW)
    return wf.to(w.dtype), bias.to(w.dtype)
