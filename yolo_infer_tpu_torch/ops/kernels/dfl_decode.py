"""Full-grid DFL decode: the CUDA kernel `csrc/dfl_decode.cu` and its plain version.

Replaces the TPU kernel `dfl_decode_pallas` (`yolo_infer_tpu/ops/pallas/dfl_kernel.py`).
Input: (B, A, 4*reg_max) bf16 or f32 distribution logits, last dim
contiguous (the kernel reads the strided (B, A, 64) slice of the decode's
head slab in place); output: (B, A, 4) f32, per side
`sum(exp(x - max) * bin) / sum(exp(x - max))`, the TPU kernel's formula.

`dfl_decode` takes the kernel for a CUDA tensor and the plain version for a
CPU tensor; anything else raises. `dfl_decode.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from yolo_infer_tpu_torch.ops.kernels._build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_REG_MAX = 16  # the kernel's lanes cover 4 sides of 16 bins


def dfl_decode_reference(box_dist: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Plain version: the same formula in f32, one reduction per side."""
    x = box_dist.float().reshape(*box_dist.shape[:-1], 4, reg_max)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    bins = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return (e * bins).sum(dim=-1) / e.sum(dim=-1)


def _launcher():
    fn = load_library("dfl_decode").dfl_decode_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dfl_decode(box_dist: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """(B, A, 4*reg_max) logits -> (B, A, 4) f32 expected ltrb distances (in bins)."""
    if box_dist.device.type == "cpu":
        return dfl_decode_reference(box_dist, reg_max)
    if box_dist.device.type != "cuda":
        raise ValueError(f"dfl_decode: no kernel for device {box_dist.device}")
    if reg_max != KERNEL_REG_MAX or box_dist.dim() != 3 or box_dist.shape[-1] != 4 * reg_max:
        raise ValueError(f"dfl_decode: logits must be (B, A, {4 * KERNEL_REG_MAX}) with reg_max "
                         f"{KERNEL_REG_MAX}, got {tuple(box_dist.shape)} reg_max {reg_max}")
    if box_dist.dtype not in _DTYPES:
        raise ValueError(f"dfl_decode: logits must be float32 or bfloat16, got {box_dist.dtype}")
    if box_dist.stride(-1) != 1:
        raise ValueError("dfl_decode: the logits' last dim must be contiguous")
    b, a, _ = box_dist.shape
    out = torch.empty((b, a, 4), dtype=torch.float32, device=box_dist.device)
    if b == 0 or a == 0:
        return out
    with torch.cuda.device(box_dist.device):
        err = _launcher()(box_dist.data_ptr(), out.data_ptr(), _DTYPES[box_dist.dtype], b, a,
                          box_dist.stride(0), box_dist.stride(1), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dfl_decode: CUDA error {err} at launch")
    dfl_decode.launches += 1
    return out


dfl_decode.launches = 0
