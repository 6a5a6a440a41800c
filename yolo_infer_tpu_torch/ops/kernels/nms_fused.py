"""Greedy-NMS keep mask: the CUDA kernel `csrc/nms_fused.cu` and its plain version.

Replaces the TPU kernel `nms_keep_pallas` (`yolo_infer_tpu/ops/pallas/nms_fused.py`).
Input: per image, K score-sorted, class-offset xyxy boxes and a validity
mask; output: the greedy keep mask, bit-identical to the fixpoint over
`box_iou_matrix` (`nms_keep_reference`).

The kernel takes any K up to `MAX_K` (the serving pool is K = 384) and
reads the IoU threshold from a 0-d f32 tensor on the card
(`nms_walk.threshold_tensor`). The op `torch.ops.yolo_port.nms_keep` takes
the kernel for a CUDA tensor and the plain version for a CPU tensor;
anything else raises. Being a custom op, it is one node of an exported
program (`core/exported.py`) and one launch pair of a captured CUDA graph.
`nms_keep` calls it; `nms_keep.launches` counts calls that launched the
kernel (one per call: the IoU bits pass and the walk).
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from yolo_infer_tpu_torch.ops.iou import box_iou_matrix
from yolo_infer_tpu_torch.ops.kernels._build import check_device, load_library
from yolo_infer_tpu_torch.ops.kernels.nms_walk import launch_keep, threshold_tensor

MAX_K = 8192  # the walk holds the removed set in at most 8 words per lane


def nms_keep_reference(cboxes: torch.Tensor, valid: torch.Tensor, iou_thres: Union[float, torch.Tensor]) -> torch.Tensor:
    """Plain version: the greedy fixpoint over `box_iou_matrix`, per image."""
    from yolo_infer_tpu_torch.ops.nms import _nms_fixpoint

    return _nms_fixpoint(box_iou_matrix(cboxes, cboxes), valid, iou_thres, max_sweeps=cboxes.shape[-2])


def _launcher():
    fn = load_library("nms_fused").nms_keep_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nms_keep(cboxes: torch.Tensor, valid: torch.Tensor, iou_thres: Union[float, torch.Tensor]) -> torch.Tensor:
    """(B, K, 4) f32 score-sorted class-offset boxes, (B, K) bool, a float or
    0-d f32 threshold -> (B, K) bool keep mask."""
    check_device("nms_keep", cboxes)
    return torch.ops.yolo_port.nms_keep(cboxes, valid, threshold_tensor(iou_thres, cboxes.device))


nms_keep.launches = 0


@torch.library.custom_op("yolo_port::nms_keep", mutates_args=())
def _nms_keep_op(cboxes: torch.Tensor, valid: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    if cboxes.device.type == "cpu":
        return nms_keep_reference(cboxes, valid, thr)
    if cboxes.device.type != "cuda":
        raise ValueError(f"nms_keep: no kernel for device {cboxes.device}")
    _check(cboxes, valid, thr)
    if cboxes.data_ptr() % 16:
        raise ValueError("nms_keep: boxes must be 16-byte aligned (read as float4)")
    return launch_keep("nms_keep", nms_keep, _launcher, cboxes, valid, thr)


def _check(cboxes: torch.Tensor, valid: torch.Tensor, thr: torch.Tensor) -> None:
    """The checks that hold on fake tensors too (no data pointers)."""
    if cboxes.dtype != torch.float32 or cboxes.dim() != 3 or cboxes.shape[-1] != 4:
        raise ValueError(f"nms_keep: boxes must be (B, K, 4) float32, got {tuple(cboxes.shape)} {cboxes.dtype}")
    b, k, _ = cboxes.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k) or valid.device != cboxes.device:
        raise ValueError(f"nms_keep: valid must be ({b}, {k}) bool on {cboxes.device}")
    if thr.dtype != torch.float32 or thr.dim() != 0 or thr.device != cboxes.device:
        raise ValueError(f"nms_keep: the threshold must be a 0-d float32 tensor on {cboxes.device}")
    if k > MAX_K and cboxes.device.type == "cuda":
        raise ValueError(f"nms_keep: K={k} > MAX_K={MAX_K}")


@_nms_keep_op.register_fake
def _(cboxes, valid, thr):
    _check(cboxes, valid, thr)
    return cboxes.new_empty(cboxes.shape[:2], dtype=torch.bool)
