"""Greedy-NMS keep mask over a precomputed IoU: the CUDA kernel
`csrc/greedy_nms.cu` and its plain version.

Replaces the TPU kernel `greedy_nms_pallas` (`yolo_infer_tpu/ops/pallas/nms_kernel.py`).
Input: per image, the (K, K) f32 IoU of K score-sorted candidates and a (K,)
validity mask; output: the (K,) greedy keep mask, bit-identical to the
fixpoint sweeps of `ops/nms.py _nms_fixpoint` (`greedy_nms_keep_reference`).
The kernel takes any K up to `MAX_K`; the validation pool is K = 4096.

The kernel reads the IoU threshold from a 0-d f32 tensor on the card
(`nms_walk.threshold_tensor`). The op `torch.ops.yolo_port.greedy_nms_keep`
takes the kernel for a CUDA tensor and the plain version for a CPU tensor;
anything else raises. `greedy_nms_keep` calls it;
`greedy_nms_keep.launches` counts kernel launches (one per call: the bits
pass and the walk).
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from yolo_infer_tpu_torch.ops.kernels._build import check_device, load_library
from yolo_infer_tpu_torch.ops.kernels.nms_walk import launch_keep, threshold_tensor

MAX_K = 8192  # the walk holds the removed set in at most 8 words per lane


def greedy_nms_keep_reference(iou: torch.Tensor, valid: torch.Tensor,
                              iou_thres: Union[float, torch.Tensor]) -> torch.Tensor:
    """Plain version: the greedy fixpoint over the given IoU, per image."""
    from yolo_infer_tpu_torch.ops.nms import _nms_fixpoint

    return _nms_fixpoint(iou, valid, iou_thres, max_sweeps=iou.shape[-1])


def _launcher():
    fn = load_library("greedy_nms").greedy_nms_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def greedy_nms_keep(iou: torch.Tensor, valid: torch.Tensor, iou_thres: Union[float, torch.Tensor]) -> torch.Tensor:
    """(B, K, K) f32 IoU of score-sorted candidates, (B, K) bool, a float or
    0-d f32 threshold -> (B, K) bool keep mask."""
    check_device("greedy_nms_keep", iou)
    return torch.ops.yolo_port.greedy_nms_keep(iou, valid, threshold_tensor(iou_thres, iou.device))


greedy_nms_keep.launches = 0


@torch.library.custom_op("yolo_port::greedy_nms_keep", mutates_args=())
def _greedy_nms_keep_op(iou: torch.Tensor, valid: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    if iou.device.type == "cpu":
        return greedy_nms_keep_reference(iou, valid, thr)
    if iou.device.type != "cuda":
        raise ValueError(f"greedy_nms_keep: no kernel for device {iou.device}")
    _check(iou, valid, thr)
    return launch_keep("greedy_nms_keep", greedy_nms_keep, _launcher, iou, valid, thr)


def _check(iou: torch.Tensor, valid: torch.Tensor, thr: torch.Tensor) -> None:
    """The checks that hold on fake tensors too (no data pointers)."""
    if iou.dtype != torch.float32 or iou.dim() != 3 or iou.shape[1] != iou.shape[2]:
        raise ValueError(f"greedy_nms_keep: iou must be (B, K, K) float32, got {tuple(iou.shape)} {iou.dtype}")
    b, k, _ = iou.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k) or valid.device != iou.device:
        raise ValueError(f"greedy_nms_keep: valid must be ({b}, {k}) bool on {iou.device}")
    if thr.dtype != torch.float32 or thr.dim() != 0 or thr.device != iou.device:
        raise ValueError(f"greedy_nms_keep: the threshold must be a 0-d float32 tensor on {iou.device}")
    if k > MAX_K and iou.device.type == "cuda":
        raise ValueError(f"greedy_nms_keep: K={k} > MAX_K={MAX_K}")


@_greedy_nms_keep_op.register_fake
def _(iou, valid, thr):
    _check(iou, valid, thr)
    return iou.new_empty(iou.shape[:2], dtype=torch.bool)
