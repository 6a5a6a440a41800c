"""Greedy probIoU-NMS keep mask: the CUDA kernel `csrc/rotated_nms_fused.cu`
and its plain version.

Replaces the TPU kernel `rotated_nms_keep_pallas`
(`yolo_infer_tpu/ops/pallas/nms_fused.py`). Input: per image, K score-sorted,
class-offset oriented boxes as their Gaussian terms (x, y, a, b, c) and a
validity mask; output: the greedy keep mask, bit-identical to the fixpoint
over the probIoU matrix of those terms (`rotated_nms_keep_reference`).

The kernel takes any K up to `MAX_K` (the OBB serving pool is K = 1024,
`Predictor(pre_topk=...)` raises it) and reads the probIoU threshold from a
0-d f32 tensor on the card (`nms_walk.threshold_tensor`). The op
`torch.ops.yolo_port.rotated_nms_keep` takes the kernel for a CUDA tensor
and the plain version for a CPU tensor; anything else raises.
`rotated_nms_keep` calls it; `rotated_nms_keep.launches` counts calls that
launched the kernel (one per call: the probIoU bits pass and the walk).
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from yolo_infer_tpu_torch.ops.kernels._build import check_device, load_library
from yolo_infer_tpu_torch.ops.kernels.nms_walk import launch_keep, threshold_tensor

MAX_K = 8192  # the walk holds the removed set in at most 8 words per lane


def rotated_nms_keep_reference(gauss: torch.Tensor, valid: torch.Tensor,
                               iou_thres: Union[float, torch.Tensor]) -> torch.Tensor:
    """Plain version: the greedy fixpoint over `probiou_gauss_matrix`, per image."""
    from yolo_infer_tpu_torch.ops.nms import _nms_fixpoint
    from yolo_infer_tpu_torch.ops.rotated import probiou_gauss_matrix

    return _nms_fixpoint(probiou_gauss_matrix(gauss, gauss), valid, iou_thres, max_sweeps=gauss.shape[-2])


def _launcher():
    fn = load_library("rotated_nms_fused").rotated_nms_keep_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rotated_nms_keep(gauss: torch.Tensor, valid: torch.Tensor, iou_thres: Union[float, torch.Tensor]) -> torch.Tensor:
    """(B, K, 5) f32 score-sorted Gaussian terms, (B, K) bool, a float or 0-d
    f32 threshold -> (B, K) bool keep mask."""
    check_device("rotated_nms_keep", gauss)
    return torch.ops.yolo_port.rotated_nms_keep(gauss, valid, threshold_tensor(iou_thres, gauss.device))


rotated_nms_keep.launches = 0


@torch.library.custom_op("yolo_port::rotated_nms_keep", mutates_args=())
def _rotated_nms_keep_op(gauss: torch.Tensor, valid: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    if gauss.device.type == "cpu":
        return rotated_nms_keep_reference(gauss, valid, thr)
    if gauss.device.type != "cuda":
        raise ValueError(f"rotated_nms_keep: no kernel for device {gauss.device}")
    _check(gauss, valid, thr)
    return launch_keep("rotated_nms_keep", rotated_nms_keep, _launcher, gauss, valid, thr)


def _check(gauss: torch.Tensor, valid: torch.Tensor, thr: torch.Tensor) -> None:
    """The checks that hold on fake tensors too (no data pointers)."""
    if gauss.dtype != torch.float32 or gauss.dim() != 3 or gauss.shape[-1] != 5:
        raise ValueError(f"rotated_nms_keep: terms must be (B, K, 5) float32, got {tuple(gauss.shape)} {gauss.dtype}")
    b, k, _ = gauss.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k) or valid.device != gauss.device:
        raise ValueError(f"rotated_nms_keep: valid must be ({b}, {k}) bool on {gauss.device}")
    if thr.dtype != torch.float32 or thr.dim() != 0 or thr.device != gauss.device:
        raise ValueError(f"rotated_nms_keep: the threshold must be a 0-d float32 tensor on {gauss.device}")
    if k > MAX_K and gauss.device.type == "cuda":
        raise ValueError(f"rotated_nms_keep: K={k} > MAX_K={MAX_K}")


@_rotated_nms_keep_op.register_fake
def _(gauss, valid, thr):
    _check(gauss, valid, thr)
    return gauss.new_empty(gauss.shape[:2], dtype=torch.bool)
