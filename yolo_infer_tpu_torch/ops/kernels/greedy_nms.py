"""Greedy-NMS keep mask over a precomputed IoU: the CUDA kernel
`csrc/greedy_nms.cu` and its plain version.

Replaces the TPU kernel `greedy_nms_pallas` (`yolo_infer_tpu/ops/pallas/nms_kernel.py`).
Input: per image, the (K, K) f32 IoU of K score-sorted candidates and a (K,)
validity mask; output: the (K,) greedy keep mask, bit-identical to the
fixpoint sweeps of `ops/nms.py _nms_fixpoint` (`greedy_nms_keep_reference`).
The kernel takes any K up to `MAX_K`; the validation pool is K = 4096.

`greedy_nms_keep` takes the kernel for a CUDA tensor and the plain version
for a CPU tensor; anything else raises. `greedy_nms_keep.launches` counts
kernel launches (one per call: the bits pass and the walk).
"""

from __future__ import annotations

import ctypes

import torch

from yolo_infer_tpu_torch.ops.kernels._build import load_library

MAX_K = 8192  # the walk holds the removed set in at most 8 words per lane


def greedy_nms_keep_reference(iou: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Plain version: the greedy fixpoint over the given IoU, per image."""
    from yolo_infer_tpu_torch.ops.nms import _nms_fixpoint

    return _nms_fixpoint(iou, valid, iou_thres, max_sweeps=iou.shape[-1])


def _launcher():
    fn = load_library("greedy_nms").greedy_nms_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def greedy_nms_keep(iou: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """(B, K, K) f32 IoU of score-sorted candidates, (B, K) bool -> (B, K) bool keep mask."""
    if iou.device.type == "cpu":
        return greedy_nms_keep_reference(iou, valid, iou_thres)
    if iou.device.type != "cuda":
        raise ValueError(f"greedy_nms_keep: no kernel for device {iou.device}")
    if iou.dtype != torch.float32 or iou.dim() != 3 or iou.shape[1] != iou.shape[2]:
        raise ValueError(f"greedy_nms_keep: iou must be (B, K, K) float32, got {tuple(iou.shape)} {iou.dtype}")
    b, k, _ = iou.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k) or valid.device != iou.device:
        raise ValueError(f"greedy_nms_keep: valid must be ({b}, {k}) bool on {iou.device}")
    if not (iou.is_contiguous() and valid.is_contiguous()):
        raise ValueError("greedy_nms_keep: iou and valid must be contiguous")
    if k > MAX_K or b > 65535:
        raise ValueError(f"greedy_nms_keep: K={k} > {MAX_K} or B={b} > 65535")
    keep = torch.empty((b, k), dtype=torch.bool, device=iou.device)
    if b == 0 or k == 0:
        return keep
    bits = torch.empty((b, k, (k + 31) // 32), dtype=torch.int32, device=iou.device)
    with torch.cuda.device(iou.device):
        err = _launcher()(iou.data_ptr(), valid.data_ptr(), keep.data_ptr(), bits.data_ptr(),
                          b, k, float(iou_thres), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"greedy_nms_keep: CUDA error {err} at launch")
    greedy_nms_keep.launches += 1
    return keep


greedy_nms_keep.launches = 0
