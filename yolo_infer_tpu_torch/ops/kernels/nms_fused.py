"""Greedy-NMS keep mask: the CUDA kernel `csrc/nms_fused.cu` and its plain version.

Replaces the TPU kernel `nms_keep_pallas` (`yolo_infer_tpu/ops/pallas/nms_fused.py`).
Input: per image, K score-sorted, class-offset xyxy boxes and a validity
mask; output: the greedy keep mask, bit-identical to the fixpoint over
`box_iou_matrix` (`nms_keep_reference`).

`nms_keep` takes the kernel for a CUDA tensor and the plain version for a
CPU tensor; anything else raises. `nms_keep.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from yolo_infer_tpu_torch.ops.iou import box_iou_matrix
from yolo_infer_tpu_torch.ops.kernels._build import load_library

MAX_K = 1024  # one block per image; the K x ceil(K/32) bitmask fits shared memory


def nms_keep_reference(cboxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Plain version: the greedy fixpoint over `box_iou_matrix`, per image."""
    from yolo_infer_tpu_torch.ops.nms import _nms_fixpoint

    return _nms_fixpoint(box_iou_matrix(cboxes, cboxes), valid, iou_thres, max_sweeps=cboxes.shape[-2])


def _launcher():
    fn = load_library("nms_fused").nms_keep_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nms_keep(cboxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """(B, K, 4) f32 score-sorted class-offset boxes, (B, K) bool -> (B, K) bool keep mask."""
    if cboxes.device.type == "cpu":
        return nms_keep_reference(cboxes, valid, iou_thres)
    if cboxes.device.type != "cuda":
        raise ValueError(f"nms_keep: no kernel for device {cboxes.device}")
    if cboxes.dtype != torch.float32 or cboxes.dim() != 3 or cboxes.shape[-1] != 4:
        raise ValueError(f"nms_keep: boxes must be (B, K, 4) float32, got {tuple(cboxes.shape)} {cboxes.dtype}")
    b, k, _ = cboxes.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k) or valid.device != cboxes.device:
        raise ValueError(f"nms_keep: valid must be ({b}, {k}) bool on {cboxes.device}")
    if not (cboxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep: boxes and valid must be contiguous")
    if cboxes.data_ptr() % 16:
        raise ValueError("nms_keep: boxes must be 16-byte aligned (read as float4)")
    if k > MAX_K:
        raise ValueError(f"nms_keep: K={k} > {MAX_K}")
    keep = torch.empty((b, k), dtype=torch.bool, device=cboxes.device)
    if b == 0 or k == 0:
        return keep
    with torch.cuda.device(cboxes.device):
        err = _launcher()(cboxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                          b, k, float(iou_thres), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms_keep: CUDA error {err} at launch")
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0
