"""Greedy probIoU-NMS keep mask: the CUDA kernel `csrc/rotated_nms_fused.cu`
and its plain version.

Replaces the TPU kernel `rotated_nms_keep_pallas`
(`yolo_infer_tpu/ops/pallas/nms_fused.py`). Input: per image, K score-sorted,
class-offset oriented boxes as their Gaussian terms (x, y, a, b, c) and a
validity mask; output: the greedy keep mask, bit-identical to the fixpoint
over the probIoU matrix of those terms (`rotated_nms_keep_reference`).

The kernel takes any K up to `MAX_K` (the OBB serving pool is K = 1024,
`Predictor(pre_topk=...)` raises it). `rotated_nms_keep` takes the kernel for
a CUDA tensor and the plain version for a CPU tensor; anything else raises.
`rotated_nms_keep.launches` counts calls that launched the kernel (one per
call: the probIoU bits pass and the walk).
"""

from __future__ import annotations

import ctypes

import torch

from yolo_infer_tpu_torch.ops.kernels._build import load_library

MAX_K = 8192  # the walk holds the removed set in at most 8 words per lane


def rotated_nms_keep_reference(gauss: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Plain version: the greedy fixpoint over `probiou_gauss_matrix`, per image."""
    from yolo_infer_tpu_torch.ops.nms import _nms_fixpoint
    from yolo_infer_tpu_torch.ops.rotated import probiou_gauss_matrix

    return _nms_fixpoint(probiou_gauss_matrix(gauss, gauss), valid, iou_thres, max_sweeps=gauss.shape[-2])


def _launcher():
    fn = load_library("rotated_nms_fused").rotated_nms_keep_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rotated_nms_keep(gauss: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """(B, K, 5) f32 score-sorted Gaussian terms, (B, K) bool -> (B, K) bool keep mask."""
    if gauss.device.type == "cpu":
        return rotated_nms_keep_reference(gauss, valid, iou_thres)
    if gauss.device.type != "cuda":
        raise ValueError(f"rotated_nms_keep: no kernel for device {gauss.device}")
    if gauss.dtype != torch.float32 or gauss.dim() != 3 or gauss.shape[-1] != 5:
        raise ValueError(f"rotated_nms_keep: terms must be (B, K, 5) float32, got {tuple(gauss.shape)} {gauss.dtype}")
    b, k, _ = gauss.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k) or valid.device != gauss.device:
        raise ValueError(f"rotated_nms_keep: valid must be ({b}, {k}) bool on {gauss.device}")
    if not (gauss.is_contiguous() and valid.is_contiguous()):
        raise ValueError("rotated_nms_keep: terms and valid must be contiguous")
    if k > MAX_K:
        raise ValueError(f"rotated_nms_keep: K={k} > MAX_K={MAX_K}")
    keep = torch.empty((b, k), dtype=torch.bool, device=gauss.device)
    if b == 0 or k == 0:
        return keep
    bits = torch.empty((b, k, (k + 31) // 32), dtype=torch.int32, device=gauss.device)
    with torch.cuda.device(gauss.device):
        err = _launcher()(gauss.data_ptr(), valid.data_ptr(), keep.data_ptr(), bits.data_ptr(),
                          b, k, float(iou_thres), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rotated_nms_keep: CUDA error {err} at launch")
    rotated_nms_keep.launches += 1
    return keep


rotated_nms_keep.launches = 0
