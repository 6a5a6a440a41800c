"""Fused 4x upsample + threshold + bit-pack of soft masks: the CUDA kernel
`csrc/mask_pack.cu` and its plain version.

Replaces the TPU kernel `upsample4x_threshold_pack`
(`yolo_infer_tpu/ops/pallas/mask_pack.py`). Input: (n, Hm, Wm) f32 soft masks
(the kernel takes them unsplit; the TPU kernel's even/odd column split only
avoided a lane shuffle); output: (n, 4*Hm, Wm/2) uint8 of
`bilinear_4x(soft) > 0.5` (half-pixel centres, clamped edges), packed
MSB-first along W, bit-identical to `upsample4x_threshold_pack_reference`.

The kernel skips the taps wherever no input near an output word is above
0.5, which leaves the bytes exact (`csrc/mask_pack.cu`).
`upsample4x_threshold_pack` calls the op
`torch.ops.yolo_port.upsample4x_threshold_pack`, which takes the kernel for a
CUDA tensor and the plain version for a CPU tensor; anything else raises.
`upsample4x_threshold_pack.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from yolo_infer_tpu_torch.ops.kernels._build import check_device, load_library


def upsample4x_threshold_pack_reference(soft: torch.Tensor) -> torch.Tensor:
    """Plain version: the phase-decomposed upsample + pack of `ops/masks.py` at ratio 4."""
    from yolo_infer_tpu_torch.ops.masks import _upsample_threshold_pack

    return _upsample_threshold_pack(soft, 4)


def _launcher():
    fn = load_library("mask_pack").mask_pack_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def upsample4x_threshold_pack(soft: torch.Tensor) -> torch.Tensor:
    """(n, Hm, Wm) f32 soft masks -> (n, 4*Hm, Wm/2) uint8 packed binary masks."""
    check_device("upsample4x_threshold_pack", soft)
    return torch.ops.yolo_port.upsample4x_threshold_pack(soft)


upsample4x_threshold_pack.launches = 0


@torch.library.custom_op("yolo_port::upsample4x_threshold_pack", mutates_args=())
def _upsample4x_threshold_pack_op(soft: torch.Tensor) -> torch.Tensor:
    if soft.device.type == "cpu":
        return upsample4x_threshold_pack_reference(soft)
    if soft.device.type != "cuda":
        raise ValueError(f"upsample4x_threshold_pack: no kernel for device {soft.device}")
    _check(soft)
    if not soft.is_contiguous() or soft.data_ptr() % 16:
        raise ValueError("upsample4x_threshold_pack: soft masks must be contiguous and 16-byte aligned "
                         "(rows are read as float4)")
    n, h, w = soft.shape
    out = torch.empty((n, 4 * h, w // 2), dtype=torch.uint8, device=soft.device)
    if n == 0 or h == 0:
        return out
    with torch.cuda.device(soft.device):
        err = _launcher()(soft.data_ptr(), out.data_ptr(), n, h, w, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"upsample4x_threshold_pack: CUDA error {err} at launch")
    upsample4x_threshold_pack.launches += 1
    return out


def _check(soft: torch.Tensor) -> None:
    """The checks that hold on fake tensors too (no data pointers)."""
    if soft.dtype != torch.float32 or soft.dim() != 3:
        raise ValueError(f"upsample4x_threshold_pack: soft masks must be (n, Hm, Wm) float32, "
                         f"got {tuple(soft.shape)} {soft.dtype}")
    if soft.shape[2] % 8:
        raise ValueError(f"upsample4x_threshold_pack: Wm={soft.shape[2]} is not a multiple of 8")


@_upsample4x_threshold_pack_op.register_fake
def _(soft):
    _check(soft)
    n, h, w = soft.shape
    return soft.new_empty((n, 4 * h, w // 2), dtype=torch.uint8)
