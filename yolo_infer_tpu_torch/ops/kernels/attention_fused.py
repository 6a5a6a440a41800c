"""C2PSA attention on the raw qkv slab: the CUDA kernel `csrc/attention_fused.cu`
and its plain version.

Replaces the TPU kernel `attention_qkv_fused_pallas`
(`yolo_infer_tpu/ops/pallas/attention_fused.py`). Per batch row and head it
computes softmax(q·kᵀ·kd^-0.5)·v straight from the qkv conv's output,
(B, N, heads·(2kd+hd)) with channels [h: q|k|v], and returns (B, N, heads·hd),
head-major. Products accumulate in f32, the softmax is f32 and exact, and p
is rounded to the slab's dtype before the PV product, as in the JAX kernel.

`attention_qkv` takes the kernel for a CUDA tensor and the plain version for
a CPU tensor; anything else raises. `attention_qkv.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from yolo_infer_tpu_torch.ops.kernels._build import load_library

# the (kd, hd) the kernel is built for: every YOLO11 size has head_dim 64, key_dim 32
KERNEL_DIMS = (32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_qkv_reference(qkv: torch.Tensor, heads: int, kd: int, hd: int) -> torch.Tensor:
    """Plain version: the head-major unpack -> f32 dots -> f32 softmax ->
    round p to the slab dtype -> f32 PV -> round, of `models/blocks.py`'s
    XLA attention path in the JAX package."""
    b, n, _ = qkv.shape
    x = qkv.reshape(b, n, heads, 2 * kd + hd).permute(0, 2, 1, 3)  # (B, heads, N, step)
    q, k, v = x[..., :kd].float(), x[..., kd:2 * kd].float(), x[..., 2 * kd:].float()
    s = torch.matmul(q, k.transpose(-1, -2)) * (kd ** -0.5)
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = torch.matmul(p.float(), v).to(qkv.dtype)  # (B, heads, N, hd)
    return o.permute(0, 2, 1, 3).reshape(b, n, heads * hd)


def _launcher():
    fn = load_library("attention_fused").attn_qkv_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def attention_qkv(qkv: torch.Tensor, heads: int, kd: int, hd: int) -> torch.Tensor:
    """(B, N, heads*(2kd+hd)) slab -> (B, N, heads*hd) attention output."""
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, heads, kd, hd)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_qkv: no kernel for device {qkv.device}")
    if qkv.dtype not in _DTYPE_CODE:
        raise ValueError(f"attention_qkv: dtype {qkv.dtype} not supported (float32, bfloat16)")
    if (kd, hd) != KERNEL_DIMS:
        raise ValueError(f"attention_qkv: the kernel takes (kd, hd)={KERNEL_DIMS}, got ({kd}, {hd})")
    if qkv.dim() != 3 or qkv.shape[-1] != heads * (2 * kd + hd):
        raise ValueError(f"attention_qkv: slab {tuple(qkv.shape)} is not (B, N, {heads}*(2*{kd}+{hd}))")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("attention_qkv: slab must be contiguous and 16-byte aligned (read 16 bytes at a time)")
    b, n, _ = qkv.shape
    out = torch.empty((b, n, heads * hd), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or n == 0:
        return out
    with torch.cuda.device(qkv.device):
        err = _launcher()(qkv.data_ptr(), out.data_ptr(), b, n, heads, kd, hd, kd ** -0.5,
                          _DTYPE_CODE[qkv.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_qkv: CUDA error {err} at launch")
    attention_qkv.launches += 1
    return out


attention_qkv.launches = 0
