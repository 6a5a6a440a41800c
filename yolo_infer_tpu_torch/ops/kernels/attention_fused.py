"""C2PSA attention: the CUDA kernels of `csrc/attention_fused.cu` and their plain versions.

Replaces the TPU kernel `attention_qkv_fused_pallas`
(`yolo_infer_tpu/ops/pallas/attention_fused.py`). Per batch row and head it
computes softmax(q·kᵀ·kd^-0.5)·v straight from the qkv conv's output,
(B, N, heads·(2kd+hd)) with channels [h: q|k|v], and returns (B, N, heads·hd),
head-major. Products accumulate in f32, the softmax is f32 and exact, and p
is rounded to the slab's dtype before the PV product, as in the JAX kernel.

`attention_packed` (kernel H) replaces `attention_fused_pallas` in the same
file, the per-(batch·head) kernel behind `YOLO_ATTN_IMPL=pallas`: it takes a
slab packed head-major beforehand, (G, N, 2kd+hd) with G = batch·heads, and
returns (G, N, hd), the same arithmetic with one head per row of the grid.

Each wrapper calls its op (`torch.ops.yolo_port.attention_qkv`,
`torch.ops.yolo_port.attention_packed`), which takes the kernel for a CUDA
tensor and the plain version for a CPU tensor; anything else raises.
`attention_qkv.launches` and `attention_packed.launches` count kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from yolo_infer_tpu_torch.ops.kernels._build import check_device, load_library

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


def attention_packed_reference(qg: torch.Tensor, kd: int, hd: int) -> torch.Tensor:
    """Plain version of H: per row g, f32 dots -> f32 softmax -> round p to
    the slab dtype -> f32 PV -> round, as `_attn_kernel` computes."""
    q, k, v = qg[..., :kd].float(), qg[..., kd:2 * kd].float(), qg[..., 2 * kd:].float()
    s = torch.matmul(q, k.transpose(-1, -2)) * (kd ** -0.5)
    p = torch.softmax(s, dim=-1).to(qg.dtype)
    return torch.matmul(p.float(), v).to(qg.dtype)


def _launcher():
    fn = load_library("attention_fused").attn_qkv_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _packed_launcher():
    fn = load_library("attention_fused").attn_packed_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, slab: torch.Tensor, kd: int, hd: int, width: int) -> None:
    """The checks that hold on fake tensors too (no data pointers); on the
    card, the kernel's."""
    if slab.dim() != 3 or slab.shape[-1] != width:
        raise ValueError(f"{name}: slab {tuple(slab.shape)} does not have the last dim {width}")
    if slab.device.type != "cuda":
        return
    if slab.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {slab.dtype} not supported (float32, bfloat16)")
    if (kd, hd) != KERNEL_DIMS:
        raise ValueError(f"{name}: the kernel takes (kd, hd)={KERNEL_DIMS}, got ({kd}, {hd})")
    if not slab.is_contiguous():
        raise ValueError(f"{name}: slab must be contiguous and 16-byte aligned (read 16 bytes at a time)")


def _check_aligned(name: str, slab: torch.Tensor) -> None:
    if slab.data_ptr() % 16:
        raise ValueError(f"{name}: slab must be contiguous and 16-byte aligned (read 16 bytes at a time)")


def attention_qkv(qkv: torch.Tensor, heads: int, kd: int, hd: int) -> torch.Tensor:
    """(B, N, heads*(2kd+hd)) slab -> (B, N, heads*hd) attention output."""
    check_device("attention_qkv", qkv)
    return torch.ops.yolo_port.attention_qkv(qkv, heads, kd, hd)


attention_qkv.launches = 0


@torch.library.custom_op("yolo_port::attention_qkv", mutates_args=())
def _attention_qkv_op(qkv: torch.Tensor, heads: int, kd: int, hd: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, heads, kd, hd)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_qkv: no kernel for device {qkv.device}")
    _check("attention_qkv", qkv, kd, hd, heads * (2 * kd + hd))
    _check_aligned("attention_qkv", qkv)
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


@_attention_qkv_op.register_fake
def _(qkv, heads, kd, hd):
    _check("attention_qkv", qkv, kd, hd, heads * (2 * kd + hd))
    return qkv.new_empty((qkv.shape[0], qkv.shape[1], heads * hd))


def attention_packed(qg: torch.Tensor, kd: int, hd: int) -> torch.Tensor:
    """(G, N, 2kd+hd) head-major packed slab -> (G, N, hd) attention output (kernel H)."""
    check_device("attention_packed", qg)
    return torch.ops.yolo_port.attention_packed(qg, kd, hd)


attention_packed.launches = 0


@torch.library.custom_op("yolo_port::attention_packed", mutates_args=())
def _attention_packed_op(qg: torch.Tensor, kd: int, hd: int) -> torch.Tensor:
    if qg.device.type == "cpu":
        return attention_packed_reference(qg, kd, hd)
    if qg.device.type != "cuda":
        raise ValueError(f"attention_packed: no kernel for device {qg.device}")
    _check("attention_packed", qg, kd, hd, 2 * kd + hd)
    _check_aligned("attention_packed", qg)
    g, n, _ = qg.shape
    out = torch.empty((g, n, hd), dtype=qg.dtype, device=qg.device)
    if g == 0 or n == 0:
        return out
    with torch.cuda.device(qg.device):
        err = _packed_launcher()(qg.data_ptr(), out.data_ptr(), g, n, kd, hd, kd ** -0.5, _DTYPE_CODE[qg.dtype],
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_packed: CUDA error {err} at launch")
    attention_packed.launches += 1
    return out


@_attention_packed_op.register_fake
def _(qg, kd, hd):
    _check("attention_packed", qg, kd, hd, 2 * kd + hd)
    return qg.new_empty((qg.shape[0], qg.shape[1], hd))
