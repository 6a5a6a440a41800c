"""Static8 int8 convolution: the CUDA kernel `csrc/int8_conv.cu` (kernel E) and its plain version.

Replaces the TPU kernel `int8_conv3x3_fused` (`yolo_infer_tpu/ops/pallas/int8_conv.py`),
whose arithmetic is that of the JAX static8 conv (`yolo_infer_tpu/nn/layers.py
conv_block`): an int8 conv with exact int32 sums, then per output channel
`acc * scale` (scale = sx * w_scale), `+ bias`, SiLU, `* (1 / sy)`, round half
to even, clip to ±127, int8. One launch is one whole static8 conv, for
kernel size 1 or 3 and stride 1 or 2 (k // 2 zero padding, exact since the
zero point is 0), int8 NHWC in and int8 NHWC out.

The epilogue runs in f32 (the TPU kernel's arithmetic) or in bf16, where
the f32 rescale is rounded to bf16 and the bias add, SiLU and `* (1 / sy)`
each round to bf16, as the static8 path computes by default. SiLU is the
JAX package's `y * sigmoid(y)` with sigmoid `1 / (1 + exp(-y))`; in bf16
every one of its operations rounds to bf16 (exp, the sum, the reciprocal,
the product), as XLA evaluates a bf16 sigmoid on the CPU.

`int8_conv` takes the kernel for CUDA tensors and the plain version for CPU
tensors; anything else raises. `int8_conv.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from yolo_infer_tpu_torch.ops.kernels._build import load_library

_EPILOGUES = {torch.float32: 0, torch.bfloat16: 1}


def int8_conv_reference(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                        syinv: float, *, stride: int = 1, act: bool = True,
                        epilogue_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version. The conv is F.conv2d in float64 on the int8 values,
    which is exact (the largest sum, 127² · 9 · 1024, is far below 2⁵³);
    the epilogue follows in the kernel's order of operations."""
    k = w_q.shape[1]
    acc = F.conv2d(x_q.permute(0, 3, 1, 2).double(), w_q.permute(0, 3, 1, 2).double(),
                   stride=stride, padding=k // 2).permute(0, 2, 3, 1)
    ed = epilogue_dtype
    y = (acc.float() * scale).to(ed)
    if bias is not None:
        y = y + bias.to(ed)
    if act:
        y = y * torch.reciprocal(1.0 + torch.exp(-y))
    y = y * torch.tensor(syinv, dtype=torch.float32, device=y.device).to(ed)
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8).contiguous()


def _launcher():
    fn = load_library("int8_conv").int8_conv_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9  # x, w, scale, bias, out; B H W Ci Ho Wo Co k stride
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])  # syinv, act, epilogue, stream
    fn.restype = ctypes.c_int
    return fn


def int8_conv(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              syinv: float, *, stride: int = 1, act: bool = True,
              epilogue_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x_q (B, H, W, Ci) int8, w_q (Co, k, k, Ci) int8, scale and bias (Co,)
    f32, syinv the f32 value 1/sy -> (B, Ho, Wo, Co) int8, all contiguous."""
    if x_q.device.type == "cpu":
        return int8_conv_reference(x_q, w_q, scale, bias, syinv, stride=stride, act=act,
                                   epilogue_dtype=epilogue_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_conv: no kernel for device {x_q.device}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8_conv: input and weights must be int8, got {x_q.dtype} and {w_q.dtype}")
    if x_q.dim() != 4 or w_q.dim() != 4 or w_q.shape[1] != w_q.shape[2] or w_q.shape[3] != x_q.shape[3]:
        raise ValueError(f"int8_conv: want x (B, H, W, Ci) and w (Co, k, k, Ci) with groups 1, got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    k = w_q.shape[1]
    if k not in (1, 3) or stride not in (1, 2):
        raise ValueError(f"int8_conv: the kernel takes k in (1, 3) and stride in (1, 2), got k={k} stride={stride}")
    co = w_q.shape[0]
    if scale.dtype != torch.float32 or scale.shape != (co,) or (
            bias is not None and (bias.dtype != torch.float32 or bias.shape != (co,))):
        raise ValueError(f"int8_conv: scale and bias must be ({co},) float32")
    if epilogue_dtype not in _EPILOGUES:
        raise ValueError(f"int8_conv: epilogue dtype must be float32 or bfloat16, got {epilogue_dtype}")
    tensors = [x_q, w_q, scale] + ([bias] if bias is not None else [])
    if any(t.device != x_q.device for t in tensors):
        raise ValueError("int8_conv: every tensor must be on the input's device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int8_conv: tensors must be contiguous (x NHWC, w (Co, k, k, Ci))")
    b, h, w, ci = x_q.shape
    pad = k // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    out = torch.empty((b, ho, wo, co), dtype=torch.int8, device=x_q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x_q.device):
        err = _launcher()(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                          bias.data_ptr() if bias is not None else None, out.data_ptr(),
                          b, h, w, ci, ho, wo, co, k, stride, float(syinv), int(act), _EPILOGUES[epilogue_dtype],
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_conv: CUDA error {err} at launch")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
