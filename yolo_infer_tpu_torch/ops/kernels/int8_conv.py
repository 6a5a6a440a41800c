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

The input may be a channel chunk of a wider NHWC tensor (a pixel pitch P
greater than Ci, as `q_split2` / `q_split_at` leave it): the kernel reads it
in place. `nhwc_input` gives a static8 conv's input in that form, copying
only where the layout or the alignment does not fit.

`int8_conv` calls the op `torch.ops.yolo_port.int8_conv`, which takes the
kernel for CUDA tensors and the plain version for CPU tensors; anything
else raises. The op takes the input view as it is (its pixel pitch kept).
`int8_conv.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from yolo_infer_tpu_torch.ops.kernels._build import check_device, load_library

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


def pixel_pitch(x: torch.Tensor) -> Optional[int]:
    """The pitch P >= Ci at which (B, H, W, Ci) `x` holds element (b, y, x, c)
    at ((b*H + y)*W + x)*P + c from its first element, or None."""
    b, h, w, ci = x.shape
    if x.is_contiguous():
        return ci
    p = x.stride(2)
    want = (h * w * p, w * p, p, 1)
    if p >= ci and all(n == 1 or s == t for n, s, t in zip(x.shape, x.stride(), want)):
        return p
    return None


def _vec_ok(x: torch.Tensor, p: int, first_byte: int) -> bool:
    """The 16-byte (cp.async) path's alignment: Ci % 16 == 0 takes it and
    needs the pitch and the first element (at `first_byte`) 16-byte aligned."""
    return x.shape[3] % 16 != 0 or (p % 16 == 0 and first_byte % 16 == 0)


def nhwc_input(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) int8 codes -> (B, H, W, C) for `int8_conv`: a view where
    the kernel reads it in place (channels_last codes, or a channel chunk of
    them), else a contiguous copy. The first element's alignment is read
    from the view's storage offset (a storage starts 16-byte aligned: the
    caching allocator's blocks are 512-byte aligned), which a traced
    program knows too, as it knows no data pointer."""
    v = x.permute(0, 2, 3, 1)
    p = pixel_pitch(v)
    return v if p is not None and _vec_ok(v, p, v.storage_offset() * v.element_size()) else v.contiguous()


def _launcher():
    fn = load_library("int8_conv").int8_conv_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10  # x, w, scale, bias, out; B H W Ci P Ho Wo Co k stride
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])  # syinv, act, epilogue, stream
    fn.restype = ctypes.c_int
    return fn


def int8_conv(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              syinv: float, *, stride: int = 1, act: bool = True,
              epilogue_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x_q (B, H, W, Ci) int8 (contiguous, or with a pixel pitch: see
    `pixel_pitch`), w_q (Co, k, k, Ci) int8, scale and bias (Co,) f32, syinv
    the f32 value 1/sy -> (B, Ho, Wo, Co) int8; all but x_q contiguous."""
    check_device("int8_conv", x_q)
    return torch.ops.yolo_port.int8_conv(x_q, w_q, scale, bias, float(syinv), stride, act, epilogue_dtype)


int8_conv.launches = 0


@torch.library.custom_op("yolo_port::int8_conv", mutates_args=())
def _int8_conv_op(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                  syinv: float, stride: int, act: bool, epilogue_dtype: torch.dtype) -> torch.Tensor:
    if x_q.device.type == "cpu":
        return int8_conv_reference(x_q, w_q, scale, bias, syinv, stride=stride, act=act,
                                   epilogue_dtype=epilogue_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_conv: no kernel for device {x_q.device}")
    b, ho, wo, co = _check(x_q, w_q, scale, bias, stride, epilogue_dtype)
    p = pixel_pitch(x_q)
    if not _vec_ok(x_q, p, x_q.data_ptr()) or (x_q.shape[3] % 16 == 0 and w_q.data_ptr() % 16):
        raise ValueError(f"int8_conv: Ci={x_q.shape[3]} takes the 16-byte path, which needs the pixel pitch ({p}) "
                         f"and the input and weight pointers 16-byte aligned")
    _, h, w, ci = x_q.shape
    k = w_q.shape[1]
    out = torch.empty((b, ho, wo, co), dtype=torch.int8, device=x_q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x_q.device):
        err = _launcher()(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                          bias.data_ptr() if bias is not None else None, out.data_ptr(),
                          b, h, w, ci, p, ho, wo, co, k, stride, float(syinv), int(act), _EPILOGUES[epilogue_dtype],
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_conv: CUDA error {err} at launch")
    int8_conv.launches += 1
    return out


def _check(x_q, w_q, scale, bias, stride: int, epilogue_dtype: torch.dtype):
    """The kernel's checks that hold on fake tensors too (no data pointers);
    returns the output's (B, Ho, Wo, Co)."""
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
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("int8_conv: weights, scale and bias must be contiguous")
    if pixel_pitch(x_q) is None:
        raise ValueError(f"int8_conv: x {tuple(x_q.shape)} with strides {x_q.stride()} is not NHWC with a pixel pitch")
    b, h, w, _ = x_q.shape
    pad = k // 2
    return b, (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1, co


@_int8_conv_op.register_fake
def _(x_q, w_q, scale, bias, syinv, stride, act, epilogue_dtype):
    if x_q.device.type == "cpu":  # the plain version takes what F.conv2d takes
        k = w_q.shape[1]
        b, h, w, _ = x_q.shape
        shape = (b, (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1, w_q.shape[0])
    else:
        shape = _check(x_q, w_q, scale, bias, stride, epilogue_dtype)
    return x_q.new_empty(shape, dtype=torch.int8)
