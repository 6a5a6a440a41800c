"""YOLO11 building blocks as `nn.Module`s.

Port of `yolo_infer_tpu/models/blocks.py`: Conv, DWConv, Bottleneck, C3k,
C3k2, SPPF, Attention, PSABlock, C2PSA and the heads Detect, Segment (with
Proto), Pose, OBB and Classify. Submodules carry the ultralytics names
(`conv`/`bn`, `cv1`, `m.{j}`, `ffn.0`, `cv3.{i}.0.0`, `cv4.{i}.2`,
`proto.upsample`, `linear`, ...) so an ultralytics-named state dict loads
with `load_state_dict` (`models/convert.py`). Activations are NCHW inside the
blocks.

Under an active `QuantContext` (`nn/quantize.py`) a quantized `Conv` takes
and gives `QAct` (int8 codes and a scale) and the blocks route them as the
JAX package's blocks do: max-pool, split, concat and upsample on the codes,
residual adds in float, every float layer dequantizing its QAct input.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolo_infer_tpu_torch.nn import quantize as Q

from yolo_infer_tpu_torch.nn.layers import (
    BN_EPS,
    BN_MOMENTUM,
    adaptive_avg_pool,
    autopad,
    bn_scale_bias,
    fold_batchnorm,
    max_pool,
    silu,
)
from yolo_infer_tpu_torch.ops.kernels.attention_fused import attention_packed, attention_qkv
from yolo_infer_tpu_torch.ops.kernels.int8_conv import int8_conv, nhwc_input


def _cast(t, dtype: torch.dtype):
    return None if t is None else t.to(dtype)


def _conv_in_input_dtype(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` on `x` with its weights cast to `x`'s dtype (the JAX package
    casts a conv's weights to its input's dtype: under static8 an f32 model
    carries the bf16 outputs of exempted convs)."""
    return F.conv2d(x, conv.weight.to(x.dtype), _cast(conv.bias, x.dtype), conv.stride, conv.padding,
                    conv.dilation, conv.groups)


def _q_maxpool(x, k: int):
    """Max-pool that stays int8 on a QAct: a per-tensor scale keeps the
    order, so pooling the codes is exact. torch has no int8 max-pool on the
    card; the codes are exact in bf16."""
    if isinstance(x, Q.QAct):
        return Q.QAct(max_pool(x.q.to(torch.bfloat16), k).to(torch.int8), x.s)
    return max_pool(x, k)


class Conv(nn.Module):
    """Conv2d (k//2 padding, groups) -> batch norm -> optional SiLU.

    In eval mode the batch norm applies its running statistics. In training
    mode (`module.train()`, the train step's forward) it normalises with the
    batch's own statistics, as `yolo_infer_tpu/nn/layers.py conv_block` does
    with `training=True`: mean and biased variance in f32, scale and bias
    applied in the activation dtype. The running statistics are not touched:
    the batch's (mean, unbiased variance) are left in `batch_stats` for
    `YOLO11.forward` to return as values, so that a step the finite guard
    drops can keep the old ones (`core/train_step.py`).

    `fold()` merges the batch norm into the conv's weight and bias in place
    (the deploy form); afterwards `bn` is None. `quantize()` turns a folded
    conv into the int8 deploy form: `conv` becomes None and the buffers
    `w_q` (int8 weights as (Co, k*k*Ci) rows, the (Co, k, k, Ci) layout of
    kernel E), `w_scale` (f32 per Co) and `b` (f32 bias) take its place.
    """

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k), groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act
        self.k, self.s, self.g = k, s, g
        self.batch_stats = None

    @property
    def quantized(self) -> bool:
        return self.conv is None

    def forward(self, x):
        if self.quantized:
            return self._forward_int8(x)
        if isinstance(x, Q.QAct):  # float conv fed by an int8 edge
            x = x.dequant(self.conv.weight.dtype)
        ctx = Q.current_context()
        if ctx is not None and ctx.mode == "observe":
            ctx.observe(x)
        if ctx is not None and ctx.mode == "fake":
            y = self._fake_quant_conv(x, ctx)
        else:
            y = self.conv(x) if x.dtype == self.conv.weight.dtype else _conv_in_input_dtype(self.conv, x)
        if self.bn is not None:
            if self.training:
                var, mean = torch.var_mean(y.float(), dim=(0, 2, 3), correction=0)
                n = y.numel() // y.shape[1]
                self.batch_stats = (mean.detach(), var.detach() * (n / max(n - 1, 1)))  # torch's running_var rule
            else:
                mean, var = self.bn.running_mean, self.bn.running_var
            scale, bias = bn_scale_bias(self.bn.weight, self.bn.bias, mean, var)
            y = y * scale.to(y.dtype)[:, None, None] + bias.to(y.dtype)[:, None, None]
        return silu(y) if self.act else y

    def _fake_quant_conv(self, x: torch.Tensor, ctx: Q.QuantContext) -> torch.Tensor:
        """QAT: the conv on fake-quantized weights (per output channel,
        scale max(|w|, 1e-12) / 127) and input (the context's static scale,
        else the dynamic one), both with straight-through gradients."""
        c = self.conv
        wf = c.weight.float()
        w_scale = torch.clamp(wf.detach().abs().amax(dim=(1, 2, 3)), min=1e-12) / Q.INT8_MAX
        w = Q.fake_quantize(wf, w_scale[:, None, None, None]).to(x.dtype)
        s = ctx.next_scale() if ctx.act_scales is not None else Q.dynamic_act_scale(x)
        x = Q.fake_quantize(x.float(), s).to(x.dtype)
        return F.conv2d(x, w, _cast(c.bias, x.dtype), c.stride, c.padding, c.dilation, c.groups)

    @torch.no_grad()
    def fold(self) -> None:
        if self.bn is None:
            return
        bn = self.bn
        w, b = fold_batchnorm(self.conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        self.conv.weight = nn.Parameter(w)
        self.conv.bias = nn.Parameter(b)
        self.bn = None

    @torch.no_grad()
    def quantize(self) -> None:
        """The int8 deploy form, from the folded weights in their current
        dtype (`nn/quantize.py quantize_weights_per_channel`)."""
        if self.quantized:
            return
        if self.bn is not None or self.g != 1:
            raise ValueError("only a folded conv with groups 1 quantizes (fold first; depthwise convs stay float)")
        w_q, w_scale = Q.quantize_weights_per_channel(self.conv.weight)
        co = w_q.shape[0]
        self.register_buffer("w_q", w_q.permute(0, 2, 3, 1).reshape(co, -1).contiguous())
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("b", self.conv.bias.detach().float().clone())
        self.conv = None

    def _dequantized_weights(self, dtype: torch.dtype) -> torch.Tensor:
        co = self.w_q.shape[0]
        w_q = self.w_q.view(co, self.k, self.k, -1).permute(0, 3, 1, 2)
        return Q.dequantize_weights(w_q, self.w_scale, dtype)

    def _float_conv(self, x: torch.Tensor) -> torch.Tensor:
        """The conv on the dequantized weights, in `x`'s dtype."""
        y = F.conv2d(x, self._dequantized_weights(x.dtype), None, self.s, self.k // 2)
        y = y + self.b.to(y.dtype)[:, None, None]  # the bias after the conv's rounding, as the JAX package adds it
        return silu(y) if self.act else y

    def _forward_int8(self, x):
        """`nn/layers.py conv_block`'s int8 branch: observe8 records the
        (in, out) absmax of a float conv; static8 takes the next scale pair,
        then runs exempted convs in float and the rest through kernel E. With
        no context (dynamic) or in the legacy static mode the conv takes and
        gives float, through kernel E's float epilogue (`Q.quantized_conv2d`):
        every quantized conv, none exempted."""
        ctx = Q.current_context()
        if ctx is None or ctx.mode not in ("observe8", "static8"):
            x = Q.as_float(x, torch.bfloat16)
            co = self.w_q.shape[0]
            x_scale = ctx.next_scale() if ctx is not None and ctx.mode == "static" else None
            return Q.quantized_conv2d(x, self.w_q.view(co, self.k, self.k, -1), self.w_scale, self.b, stride=self.s,
                                      act=self.act, x_scale=x_scale)
        if ctx.mode == "observe8":
            x_fp = Q.as_float(x, torch.float32)
            y = self._float_conv(x_fp)
            ctx.observe_pair(x_fp, y)
            return y
        idx = ctx.index
        sx, sy = ctx.next_scale_pair()  # taken before the exemption test: exempted convs advance the index too
        co = self.w_q.shape[0]
        ci = self.w_q.shape[1] // (self.k * self.k)
        n, _, h, w = x.shape
        if ctx.exempt(idx, ci, co, n * h * w):
            return self._float_conv(Q.as_float(x, torch.bfloat16))
        if isinstance(x, Q.QAct):
            xq, sx = x.q, x.s  # an int8 edge: no second rounding
        else:
            xq = Q.quantize_act(x, sx).q
        # a channel chunk (q_split2, q_split_at) goes in as a strided view: E reads it in place
        y = int8_conv(nhwc_input(xq), self.w_q.view(co, self.k, self.k, ci),
                      sx * self.w_scale, self.b, ctx.syinv[idx], stride=self.s, act=self.act,
                      epilogue_dtype=ctx.epilogue_dtype or torch.bfloat16)
        return Q.QAct(y.permute(0, 3, 1, 2), sy)


class DWConv(Conv):
    """Depthwise conv: groups = gcd(c1, c2)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, act: bool = True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, k: Tuple[int, int] = (3, 3)):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0])
        self.cv2 = Conv(c_, c2, k[1])
        self.add = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return Q.q_add(x, y) if self.add else y


class C3k(nn.Module):
    def __init__(self, c1: int, c2: int, n: int = 2, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, e=1.0) for _ in range(n)))

    def forward(self, x):
        a = self.cv1(x)
        b = self.cv2(x)  # before the bottlenecks: the order of the JAX DAG, which the scale index follows
        return self.cv3(Q.q_concat([self.m(a), b], 1))


class C3k2(nn.Module):
    def __init__(self, c1: int, c2: int, n: int, c3k: bool, e: float = 0.5, shortcut: bool = True):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut) if c3k else Bottleneck(self.c, self.c, shortcut, e=0.5)
            for _ in range(n)
        )

    def forward(self, x):
        ys = list(Q.q_split2(self.cv1(x), 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(Q.q_concat(ys, 1))


class SPPF(nn.Module):
    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c_ * 4, c2, 1)
        self.k = k

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(_q_maxpool(ys[-1], self.k))
        return self.cv2(Q.q_concat(ys, 1))


ATTN_IMPLS = ("fused", "pallas", "xla")


def attn_impl_choice(impl: str = "auto") -> str:
    """The attention implementation, as `yolo_infer_tpu/models/blocks.py
    _attn_impl` chooses it: an explicit "fused", "pallas" or "xla" wins;
    "auto" reads `YOLO_ATTN_IMPL`, then takes "fused"."""
    if impl in ATTN_IMPLS:
        return impl
    if impl != "auto":
        raise ValueError(f"attn_impl must be 'auto' or one of {ATTN_IMPLS}, got {impl!r}")
    env = os.environ.get("YOLO_ATTN_IMPL", "")
    return env if env in ATTN_IMPLS else "fused"


class Attention(nn.Module):
    """C2PSA multi-head attention over the P5 grid.

    The qkv conv's channels are head-major, [h: q | k | v], and `pe`, a 3x3
    depthwise conv, runs on the v channels of every head. The attention runs
    as `attn_impl_choice(self.impl)` says (`impl` is set by the Predictor):
      "fused"  kernel B (`attention_qkv`) on the (B, N, heads*(2kd+hd)) slab, in place
      "pallas" kernel H (`attention_packed`) on a (B*heads, N, 2kd+hd) head-major copy
      "xla"    plain batched products, the JAX package's einsum form
    The wrappers take their plain versions on a CPU tensor. In training mode
    it is always "xla", as `yolo_infer_tpu/models/blocks.py _attn_impl`
    chooses: kernel B has no backward.
    """

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        h = dim + num_heads * self.key_dim * 2
        self.qkv = Conv(dim, h, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, g=dim, act=False)
        self.impl = "auto"

    def _einsum(self, slab: torch.Tensor) -> torch.Tensor:
        """(B, N, heads*(2kd+hd)) -> (B, N, heads*hd): per (batch, head) f32
        products, f32 softmax rounded to the slab dtype, f32 PV, rounded."""
        b, n, _ = slab.shape
        heads, kd, hd = self.num_heads, self.key_dim, self.head_dim
        x = slab.view(b, n, heads, 2 * kd + hd).transpose(1, 2)  # (B, heads, N, step)
        q, k, v = (x[..., sl].reshape(b * heads, n, -1).float()
                   for sl in (slice(0, kd), slice(kd, 2 * kd), slice(2 * kd, None)))
        attn = torch.softmax(torch.bmm(q, k.transpose(1, 2)) * (kd ** -0.5), dim=-1).to(slab.dtype)
        out = torch.bmm(attn.float(), v).to(slab.dtype)
        return out.view(b, heads, n, hd).transpose(1, 2).reshape(b, n, heads * hd)

    def forward(self, x) -> torch.Tensor:
        b, c, hh, ww = x.shape
        n = hh * ww
        heads, kd, hd = self.num_heads, self.key_dim, self.head_dim
        qkv = self.qkv(x)
        # NHWC rows of the qkv map; a view when `qkv` is channels_last
        slab = qkv.permute(0, 2, 3, 1).reshape(b, n, -1).contiguous()
        impl = "xla" if self.training else attn_impl_choice(self.impl)
        if impl == "fused":
            o = attention_qkv(slab, heads, kd, hd)  # (B, N, heads*hd), head-major
        elif impl == "pallas":
            qg = slab.view(b, n, heads, 2 * kd + hd).transpose(1, 2).reshape(b * heads, n, 2 * kd + hd)
            o = attention_packed(qg, kd, hd).view(b, heads, n, hd).transpose(1, 2).reshape(b, n, heads * hd)
        else:
            o = self._einsum(slab)
        out = o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        v_spatial = slab.reshape(b, n, heads, 2 * kd + hd)[..., 2 * kd:].reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.proj(out + self.pe(v_spatial))


class PSABlock(nn.Module):
    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.attn = Attention(c, num_heads)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))

    def forward(self, x) -> torch.Tensor:
        x = Q.q_add(x, self.attn(x))
        return Q.q_add(x, self.ffn(x))


class C2PSA(nn.Module):
    def __init__(self, c1: int, n: int, e: float = 0.5):
        super().__init__()
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, max(self.c // 64, 1)) for _ in range(n)))

    def forward(self, x):
        a, b = Q.q_split_at(self.cv1(x), self.c, 1)
        return self.cv2(Q.q_concat([a, self.m(b)], 1))


class HeadConv2d(nn.Conv2d):
    """A head branch's output projection (plain conv with bias); a QAct
    input is dequantized to its weight dtype first."""

    def forward(self, x) -> torch.Tensor:
        x = Q.as_float(x, self.weight.dtype)
        return super().forward(x) if x.dtype == self.weight.dtype else _conv_in_input_dtype(self, x)


def detect_branch_channels(ch: Sequence[int], nc: int, reg_max: int) -> Tuple[int, int]:
    c2 = max(16, ch[0] // 4, reg_max * 4)
    c3 = max(ch[0], min(nc, 100))
    return c2, c3


class Detect(nn.Module):
    """Decoupled anchor-free detect head: a DFL box branch (cv2) and a
    depthwise class branch (cv3) per level, concatenated [box | cls]."""

    def __init__(self, nc: int, ch: Sequence[int], reg_max: int = 16):
        super().__init__()
        c2, c3 = detect_branch_channels(ch, nc, reg_max)
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(c, c2, 3), Conv(c2, c2, 3), HeadConv2d(c2, 4 * reg_max, 1)) for c in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(
                nn.Sequential(DWConv(c, c, 3), Conv(c, c3, 1)),
                nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)),
                HeadConv2d(c3, nc, 1),
            )
            for c in ch
        )

    def forward(self, xs: List[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        """{"feats": per-level (B, 4*reg_max + nc, H, W) raw maps}."""
        return {"feats": [torch.cat([self.cv2[i](x), self.cv3[i](x)], 1) for i, x in enumerate(xs)]}


class _DetectPlus(Detect):
    """Detect + a per-level `cv4` branch (Conv 3 -> Conv 3 -> Conv2d 1) whose
    raw maps come out under `key`: mask coefficients (Segment), keypoints
    (Pose) or the angle (OBB)."""

    key = ""

    def __init__(self, nc: int, ch: Sequence[int], reg_max: int, c_out: int):
        super().__init__(nc, ch, reg_max)
        c_mid = max(ch[0] // 4, c_out)
        self.cv4 = nn.ModuleList(
            nn.Sequential(Conv(c, c_mid, 3), Conv(c_mid, c_mid, 3), HeadConv2d(c_mid, c_out, 1)) for c in ch
        )

    def forward(self, xs: List[torch.Tensor]) -> Dict[str, Any]:
        out = super().forward(xs)
        out[self.key] = [self.cv4[i](x) for i, x in enumerate(xs)]
        return out


class Proto(nn.Module):
    """Mask prototypes: Conv 3 -> ConvTranspose2d(2, 2) -> Conv 3 -> Conv 1,
    at twice the P3 resolution (stride 4)."""

    def __init__(self, c1: int, c_: int, nm: int):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, nm)

    def forward(self, x):
        y = Q.as_float(self.cv1(x), self.upsample.weight.dtype)
        up = self.upsample
        y = up(y) if y.dtype == up.weight.dtype else F.conv_transpose2d(
            y, up.weight.to(y.dtype), _cast(up.bias, y.dtype), up.stride, up.padding)
        return self.cv3(self.cv2(y))


class Segment(_DetectPlus):
    """Detect + per-level mask coefficients (`mc`) + prototypes (`proto`)."""

    key = "mc"

    def __init__(self, nc: int, ch: Sequence[int], reg_max: int = 16, nm: int = 32):
        super().__init__(nc, ch, reg_max, nm)
        self.proto = Proto(ch[0], max(ch[0] // 4, nm * 2), nm)

    def forward(self, xs: List[torch.Tensor]) -> Dict[str, Any]:
        out = super().forward(xs)
        out["proto"] = self.proto(xs[0])
        return out


class Pose(_DetectPlus):
    """Detect + per-level raw keypoint maps (`kpts`, K*D channels)."""

    key = "kpts"

    def __init__(self, nc: int, ch: Sequence[int], reg_max: int = 16, kpt_shape: Tuple[int, int] = (17, 3)):
        super().__init__(nc, ch, reg_max, kpt_shape[0] * kpt_shape[1])


class OBB(_DetectPlus):
    """Detect + per-level raw angle maps (`angle`, ne channels)."""

    key = "angle"

    def __init__(self, nc: int, ch: Sequence[int], reg_max: int = 16, ne: int = 1):
        super().__init__(nc, ch, reg_max, ne)


class Classify(nn.Module):
    """Conv 1 to `c_hidden` -> global average pool -> linear -> (B, nc) logits."""

    def __init__(self, c1: int, nc: int, c_hidden: int = 1280):
        super().__init__()
        self.conv = Conv(c1, c_hidden, 1)
        self.linear = nn.Linear(c_hidden, nc)

    def forward(self, x) -> torch.Tensor:
        y = adaptive_avg_pool(Q.as_float(self.conv(x), self.linear.weight.dtype))
        return F.linear(y, self.linear.weight.to(y.dtype), _cast(self.linear.bias, y.dtype))
