"""YOLO11 building blocks as `nn.Module`s.

Port of `yolo_infer_tpu/models/blocks.py`: Conv, DWConv, Bottleneck, C3k,
C3k2, SPPF, Attention, PSABlock, C2PSA and the heads Detect, Segment (with
Proto), Pose, OBB and Classify. Submodules carry the ultralytics names
(`conv`/`bn`, `cv1`, `m.{j}`, `ffn.0`, `cv3.{i}.0.0`, `cv4.{i}.2`,
`proto.upsample`, `linear`, ...) so an ultralytics-named state dict loads
with `load_state_dict` (`models/convert.py`). Activations are NCHW inside the
blocks.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

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
from yolo_infer_tpu_torch.ops.kernels.attention_fused import attention_qkv


class Conv(nn.Module):
    """Conv2d (k//2 padding, groups) -> batch norm (eval) -> optional SiLU.

    `fold()` merges the batch norm into the conv's weight and bias in place
    (the deploy form); afterwards `bn` is None.
    """

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k), groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.bn is not None:
            scale, bias = bn_scale_bias(self.bn.weight, self.bn.bias, self.bn.running_mean, self.bn.running_var)
            y = y * scale.to(y.dtype)[:, None, None] + bias.to(y.dtype)[:, None, None]
        return silu(y) if self.act else y

    @torch.no_grad()
    def fold(self) -> None:
        if self.bn is None:
            return
        bn = self.bn
        w, b = fold_batchnorm(self.conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        self.conv.weight = nn.Parameter(w)
        self.conv.bias = nn.Parameter(b)
        self.bn = None


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    def __init__(self, c1: int, c2: int, n: int = 2, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class SPPF(nn.Module):
    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c_ * 4, c2, 1)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(max_pool(ys[-1], self.k))
        return self.cv2(torch.cat(ys, 1))


class Attention(nn.Module):
    """C2PSA multi-head attention over the P5 grid.

    The qkv conv's channels are head-major, [h: q | k | v]. The attention
    itself runs on the (B, N, heads*(2kd+hd)) slab, read in place by
    `attention_qkv` (the hand-written kernel on a CUDA tensor); `pe`, a 3x3
    depthwise conv, runs on the v channels of every head.
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        n = hh * ww
        heads, kd, hd = self.num_heads, self.key_dim, self.head_dim
        qkv = self.qkv(x)
        # NHWC rows of the qkv map; a view when `qkv` is channels_last
        slab = qkv.permute(0, 2, 3, 1).reshape(b, n, -1).contiguous()
        o = attention_qkv(slab, heads, kd, hd)  # (B, N, heads*hd), head-major
        out = o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        v_spatial = slab.reshape(b, n, heads, 2 * kd + hd)[..., 2 * kd:].reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.proj(out + self.pe(v_spatial))


class PSABlock(nn.Module):
    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.attn = Attention(c, num_heads)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    def __init__(self, c1: int, n: int, e: float = 0.5):
        super().__init__()
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, max(self.c // 64, 1)) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


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
            nn.Sequential(Conv(c, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1)) for c in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(
                nn.Sequential(DWConv(c, c, 3), Conv(c, c3, 1)),
                nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)),
                nn.Conv2d(c3, nc, 1),
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
            nn.Sequential(Conv(c, c_mid, 3), Conv(c_mid, c_mid, 3), nn.Conv2d(c_mid, c_out, 1)) for c in ch
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(adaptive_avg_pool(self.conv(x)).to(self.linear.weight.dtype))
