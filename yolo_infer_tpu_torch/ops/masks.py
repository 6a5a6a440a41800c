"""Segment mask assembly on the device.

Port of `yolo_infer_tpu/ops/masks.py`. The device serving modes take the
ultralytics `process_mask(upsample=True).gt_(0.5)` order — sigmoid of the
prototype x coefficient product, cropped to each box at prototype
resolution, bilinearly upsampled, thresholded at 0.5 — with the binary
masks bit-packed MSB-first along W, so the device-to-host copy is 32x
smaller than f32 masks. At full size (ratio 4) the upsample, threshold and
pack are kernel D (`ops/kernels/mask_pack.py`); the half-size variant
(`mask_mode="device_half"`, ratio 2) runs the plain version. The host
unpacks with `np.unpackbits`. The host-finished modes stop at prototype
resolution: `assemble_mask_bits` (thresholded, packed) and
`assemble_masks_q8` (soft, uint8); the predictor upsamples on the host.

The product runs on the unsplit (n, Hm, Wm) masks in one `torch.bmm`: the
JAX package's even/odd column split only avoided a TPU lane shuffle.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from yolo_infer_tpu_torch.ops.kernels.mask_pack import upsample4x_threshold_pack

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # MSB-first


def _instance_logits_and_crop(proto: torch.Tensor, coefs: torch.Tensor, boxes_px: torch.Tensor, imgsz: int):
    """The mask logits (prototypes x coefficients) and the box crop at
    prototype resolution, shared by every assembly mode: (B, Hm, Wm, nm)
    prototypes, (B, max_det, nm) coefficients and (B, max_det, 4) xyxy boxes
    in letterboxed pixels -> ((B, max_det, Hm, Wm) f32 logits, bool crop).

    The crop keeps grid cells with x0 <= x < x1 and y0 <= y < y1.
    """
    b, hm, wm, nm = proto.shape
    scale = hm / imgsz
    logits = torch.bmm(coefs.float(), proto.float().reshape(b, hm * wm, nm).transpose(1, 2))
    logits = logits.reshape(b, -1, hm, wm)
    bxs = boxes_px.float() * scale
    ys = torch.arange(hm, dtype=torch.float32, device=proto.device)[:, None]
    xs = torch.arange(wm, dtype=torch.float32, device=proto.device)[None, :]
    keep = ((xs >= bxs[..., 0, None, None]) & (xs < bxs[..., 2, None, None])
            & (ys >= bxs[..., 1, None, None]) & (ys < bxs[..., 3, None, None]))
    return logits, keep


def soft_masks(proto: torch.Tensor, coefs: torch.Tensor, boxes_px: torch.Tensor, imgsz: int) -> torch.Tensor:
    """sigmoid(proto @ coefs) cropped to each box -> (B, max_det, Hm, Wm) f32.
    The sigmoid and the crop run in place on the product, which is the
    largest tensor of the segment tail."""
    logits, keep = _instance_logits_and_crop(proto, coefs, boxes_px, imgsz)
    return logits.sigmoid_().mul_(keep)


def _bitpack_w(binm: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool -> (..., H, W/8) uint8, MSB-first along W."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=binm.device)  # made on the device: no copy
    grouped = binm.reshape(binm.shape[:-1] + (binm.shape[-1] // 8, 8)).to(torch.int32)
    return (grouped << shifts).sum(dim=-1).to(torch.uint8)


def assemble_mask_bits(proto: torch.Tensor, coefs: torch.Tensor, boxes_px: torch.Tensor, imgsz: int) -> torch.Tensor:
    """Binary cropped masks at prototype resolution, bit-packed along W:
    (B, max_det, Hm, Wm/8) uint8 of `sigmoid(logits) > 0.5` (that is,
    logits > 0) inside each box. The validation comparison's semantic; the
    host upsamples and thresholds again for `mask_mode="bits"`."""
    if proto.shape[2] % 8:
        raise ValueError(f"proto width {proto.shape[2]} not a multiple of 8 (imgsz must be a multiple of 32)")
    logits, keep = _instance_logits_and_crop(proto, coefs, boxes_px, imgsz)
    return _bitpack_w((logits > 0) & keep)


def assemble_masks_q8(proto: torch.Tensor, coefs: torch.Tensor, boxes_px: torch.Tensor, imgsz: int) -> torch.Tensor:
    """Soft cropped masks at prototype resolution, quantized to uint8:
    (B, max_det, Hm, Wm) of round(sigmoid(logits) * 255) inside each box
    (half to even, as `jnp.round`). The host divides by 255, upsamples the
    floats and leaves the threshold to the caller (`mask_mode="q8"`)."""
    logits, keep = _instance_logits_and_crop(proto, coefs, boxes_px, imgsz)
    return (torch.round(logits.sigmoid_() * 255.0) * keep).to(torch.uint8)


def _phase_taps(m: torch.Tensor, r: int, dim: int) -> Iterator[torch.Tensor]:
    """The r phases of a bilinear upsample by the integer ratio r along `dim`
    (half-pixel centres, clamped edges): output index i*r + k is
    w0*m[i-1] + w1*m[i] or w0*m[i] + w1*m[i+1] with the phase offset
    (k + 0.5)/r - 0.5, each product rounded, as the JAX package computes it."""
    n = m.shape[dim]
    s_m1 = torch.cat([m.narrow(dim, 0, 1), m.narrow(dim, 0, n - 1)], dim=dim)
    s_p1 = torch.cat([m.narrow(dim, 1, n - 1), m.narrow(dim, n - 1, 1)], dim=dim)
    for k in range(r):
        off = (k + 0.5) / r - 0.5
        if off < 0:
            yield (-off) * s_m1 + (1.0 + off) * m
        else:
            yield (1.0 - off) * m + off * s_p1


def _upsample_threshold_pack(soft: torch.Tensor, r: int, thresh: float = 0.5) -> torch.Tensor:
    """(n, h, w) f32 -> (n, r*h, r*w/8) uint8 of
    `bilinear_upsample_rx(soft) > thresh`, packed MSB-first along W, for an
    integer ratio r that divides 8. The plain version of kernel D (r = 4) and
    the `device_half` path (r = 2).

    The upsampled image is never built: each (H-phase, W-phase) pair is
    thresholded at source resolution, and bit j of output byte B is W-phase
    j % r of source column B*(8/r) + j//r.
    """
    n, h, w = soft.shape
    if 8 % r:
        raise ValueError(f"upsample ratio {r} must divide 8")
    cpb = 8 // r  # source columns per output byte
    if w % cpb:
        raise ValueError(f"width {w} is not a multiple of {cpb}")
    rows = []
    for rowk in _phase_taps(soft, r, dim=1):  # H-phase kh: (n, h, w)
        bits = [(c > thresh) for c in _phase_taps(rowk, r, dim=2)]
        byte = torch.zeros((n, h, w // cpb), dtype=torch.int32, device=soft.device)
        for j in range(8):
            byte += bits[j % r].reshape(n, h, w // cpb, cpb)[..., j // r].to(torch.int32) * _BIT_WEIGHTS[j]
        rows.append(byte.to(torch.uint8))
    return torch.stack(rows, dim=2).reshape(n, r * h, r * w // 8)  # row r*i + kh <- phase kh of row i


def assemble_mask_bits_up(
    proto: torch.Tensor,  # (B, Hm, Wm, nm)
    coefs: torch.Tensor,  # (B, max_det, nm)
    boxes_px: torch.Tensor,  # (B, max_det, 4) xyxy in letterboxed pixels
    imgsz: int,
    out_size: Optional[int] = None,
) -> torch.Tensor:
    """Serving masks on the device: sigmoid -> crop (prototype resolution) ->
    bilinear upsample to (out_size, out_size) -> > 0.5 -> bit-pack along W.
    -> (B, max_det, out_size, out_size/8) uint8. `out_size` defaults to
    `imgsz`; `imgsz // 2` is the `device_half` variant. Kernel D takes the
    full-size case (ratio 4), as the JAX package's Pallas gate does; the
    batch goes through it in one launch."""
    b, hm, wm, _ = proto.shape
    out = int(out_size) if out_size else imgsz
    if out % 8:
        raise ValueError(f"mask out_size {out} not a multiple of 8")
    ratio = out // hm
    if not (ratio >= 1 and out == ratio * hm and out == ratio * wm and 8 % ratio == 0):
        raise ValueError(f"mask out_size {out} is not 1, 2, 4 or 8 times the prototype grid {hm}x{wm}")
    soft = soft_masks(proto, coefs, boxes_px, imgsz)
    md = soft.shape[1]
    soft = soft.reshape(b * md, hm, wm)
    if out == imgsz and ratio == 4:
        packed = upsample4x_threshold_pack(soft)
    else:
        packed = _upsample_threshold_pack(soft, ratio)
    return packed.reshape(b, md, out, out // 8)


def unpack_mask_bits(packed: np.ndarray) -> np.ndarray:
    """(..., H, W/8) uint8 -> (..., H, W) bool (host side)."""
    return np.unpackbits(np.asarray(packed, np.uint8), axis=-1).astype(bool)


_BIT_REPEAT_LUT: dict = {}


def _bit_repeat_lut(s: int) -> np.ndarray:
    """(256, s) uint8: byte v -> s bytes that repeat each bit of v s times (MSB-first)."""
    if s not in _BIT_REPEAT_LUT:
        bits = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1)
        _BIT_REPEAT_LUT[s] = np.packbits(bits.repeat(s, axis=1), axis=1)
    return _BIT_REPEAT_LUT[s]


def repeat_mask_bits(packed: np.ndarray, s: int) -> np.ndarray:
    """Nearest-neighbour s-x upsample in the packed bit domain:
    (..., H, B) uint8 -> (..., s*H, s*B), each source bit an s x s block.
    Equal to unpack -> repeat -> pack, on the 8x smaller packed bytes; s must
    divide 8 (`device_half` reads with s = 2)."""
    if s == 1:
        return packed
    if 8 % s:
        raise ValueError(f"bit-repeat factor {s} must divide 8")
    out = _bit_repeat_lut(s)[packed]  # (..., H, B, s)
    out = out.reshape(packed.shape[:-1] + (packed.shape[-1] * s,))
    return out.repeat(s, axis=-2)
