"""Anchor-free DFL box decode.

Port of `yolo_infer_tpu/ops/decode.py` (`make_anchors`, `dfl_expectation`,
`dist2bbox`, `decode_scores_raw`, `anchor_rows_from_idx`, `decode_raw`,
`decode_detections`, `decode_keypoints`). Head maps are NHWC, (B, H, W,
4*reg_max + nc), as in the JAX package.

The full-grid decode (`decode_raw`: validation and OBB serving) takes its f32
DFL from kernel F (`ops/kernels/dfl_decode.py`), which reads the head slab's
logits in place; the select-then-decode serving tail keeps `dfl_expectation`
in the head's dtype on the selected rows, as the JAX package does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from yolo_infer_tpu_torch.ops.kernels.dfl_decode import dfl_decode


def make_anchors(
    feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    grid_cell_offset: float = 0.5,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor points (A, 2) in feature-grid units and per-anchor strides (A, 1)."""
    points, strd = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        strd.append(torch.full((h * w, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(points, dim=0), torch.cat(strd, dim=0)


def dfl_expectation(box_dist: torch.Tensor, reg_max: int = 16, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., 4*reg_max) distribution logits -> (..., 4) expected l,t,r,b distances.

    `dtype` is the softmax compute dtype (the serving path passes the head's
    own dtype); the result is f32."""
    shape = box_dist.shape[:-1]
    logits = box_dist.reshape(*shape, 4, reg_max).to(dtype)
    probs = torch.softmax(logits, dim=-1)
    bins = torch.arange(reg_max, dtype=dtype, device=box_dist.device)
    return torch.matmul(probs, bins).float()


def dist2bbox(dist: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """ltrb distances (..., 4) + anchor points (..., 2) -> xyxy boxes."""
    lt, rb = dist.chunk(2, dim=-1)
    return torch.cat([anchor_points - lt, anchor_points + rb], dim=-1)


def decode_scores_raw(
    feats: List[torch.Tensor],
    nc: int,
    reg_max: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-level class reduction with NO box decode.

    -> (best f32 (B, A) sigmoided, cls f32 (B, A), box_dist (B, A, 4*reg_max)
    in the feats' dtype). The front half of select-then-decode NMS
    (`ops.nms.batched_nms_seldec`), which decodes the selected rows only.
    """
    best_l, cls_l, dist_l = [], [], []
    for f in feats:
        b, h, w, _ = f.shape
        dist_l.append(f[..., : 4 * reg_max].reshape(b, h * w, 4 * reg_max))
        best, cls = f[..., 4 * reg_max:].max(dim=-1)
        best_l.append(best.reshape(b, h * w))
        cls_l.append(cls.reshape(b, h * w))
    best = torch.sigmoid(torch.cat(best_l, dim=1).float())
    cls = torch.cat(cls_l, dim=1).float()
    return best, cls, torch.cat(dist_l, dim=1)


def anchor_rows_from_idx(
    idx: torch.Tensor,
    feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    grid_cell_offset: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor points/strides for selected flat-grid indices, arithmetically.

    idx (B, K) int into the concatenated per-level anchor grid ->
    (anchor_points (B, K, 2) f32, strides (B, K, 1) f32); matches
    `make_anchors` row for row.
    """
    x = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    y = torch.zeros_like(x)
    st = torch.zeros_like(x)
    base = 0
    for (h, w), s in zip(feat_shapes, strides):
        in_level = (idx >= base) & (idx < base + h * w)
        li = idx - base
        x = torch.where(in_level, (li % w).float() + grid_cell_offset, x)
        y = torch.where(in_level, torch.div(li, w, rounding_mode="floor").float() + grid_cell_offset, y)
        st = torch.where(in_level, torch.full_like(st, float(s)), st)
        base += h * w
    return torch.stack([x, y], dim=-1), st[..., None]


def decode_raw(
    feats: List[torch.Tensor],
    nc: int,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-level maps -> (ltrb dist (B, A, 4) f32, scores (B, A, nc) f32
    sigmoided, anchor points (A, 2), strides (A, 1)).

    The front half of the full-grid box decode; OBB combines the distances
    with its decoded angle (`ops.rotated.dist2rbox`). The DFL is kernel F
    (`dfl_decode`) on the card, its plain version on the CPU.
    """
    if feats[0].shape[-1] != 4 * reg_max + nc:
        raise ValueError(f"head channels {feats[0].shape[-1]} != 4*reg_max+nc = {4 * reg_max + nc}")
    anchor_points, strd = make_anchors([(f.shape[1], f.shape[2]) for f in feats], strides, device=feats[0].device)
    b = feats[0].shape[0]
    flat = torch.cat([f.reshape(b, -1, f.shape[-1]) for f in feats], dim=1)
    dist = dfl_decode(flat[..., : 4 * reg_max], reg_max)
    scores = torch.sigmoid(flat[..., 4 * reg_max:].float())
    return dist, scores, anchor_points, strd


def decode_detections(
    feats: List[torch.Tensor],
    nc: int,
    reg_max: int = 16,
    strides: Sequence[int] = (8, 16, 32),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level maps -> (boxes xyxy (B, A, 4) f32 in letterboxed pixels,
    scores (B, A, nc) f32 sigmoided): the validation program's decode, with
    the DFL in f32."""
    dist, scores, anchor_points, strd = decode_raw(feats, nc, reg_max, strides)
    return dist2bbox(dist, anchor_points[None]) * strd[None], scores


def decode_keypoints(
    kpts_flat: torch.Tensor,
    anchor_points: torch.Tensor,
    strd: torch.Tensor,
    kpt_shape: Tuple[int, int] = (17, 3),
) -> torch.Tensor:
    """Raw keypoint rows (B, A, K*D) -> (B, A, K, D) image coordinates
    (and sigmoided visibility when D == 3).

    `anchor_points` / `strd` are the grid tables (A, 2) / (A, 1) or per-row
    selections (B, A, 2) / (B, A, 1): the serving tail decodes only the
    max_det selected rows.
    """
    b, a, _ = kpts_flat.shape
    k, d = kpt_shape
    y = kpts_flat.reshape(b, a, k, d).float()
    ap = anchor_points if anchor_points.dim() == 3 else anchor_points[None]
    st = strd if strd.dim() == 3 else strd[None]
    xy = (y[..., :2] * 2.0 + (ap[:, :, None, :] - 0.5)) * st[:, :, None, :]
    if d == 3:
        return torch.cat([xy, torch.sigmoid(y[..., 2:3])], dim=-1)
    return xy
