"""End-to-end prediction on the card, for every task.

Port of `yolo_infer_tpu/core/predictor.py` (`Predictor.predict`,
`predict_raw`, `_postprocess`, `Results`, `LazyMasks`): uint8 frames ->
device letterbox + /255 -> BN-folded YOLO11 forward -> the task's tail ->
host rescale into `Results`. The tails:

  detect   per-level class max -> select-then-decode NMS (kernel A)
  pose     the detect tail, then the keypoints of the kept rows
  segment  the detect tail, then the masks of the kept rows: sigmoid, crop,
           4x bilinear upsample, threshold, bit-pack (kernel D at full size),
           left on the device until `Results.masks` is read
  obb      full-grid DFL decode (kernel F) with the angle -> probIoU NMS
           (kernel C)
  classify softmax of the logits

With `multi_label=True` (the validation program) detect, pose and segment
take the full-grid f32 decode (kernel F) and `ops.nms.batched_nms`: the
per-anchor top-8 classes, an exact top-`pre_topk` pool, the class-offset IoU
matrix and the greedy keep (kernel G).

With PTQ activation scales (`quant_act_scales`, (n, 2)) the forward of a
quantized model (`models/yolo11.py quantize_model`) runs inside a static8
`QuantContext`: every eligible conv int8 in, int8 out through kernel E.

The predictor runs on `cuda` unless the caller passes `device="cpu"`; with no
card and no explicit device it raises instead of falling back to the CPU.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from yolo_infer_tpu_torch.models.blocks import Attention, attn_impl_choice
from yolo_infer_tpu_torch.models.spec import ModelSpec
from yolo_infer_tpu_torch.models.yolo11 import YOLO11, cast_model, fold_model
from yolo_infer_tpu_torch.nn.quantize import QuantContext, quant_context
from yolo_infer_tpu_torch.ops.decode import (
    decode_detections,
    decode_keypoints,
    decode_raw,
    decode_scores_raw,
    make_anchors,
)
from yolo_infer_tpu_torch.ops.letterbox import (
    crop_letterbox_slices,
    letterbox,
    letterbox_params,
    scale_boxes,
    scale_obb,
)
from yolo_infer_tpu_torch.ops.masks import assemble_mask_bits_up, repeat_mask_bits, unpack_mask_bits
from yolo_infer_tpu_torch.ops.nms import _multi_label_topc, batched_nms, batched_nms_seldec
from yolo_infer_tpu_torch.ops.preprocess import preprocess_batch
from yolo_infer_tpu_torch.ops.rotated import batched_rotated_nms, dist2rbox
from yolo_infer_tpu_torch.ops.select import select_anchor_rows
from yolo_infer_tpu_torch.utils.coco_names import COCO_NAMES

# candidate pool of the select-then-decode tail: the smallest 128-multiple
# that still honours the max_det=300 output contract (the JAX serve pool)
SERVE_POOL = 384
MASK_MODES = ("device", "device_half")
_UNPORTED_MASK_MODES = ("q8", "bits", "exact", "auto")


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """`cuda` when no device is named; raises if there is no card then."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


@dataclass
class Results:
    """Per-image detection results in original-image pixel coordinates."""

    boxes: np.ndarray  # (n, 4) xyxy
    scores: np.ndarray  # (n,)
    classes: np.ndarray  # (n,) int32
    orig_shape: Tuple[int, int]  # (h, w)
    names: Dict[int, str] = field(default_factory=lambda: dict(COCO_NAMES))
    speed: Dict[str, float] = field(default_factory=dict)
    keypoints: Optional[np.ndarray] = None  # (n, K, 3) pose
    masks: Optional[Any] = None  # (n, H, W) segment: LazyMasks
    probs: Optional[np.ndarray] = None  # (nc,) classify
    obb: Optional[np.ndarray] = None  # (n, 5) cx, cy, w, h, rad oriented boxes

    def __len__(self) -> int:
        return int(self.boxes.shape[0])


class LazyMasks:
    """Serving masks that stay on the device until read.

    Holds image `index` of the batch's bit-packed (B, max_det, grid, grid/8)
    uint8 tensor (`ops/masks.py assemble_mask_bits_up`; grid is imgsz for
    `mask_mode="device"`, imgsz/2 for `"device_half"`) and behaves like the
    (n, ch, cw) float32 array of binary {0, 1} masks over the letterbox's
    content region. The first read copies the content band of the n real
    rows to the host and unpacks it; `prefetch` does that for many images
    with one copy per batch tensor.
    """

    def __init__(self, packed_dev: torch.Tensor, index: int, n: int, ratio: float, pad, orig_shape, imgsz: int):
        self._dev: Optional[torch.Tensor] = packed_dev
        self._index = index
        self._n = n
        self._ratio, self._pad, self._orig_shape, self._imgsz = ratio, pad, orig_shape, imgsz
        grid = int(packed_dev.shape[2])
        if imgsz % grid:
            raise ValueError(f"mask grid {grid} does not divide imgsz {imgsz}")
        self._scale = imgsz // grid
        self._np: Optional[np.ndarray] = None

    def _content(self) -> Tuple[int, int, int, int]:
        """(y0, x0, ch, cw) of the content region at full resolution."""
        y0, x0, ch, cw = crop_letterbox_slices(self._ratio, self._pad, self._orig_shape, downsample=1)
        return y0, x0, min(ch, self._imgsz - y0), min(cw, self._imgsz - x0)

    def _crop_window(self):
        """(gy0, gh, xb0, xb1, trim): the device window in grid rows and byte
        columns that covers the content region, and the full-resolution
        `trim = (r0, ch, c0, cw)` applied after unpacking."""
        y0, x0, ch, cw = self._content()
        s = self._scale
        gy0 = y0 // s
        gh = -(-(y0 + ch) // s) - gy0
        gx0 = x0 // s
        gx1 = -(-(x0 + cw) // s)
        xb0, xb1 = gx0 // 8, -(-gx1 // 8)
        return gy0, gh, xb0, xb1, (y0 - gy0 * s, ch, x0 - xb0 * 8 * s, cw)

    def _finish(self, packed: np.ndarray, trim, dtype=np.float32) -> None:
        """Unpack a fetched (n, gh, bytes) window (nearest-upsampled in the
        packed domain when the grid is coarser) and cut the content region."""
        m = unpack_mask_bits(repeat_mask_bits(packed, self._scale))
        r0, ch, c0, cw = trim
        self._np = np.ascontiguousarray(m[:, r0: r0 + ch, c0: c0 + cw].astype(dtype, copy=False))
        self._dev = None  # this image no longer holds the batch tensor

    def numpy(self, dtype=np.float32) -> np.ndarray:
        """The (n, ch, cw) masks; `dtype=np.uint8` skips the float32 cast.
        The first read's dtype is kept."""
        if self._np is None:
            gy0, gh, xb0, xb1, trim = self._crop_window()
            packed = self._dev[self._index, : self._n, gy0: gy0 + gh, xb0:xb1].cpu().numpy()
            self._finish(packed, trim, dtype)
        return self._np

    @staticmethod
    def prefetch(items, dtype=np.float32) -> None:
        """Materialize many LazyMasks with one device-to-host copy per batch
        tensor: the pending images' rows are gathered on the device over the
        union of their content windows, copied once, and split on the host.
        `items` may be Results or LazyMasks; read or non-lazy ones are skipped."""
        groups: Dict[int, List[LazyMasks]] = {}
        for it in items:
            m = it.masks if hasattr(it, "masks") else it
            if isinstance(m, LazyMasks) and m._np is None and m._dev is not None:
                groups.setdefault(id(m._dev), []).append(m)
        for ms in groups.values():
            dev = ms[0]._dev
            wins = [m._crop_window() for m in ms]
            max_n = max(m._n for m in ms)
            uy0 = min(w[0] for w in wins)
            uy1 = max(w[0] + w[1] for w in wins)
            uxb0 = min(w[2] for w in wins)
            uxb1 = max(w[3] for w in wins)
            idx = torch.tensor([m._index for m in ms], device=dev.device)
            block = dev[idx, :max_n, uy0:uy1, uxb0:uxb1].cpu().numpy()  # one copy
            for k, (m, (gy0, gh, xb0, xb1, trim)) in enumerate(zip(ms, wins)):
                sub = block[k, : m._n, gy0 - uy0: gy0 - uy0 + gh, xb0 - uxb0: xb1 - uxb0]
                m._finish(sub, trim, dtype)

    # ---- cheap introspection, no copy ----
    @property
    def shape(self):
        if self._np is not None:
            return self._np.shape
        _, _, ch, cw = self._content()
        return (self._n, ch, cw)

    @property
    def dtype(self):
        return np.float32 if self._np is None else self._np.dtype

    @property
    def ndim(self) -> int:
        return 3

    def __len__(self) -> int:
        return self._n

    # ---- everything else behaves like the materialized ndarray ----
    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None and dtype != a.dtype else a

    def __getitem__(self, item):
        return self.numpy()[item]

    def __iter__(self):
        return iter(self.numpy())

    def __getattr__(self, name):
        # only genuine ndarray API materializes; other probes (.cpu, .to,
        # display hooks) raise without paying the copy
        if name.startswith("_") or not hasattr(np.ndarray, name):
            raise AttributeError(name)
        return getattr(self.numpy(), name)


for _op in ("__ge__", "__gt__", "__le__", "__lt__", "__eq__", "__ne__",
            "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__"):
    def _lazy_delegate(self, other, _op=_op):
        return getattr(self.numpy(), _op)(other)

    setattr(LazyMasks, _op, _lazy_delegate)
del _op, _lazy_delegate


class Predictor:
    """Serving over a `YOLO11` model of any task.

    `params` is the port's `YOLO11` module (from `build_model`,
    `models.convert.load_state_dict` or `params_from_jax`); the predictor
    serves a copy of it with the batch norms folded, cast to
    `compute_dtype` and on the device. The caller's module is left as it
    was, as the JAX package leaves its `params`.

    `mask_mode` (segment): "device" (the default) thresholds the masks at
    full resolution on the device; "device_half" on the imgsz/2 grid, which
    the host nearest-upsamples on read (<= 1 px boundary error, 4x fewer
    bytes to copy). In both, `Results.masks` is a `LazyMasks` over the device
    tensor. The host-finished modes "q8", "bits" and "exact" (and the JAX
    package's "auto" choice between modes) are not ported (ROADMAP Queue 1
    item 5).

    `quant_act_scales` ((n, 2) PTQ absmax pairs, as
    `optimization/quantization/quantizers.py` calibrates them) serve a
    quantized model in static8; `quant_min_channels` overrides the int8
    eligibility threshold (a value above 1024 keeps every conv float:
    weight-only int8). `attn_impl` ("auto", "fused", "pallas", "xla") picks
    the C2PSA attention (`models/blocks.py attn_impl_choice`).
    """

    def __init__(
        self,
        params: YOLO11,
        spec: ModelSpec,
        *,
        device: Union[None, str, torch.device] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        pre_topk: int = 1024,
        max_det: int = 300,
        names: Optional[Dict[int, str]] = None,
        mask_mode: str = "device",
        quant_act_scales: Any = None,
        quant_min_channels: Optional[int] = None,
        attn_impl: str = "auto",
    ):
        _check_mask_mode(mask_mode)
        attn_impl_choice(attn_impl)  # raises on an unknown name
        self.device = resolve_device(device)
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.pre_topk = pre_topk
        self.max_det = max_det
        self.mask_mode = mask_mode
        self.names = names or dict(COCO_NAMES)
        model = cast_model(fold_model(copy.deepcopy(params)), compute_dtype).to(self.device).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        for m in model.modules():
            if isinstance(m, Attention):
                m.impl = attn_impl
        self.model = model
        self.quant_act_scales = (None if quant_act_scales is None
                                 else torch.as_tensor(np.asarray(quant_act_scales), dtype=torch.float32))
        self.quant_min_channels = quant_min_channels

    def _forward(self, x: torch.Tensor) -> Dict[str, Any]:
        """The model forward, inside a static8 context when PTQ scales exist."""
        if self.quant_act_scales is None:
            return self.model(x)
        kw = {} if self.quant_min_channels is None else {"int8_min_channels": int(self.quant_min_channels)}
        with quant_context(QuantContext("static8", act_scales=self.quant_act_scales, **kw)) as ctx:
            out = self.model(x)
        if ctx.index != len(self.quant_act_scales):
            raise ValueError(f"the model ran {ctx.index} quantized convs for {len(self.quant_act_scales)} scale pairs")
        return out

    @torch.inference_mode()
    def predict_raw(self, images_u8: torch.Tensor, conf: float, iou: float, imgsz: int,
                    max_det: Optional[int] = None, *, multi_label: bool = False, pre_topk: Optional[int] = None,
                    mask_out: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) uint8 frames on the device -> the fixed-shape dets
        dict, left on the device: boxes (B, max_det, 4) xyxy, or (B, max_det,
        5) xywhr for obb, in letterboxed pixels; scores, classes, valid, num,
        anchor_idx; plus "kpts" (B, max_det, K, 3) for pose and
        "mask_bits_up" (B, max_det, grid, grid/8) uint8 for segment. Classify
        gives {"probs": (B, nc)}. `multi_label` takes the validation NMS
        (`ops.nms.batched_nms`) over the full-grid decode; `pre_topk`
        overrides the predictor's candidate cap (the validator asks for
        4096). `mask_out` overrides `mask_mode`; "none" skips the masks."""
        spec = self.spec
        md = max_det or self.max_det
        pool = pre_topk or self.pre_topk
        x = preprocess_batch(images_u8, out_hw=(imgsz, imgsz), dtype=self.compute_dtype)
        out = self._forward(x)
        if spec.task == "classify":
            return {"probs": torch.softmax(out["logits"], dim=-1)}
        feats = out["feats"]
        b = feats[0].shape[0]
        if spec.task == "obb":
            ang = torch.cat([a.reshape(b, -1, a.shape[-1]) for a in out["angle"]], dim=1)
            angle = (torch.sigmoid(ang.float()[..., 0]) - 0.25) * math.pi  # (B, A)
            dist, scores, ap, st = decode_raw(feats, spec.nc, spec.reg_max, spec.strides)
            rb = dist2rbox(dist, angle, ap[None]) * st[None]  # (B, A, 4) px
            rboxes = torch.cat([rb, angle[..., None]], dim=-1)
            return batched_rotated_nms(rboxes, scores, conf, iou, pre_topk=pool, max_det=md,
                                       multi_label=multi_label)
        if multi_label:
            boxes, scores = decode_detections(feats, spec.nc, spec.reg_max, spec.strides)
            dets = batched_nms(boxes, scores, conf, iou, pre_topk=pool, max_det=md, multi_label=True,
                               multi_label_topc=_multi_label_topc())
        else:
            best, cls, dist = decode_scores_raw(feats, spec.nc, spec.reg_max)
            dets = batched_nms_seldec(
                dist, best, cls, conf, iou,
                feat_shapes=tuple((f.shape[1], f.shape[2]) for f in feats),
                strides=tuple(spec.strides), reg_max=spec.reg_max,
                pre_topk=min(pool, SERVE_POOL), max_det=md,
            )
        if spec.task == "pose":
            kflat = torch.cat([k.reshape(b, -1, k.shape[-1]) for k in out["kpts"]], dim=1)
            ap, st = make_anchors([(f.shape[1], f.shape[2]) for f in feats], spec.strides, device=kflat.device)
            sel = dets["anchor_idx"]
            apst = select_anchor_rows(torch.cat([ap, st], dim=-1), sel)
            dets["kpts"] = decode_keypoints(select_anchor_rows(kflat, sel), apst[..., :2], apst[..., 2:],
                                            spec.kpt_shape)
        elif spec.task == "segment":
            mode = mask_out or self.mask_mode
            if mode != "none":
                _check_mask_mode(mode)
                mc = torch.cat([m.reshape(b, -1, m.shape[-1]) for m in out["mc"]], dim=1)
                coefs = select_anchor_rows(mc, dets["anchor_idx"])  # (B, max_det, nm)
                dets["mask_bits_up"] = assemble_mask_bits_up(
                    out["proto"].float(), coefs, dets["boxes"], imgsz,
                    out_size=imgsz // 2 if mode == "device_half" else None,
                )
        return dets

    def predict(
        self,
        images: Union[np.ndarray, Sequence[np.ndarray]],
        conf: float = 0.25,
        iou: float = 0.45,
        imgsz: int = 640,
        multi_label: bool = False,
        max_det: Optional[int] = None,
    ) -> List[Results]:
        """images: uint8 RGB HWC array(s). Returns one Results per image.
        `multi_label` takes the validation NMS (see `predict_raw`)."""
        if not isinstance(images, np.ndarray) and len(images) == 0:
            return []
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = [images]
        host_lb: Optional[List[Tuple[float, Tuple[float, float]]]] = None
        if isinstance(images, np.ndarray):
            batch_np = images
            orig_shapes = [tuple(images.shape[1:3])] * images.shape[0]
        else:
            orig_shapes = [tuple(im.shape[:2]) for im in images]
            if len(set(orig_shapes)) != 1:
                # mixed sizes: letterbox on the host into one square batch;
                # the device letterbox is then an identity pass
                lb = [letterbox(im, imgsz) for im in images]
                batch_np = np.stack([l[0] for l in lb], axis=0)
                host_lb = [(l[1], l[2]) for l in lb]
            else:
                batch_np = np.stack(images, axis=0)

        t0 = time.perf_counter()
        frames = torch.from_numpy(np.ascontiguousarray(batch_np)).to(self.device)
        dets = self.predict_raw(frames, conf, iou, imgsz, max_det, multi_label=multi_label)
        dev_masks = dets.pop("mask_bits_up", None)  # stays on the device (LazyMasks)
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        dt = (time.perf_counter() - t0) * 1000
        return self._postprocess(dets, dev_masks, orig_shapes, host_lb, imgsz, tuple(batch_np.shape[1:3]), dt)

    def _postprocess(
        self,
        dets: Dict[str, np.ndarray],
        dev_masks: Optional[torch.Tensor],
        orig_shapes: List[Tuple[int, int]],
        host_lb: Optional[List[Tuple[float, Tuple[float, float]]]],
        imgsz: int,
        batch_hw: Tuple[int, int],
        dt: float,
    ) -> List[Results]:
        """Host-side assembly of Results from the synced fixed-shape dets dict."""
        batch_n = len(orig_shapes)
        speed = {"inference": dt / batch_n}
        if self.spec.task == "classify":
            return [Results(boxes=np.zeros((0, 4), np.float32), scores=np.zeros((0,), np.float32),
                            classes=np.zeros((0,), np.int32), orig_shape=orig_shapes[i], names=self.names,
                            probs=dets["probs"][i], speed=speed) for i in range(batch_n)]
        if host_lb is None:
            ratio0, pad0, _ = letterbox_params(batch_hw, imgsz)
        results: List[Results] = []
        for i in range(batch_n):
            ratio, pad = host_lb[i] if host_lb is not None else (ratio0, pad0)
            shape = orig_shapes[i]
            n = int(dets["num"][i])
            obb = None
            if dets["boxes"].shape[-1] == 5:  # oriented boxes
                obb = scale_obb(dets["boxes"][i, :n], ratio, pad)
                boxes = _obb_to_xyxy(obb, shape)
            else:
                boxes = scale_boxes(dets["boxes"][i, :n], ratio, pad, shape)
            kpts = None
            if "kpts" in dets:
                kpts = dets["kpts"][i, :n].copy()  # (n, K, 3)
                kpts[..., 0] = (kpts[..., 0] - pad[0]) / ratio
                kpts[..., 1] = (kpts[..., 1] - pad[1]) / ratio
            masks = LazyMasks(dev_masks, i, n, ratio, pad, shape, imgsz) if dev_masks is not None and n else None
            results.append(Results(
                boxes=boxes, scores=dets["scores"][i, :n], classes=dets["classes"][i, :n].astype(np.int32),
                orig_shape=shape, names=self.names, keypoints=kpts, masks=masks, obb=obb, speed=speed,
            ))
        return results


def _check_mask_mode(mode: str) -> None:
    if mode in _UNPORTED_MASK_MODES:
        raise NotImplementedError(f"mask_mode {mode!r} is not ported yet (ROADMAP Queue 1 item 5); "
                                  f"use one of {MASK_MODES}")
    if mode not in MASK_MODES:
        raise ValueError(f"mask_mode must be one of {MASK_MODES}, got {mode!r}")


def _obb_to_xyxy(obb: np.ndarray, shape_hw) -> np.ndarray:
    """Axis-aligned envelope of rotated boxes (for `.boxes`), clipped to the image."""
    cx, cy, w, h, r = (obb[:, i] for i in range(5))
    cos, sin = np.abs(np.cos(r)), np.abs(np.sin(r))
    ex = (w * cos + h * sin) / 2
    ey = (w * sin + h * cos) / 2
    out = np.stack([cx - ex, cy - ey, cx + ex, cy + ey], axis=1)
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, shape_hw[1])
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, shape_hw[0])
    return out.astype(np.float32)
