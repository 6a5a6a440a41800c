"""End-to-end prediction on the card, for every task.

Port of `yolo_infer_tpu/core/predictor.py` (`Predictor.predict`,
`predict_many`, `predict_raw`, `_postprocess`, `Results`, `LazyMasks`,
`_assemble_masks`): uint8 frames -> device letterbox + /255 -> BN-folded
YOLO11 forward -> the task's tail -> host rescale into `Results`. The tails:

  detect   per-level class max -> select-then-decode NMS (kernel A) over a
           pool of min(pre_topk, 384)
  pose     the detect tail, then the keypoints of the kept rows
  segment  the detect tail, then the masks of the kept rows by `mask_mode`:
           "device" (the default) sigmoid, crop, 4x bilinear upsample,
           threshold, bit-pack (kernel D at full size), left on the device
           until `Results.masks` is read; "device_half" the same on the
           imgsz/2 grid; "q8", "bits" and "exact" stop at prototype
           resolution and the host finishes them; "auto" takes
           "device_half" at imgsz >= 512, "device" below
  obb      full-grid DFL decode (kernel F) with the angle -> probIoU NMS
           (kernel C)
  classify softmax of the logits

With `multi_label=True` (the validation program) detect, pose and segment
take the full-grid f32 decode (kernel F) and `ops.nms.batched_nms`: the
per-anchor top-8 classes, an exact top-`pre_topk` pool, the class-offset IoU
matrix and the greedy keep (kernel G). OBB takes the same pool of (anchor,
class) pairs into `ops.rotated.batched_rotated_nms`, whose keep mask is
kernel C (probIoU inside its bits pass: no (B, K, K) matrix).

With PTQ activation scales (`quant_act_scales`, (n, 2)) the forward of a
quantized model (`models/yolo11.py quantize_model`) runs inside a static8
`QuantContext`: every eligible conv int8 in, int8 out through kernel E.
With 1-D scales it runs the legacy "static" mode, and with none the
"dynamic" one: every quantized conv float in, float out through kernel E's
float epilogue (`nn/quantize.py quantized_conv2d`).

`predict_many` serves a long list in chunks of one batch shape. On the card
the frames go through pinned staging buffers on an upload stream, the
forward runs on a compute stream that waits for each chunk's copy, and the
host drains finished chunks into `Results` while later ones run.

The predictor caches one program per input signature, as the JAX
package's caches one jitted program (`_get`, `_build`, `_cache`; the key is
the JAX key: batch, frame H x W, imgsz, multi_label, max_det, pre_topk,
mask_out, the environment knobs read while the program is built, and the
quantization mode). On the
card a program is `serve_program` captured into a CUDA graph on the
signature's first call (`core/graphs.py`) and replayed by every later call;
on the CPU it is `serve_program` itself, run op by op. A captured graph
keeps its call's peak memory while it lives (a jitted executable does not),
so the cache holds at most `PROGRAM_CACHE_SIZE` programs and releases the
least recently used one to build another; `release_programs` gives them
all back, and the validator releases the program of its run when it ends.

conf and iou reach the kernels as 0-d f32 tensors on the device
(`DevScalarCache`, one per value, written once), never as Python numbers
baked into a launch: an exported program (`core/exported.py`) and a captured
CUDA graph take them as runtime inputs.

The predictor runs on `cuda` unless the caller passes `device="cpu"`; with no
card and no explicit device it raises instead of falling back to the CPU.

With `mesh=` (`parallel/mesh.py create_mesh`, inside an initialized process
group) the predictor serves the JAX meshed predictor's way: each process
holds the whole model on its own device, runs its data rank's contiguous
slice of every batch through its own program (captured per signature as
above), and the slices' results are gathered after the program, outside any
graph (one `all_gather` of their bytes), so `predict`, `predict_raw` and
`predict_many` return the whole batch on every process. A batch that the
data axis does not divide raises `ValueError`, as `jax.device_put` does with
`P("data")`. Each slice goes through the same program as an unmeshed
batch: the select-then-decode tail over min(pre_topk, 384) (kernel A) and
kernel B's attention. The JAX meshed predictor takes the full-grid presel
tail and the "xla" attention instead only because GSPMD partitions those
and not the row select or the Pallas kernels; each process here runs its
own unsharded program, so it keeps one tail.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from yolo_infer_tpu_torch.core.graphs import CapturedProgram
from yolo_infer_tpu_torch.models.blocks import Attention, Conv, attn_impl_choice
from yolo_infer_tpu_torch.models.spec import ModelSpec
from yolo_infer_tpu_torch.models.yolo11 import YOLO11, cast_model, fold_model
from yolo_infer_tpu_torch.nn.quantize import QuantContext, out_scale_inverses, quant_context
from yolo_infer_tpu_torch.ops.decode import (
    decode_detections,
    decode_keypoints,
    decode_raw,
    decode_scores_raw,
    make_anchors,
)
from yolo_infer_tpu_torch.ops.letterbox import (
    crop_letterbox_masks,
    crop_letterbox_slices,
    letterbox,
    letterbox_params,
    resize_linear_f32,
    scale_boxes,
    scale_obb,
)
from yolo_infer_tpu_torch.ops.masks import (
    assemble_mask_bits,
    assemble_mask_bits_up,
    assemble_masks_q8,
    repeat_mask_bits,
    unpack_mask_bits,
)
from yolo_infer_tpu_torch.ops.kernels.nms_walk import threshold_tensor
from yolo_infer_tpu_torch.ops.nms import Threshold, _multi_label_topc, batched_nms, batched_nms_seldec
from yolo_infer_tpu_torch.ops.preprocess import preprocess_batch
from yolo_infer_tpu_torch.ops.rotated import batched_rotated_nms, dist2rbox
from yolo_infer_tpu_torch.ops.select import select_anchor_rows
from yolo_infer_tpu_torch.parallel.mesh import Mesh, gather_batch, shard_batch
from yolo_infer_tpu_torch.utils.coco_names import COCO_NAMES

# candidate pool of the select-then-decode tail: the smallest 128-multiple
# that still honours the max_det=300 output contract (the JAX serve pool)
SERVE_POOL = 384
MASK_MODES = ("auto", "device", "device_half", "q8", "bits", "exact")
# the segment artifacts with one row per detection slot (axis 1), which
# predict_many copies to the host at drain time cut to the chunk's largest count
_MASK_ROW_KEYS = ("mask_bits_up", "mask_q8", "mask_bits", "mask_coefs")


# the environment knobs read while a serving program is built: YOLO_MULTI_LABEL_TOPC
# (`ops/nms.py _multi_label_topc`), YOLO_ATTN_IMPL (`models/blocks.py
# attn_impl_choice`), YOLO_INT8_C64_MIN_ROWS (`nn/quantize.py QuantContext`)
TRACE_ENV = ("YOLO_MULTI_LABEL_TOPC", "YOLO_ATTN_IMPL", "YOLO_INT8_C64_MIN_ROWS")
# the programs a predictor keeps (`Predictor._get`); on the card each holds its
# call's peak memory, from ~0.1 GB (detect b1/640) to 11 GB (validation
# b16/640, its (16, 4096, 4096) IoU)
PROGRAM_CACHE_SIZE = 8


def _trace_env_key() -> Tuple[str, ...]:
    """The values of `TRACE_ENV`, the last part of the program-cache key
    (`Predictor._get`): a knob changed on a live predictor builds a new
    program instead of serving the one built under the old value
    (`yolo_infer_tpu/core/predictor.py _trace_env_key`)."""
    return tuple(os.environ.get(n, "") for n in TRACE_ENV)


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """`cuda` when no device is named; raises if there is no card then."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


class DevScalarCache:
    """Device-resident threshold scalars, made once per (value, device).

    A Python conf or iou becomes a 0-d f32 tensor on the device, written by
    `torch.full` (a fill kernel on the card: no host copy, no
    synchronisation) the first time the value is seen, and reused after.
    Shared by the live `Predictor` and `core/exported.py ExportedPredictor`."""

    def __init__(self):
        self._cache: Dict[Tuple[float, str], torch.Tensor] = {}

    def __call__(self, v: Union[float, torch.Tensor], device: torch.device) -> torch.Tensor:
        if torch.is_tensor(v):
            return threshold_tensor(v, device)
        key = (float(v), str(device))
        if key not in self._cache:
            self._cache[key] = threshold_tensor(key[0], device)
        return self._cache[key]


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
    """Serving masks that stay packed until read.

    Holds image `index` of the batch's bit-packed (B, rows, grid, grid/8)
    uint8 masks (`ops/masks.py assemble_mask_bits_up`; grid is imgsz for
    `mask_mode="device"`, imgsz/2 for `"device_half"`) and behaves like the
    (n, ch, cw) float32 array of binary {0, 1} masks over the letterbox's
    content region. `predict` leaves them on the device: the first read
    copies the content band of the n real rows to the host and unpacks it,
    and `prefetch` does that for many images with one copy per batch tensor.
    `predict_many` hands over a host ndarray already (its rows cut to the
    chunk's largest count), which is only unpacked on read.
    """

    def __init__(self, packed_dev: Union[torch.Tensor, np.ndarray], index: int, n: int, ratio: float, pad,
                 orig_shape, imgsz: int):
        self._dev: Union[None, torch.Tensor, np.ndarray] = packed_dev
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
        self._dev = None  # this image no longer holds the batch's masks

    def numpy(self, dtype=np.float32) -> np.ndarray:
        """The (n, ch, cw) masks; `dtype=np.uint8` skips the float32 cast.
        The first read's dtype is kept."""
        if self._np is None:
            gy0, gh, xb0, xb1, trim = self._crop_window()
            packed = self._dev[self._index, : self._n, gy0: gy0 + gh, xb0:xb1]
            self._finish(packed.cpu().numpy() if torch.is_tensor(packed) else packed, trim, dtype)
        return self._np

    @staticmethod
    def prefetch(items, dtype=np.float32) -> None:
        """Materialize many LazyMasks with one device-to-host copy per batch
        tensor: the pending images' rows are gathered on the device over the
        union of their content windows, copied once, and split on the host.
        `items` may be Results or LazyMasks; read or non-lazy ones are skipped,
        and masks already on the host are unpacked where they are."""
        groups: Dict[int, List[LazyMasks]] = {}
        for it in items:
            m = it.masks if hasattr(it, "masks") else it
            if isinstance(m, LazyMasks) and m._np is None and m._dev is not None:
                if torch.is_tensor(m._dev):
                    groups.setdefault(id(m._dev), []).append(m)
                else:
                    m.numpy(dtype)
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

    `mask_mode` (segment):
      "device" (the default): sigmoid, crop, bilinear upsample to imgsz and
        0.5-threshold on the device (ultralytics `process_mask(upsample=True)
        .gt_(0.5)`), bit-packed; `Results.masks` is a `LazyMasks` over the
        device tensor;
      "device_half": the same, thresholded on the imgsz/2 grid, which the
        host nearest-upsamples on read (<= 1 px boundary error, 4x fewer
        bytes to copy);
      "q8": sigmoid and crop on the device, uint8 soft masks; the host
        upsamples the floats (soft masks within 1/510 of the float order);
      "bits": threshold at prototype resolution on the device, bit-packed;
        the host upsamples and thresholds again;
      "exact": the prototypes and coefficients go to the host, which
        computes the float masks (the parity oracle);
      "auto": "device_half" at imgsz >= 512, "device" below.
    "device", "device_half" and "bits" give binary {0, 1} masks; "q8" and
    "exact" soft sigmoid values, which the caller thresholds.

    `quant_act_scales` ((n, 2) PTQ absmax pairs, as
    `optimization/quantization/quantizers.py` calibrates them) serve a
    quantized model in static8; `quant_min_channels` overrides the int8
    eligibility threshold (a value above 1024 keeps every conv float:
    weight-only int8). `attn_impl` ("auto", "fused", "pallas", "xla") picks
    the C2PSA attention (`models/blocks.py attn_impl_choice`). `mesh` serves
    over the data axis of a process group (see the module docstring).
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
        mesh: Optional[Mesh] = None,
    ):
        _check_mask_mode(mask_mode)
        if mesh is not None:
            mesh.require_groups("a meshed Predictor")
        self.mesh = mesh
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
        # kernel E's 1/sy arguments, read from the scales once here (an exported
        # program bakes them in, and cannot read a tensor back to the host)
        self._quant_syinv = (out_scale_inverses(self.quant_act_scales)
                             if self.quant_act_scales is not None and self.quant_act_scales.dim() == 2 else None)
        self.quant_min_channels = quant_min_channels
        # "static8" ((n, 2) scales), "static" ((n,) scales), "dynamic" (a
        # quantized model without scales) or None (float)
        if self.quant_act_scales is not None:
            self.quant_mode = "static8" if self.quant_act_scales.dim() == 2 else "static"
        else:
            self.quant_mode = "dynamic" if any(isinstance(m, Conv) and m.quantized for m in model.modules()) else None
        # predict_many's upload, compute and download streams, made on first
        # use and kept: memory the caching allocator holds for one stream is
        # not handed to a new one, so fresh streams per call would allocate anew
        self._streams: Optional[Tuple[Any, Any, Any]] = None
        self._dev_scalar = DevScalarCache()
        # program-cache key -> program (`_get`), least recently used first
        self._cache: Dict[Tuple, Any] = {}

    @torch.no_grad()
    def load_weights(self, params: YOLO11) -> None:
        """Serve `params`' weights from now on: folded and cast as `__init__`
        does, then copied into the served module's tensors in place, so the
        programs captured over them (CUDA graphs) read the new weights on
        their next replay. `params` must be a model of this predictor's spec."""
        src = cast_model(fold_model(copy.deepcopy(params)), self.compute_dtype)
        self.model.load_state_dict(src.state_dict())

    def _forward(self, x: torch.Tensor) -> Dict[str, Any]:
        """The model forward, inside a static8 or static context when PTQ scales exist."""
        if self.quant_act_scales is None:
            return self.model(x)
        mode = self.quant_mode
        kw = {} if self.quant_min_channels is None or mode != "static8" else {
            "int8_min_channels": int(self.quant_min_channels)}
        with quant_context(QuantContext(mode, act_scales=self.quant_act_scales, syinv=self._quant_syinv,
                                        **kw)) as ctx:
            out = self.model(x)
        if ctx.index != len(self.quant_act_scales):
            raise ValueError(f"the model ran {ctx.index} quantized convs for {len(self.quant_act_scales)} scale pairs")
        return out

    # -- program cache -------------------------------------------------------

    def _build(self, src_hw: Tuple[int, int], imgsz: int, multi_label: bool, max_det: int, pre_topk: int,
               mask_out: str, batch: int):
        """The program of one signature: `serve_program` with the signature's
        arguments bound, captured into a CUDA graph on the card (warm-up,
        capture; `core/graphs.py`), run eagerly on the CPU."""
        fn = functools.partial(self.serve_program, imgsz=imgsz, max_det=max_det, multi_label=multi_label,
                               pre_topk=pre_topk, mask_out=mask_out)
        if self.device.type != "cuda":
            return fn
        with torch.inference_mode():
            return CapturedProgram(fn, (batch, *src_hw, 3), self.device)

    def _get(self, batch: int, src_hw: Tuple[int, int], imgsz: int, multi_label: bool, max_det: int,
             pre_topk: Optional[int] = None, mask_out: Optional[str] = None):
        """The cached program of a signature, built on its first call. Keyed
        as the JAX package keys its jitted programs: (batch, src_hw, imgsz,
        multi_label, max_det, pre_topk, mask_out, trace env, quant_mode), with pre_topk
        None taken as the predictor's and mask_out None as `mask_mode`, so
        a default and an explicit equal value share one program. A full
        cache releases its least recently used program first."""
        pre_topk = pre_topk or self.pre_topk
        mask_out = mask_out or self.mask_mode
        key = (batch, src_hw, imgsz, multi_label, max_det, pre_topk, mask_out, _trace_env_key(), self.quant_mode)
        program = self._cache.pop(key, None)
        if program is None:
            if len(self._cache) >= PROGRAM_CACHE_SIZE:
                self.release_programs([next(iter(self._cache))])
            program = self._build(src_hw, imgsz, multi_label, max_det, pre_topk, mask_out, batch)
        self._cache[key] = program  # the most recently used last
        return program

    def release_programs(self, keys: Optional[Sequence[Tuple]] = None) -> None:
        """Drop the cached programs of `keys` (all when None) and give their
        graphs' memory back to the card; a later call of such a signature
        captures it again. Results already returned are not affected."""
        dropped = [self._cache.pop(k) for k in (list(self._cache) if keys is None else keys) if k in self._cache]
        captured = [p for p in dropped if isinstance(p, CapturedProgram)]
        for p in captured:
            p.release()
        if captured:
            torch.cuda.empty_cache()

    @contextlib.contextmanager
    def transient_programs(self):
        """Release, when the block ends, the programs built inside it (the
        validator's: its graph holds the multi-label NMS's IoU)."""
        before = set(self._cache)
        try:
            yield
        finally:
            self.release_programs([k for k in self._cache if k not in before])

    def _program(self, images_u8: torch.Tensor, imgsz: int, max_det: Optional[int], multi_label: bool,
                 pre_topk: Optional[int], mask_out: Optional[str]):
        return self._get(images_u8.shape[0], tuple(images_u8.shape[1:3]), imgsz, multi_label,
                         max_det or self.max_det, pre_topk, mask_out)

    # -- serving ---------------------------------------------------------------

    @torch.inference_mode()
    def predict_raw(self, images_u8: torch.Tensor, conf: Threshold, iou: Threshold, imgsz: int,
                    max_det: Optional[int] = None, *, multi_label: bool = False, pre_topk: Optional[int] = None,
                    mask_out: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) uint8 frames on the device -> the fixed-shape dets
        dict, left on the device: boxes (B, max_det, 4) xyxy, or (B, max_det,
        5) xywhr for obb, in letterboxed pixels; scores, classes, valid, num,
        anchor_idx; plus "kpts" (B, max_det, K, 3) for pose and, for segment,
        by mask mode: "mask_bits_up" (B, max_det, grid, grid/8) uint8,
        "mask_q8" (B, max_det, Hm, Wm) uint8, "mask_bits" (B, max_det, Hm,
        Wm/8) uint8, or "mask_coefs" (B, max_det, nm) and "proto" (B, Hm, Wm,
        nm) f32. Classify gives {"probs": (B, nc)}. `multi_label` takes the
        validation NMS (`ops.nms.batched_nms`) over the full-grid decode;
        `pre_topk` overrides the predictor's candidate cap (the validator
        asks for 4096). `mask_out` overrides `mask_mode`; "none" skips the
        masks. `conf` and `iou` are Python numbers or 0-d f32 tensors.

        The signature's program (`_get`) runs it: on the card its first call
        captures a CUDA graph (and waits for the device, as a JAX compile
        blocks), every later call replays it and returns fresh tensors that
        the next call leaves alone. Nothing here waits for the device from a
        signature's second call on."""
        if self.mesh is not None:
            images_u8 = shard_batch(images_u8, self.mesh)
        run = self._program(images_u8, imgsz, max_det, multi_label, pre_topk, mask_out)
        dets = run(images_u8, self._dev_scalar(conf, self.device), self._dev_scalar(iou, self.device))
        return dets if self.mesh is None else gather_batch(dets, self.mesh)

    def serve_program(self, images_u8: torch.Tensor, conf: torch.Tensor, iou: torch.Tensor, imgsz: int,
                      max_det: Optional[int] = None, *, multi_label: bool = False, pre_topk: Optional[int] = None,
                      mask_out: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """The body of `predict_raw`, uncaptured, with conf and iou as 0-d f32
        tensors on the device and no autograd mode of its own: each program
        of the cache captures it (`_build`), and `core/exported.py` traces it
        under `torch.no_grad` (inference tensors do not export)."""
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
                                       multi_label=multi_label, multi_label_topc=_multi_label_topc())
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
                if mode == "auto":
                    mode = "device_half" if imgsz >= 512 else "device"
                mc = torch.cat([m.reshape(b, -1, m.shape[-1]) for m in out["mc"]], dim=1)
                coefs = select_anchor_rows(mc, dets["anchor_idx"])  # (B, max_det, nm)
                proto = out["proto"].float()
                if mode in ("device", "device_half"):
                    dets["mask_bits_up"] = assemble_mask_bits_up(
                        proto, coefs, dets["boxes"], imgsz, out_size=imgsz // 2 if mode == "device_half" else None)
                elif mode == "q8":
                    dets["mask_q8"] = assemble_masks_q8(proto, coefs, dets["boxes"], imgsz)
                elif mode == "bits":
                    dets["mask_bits"] = assemble_mask_bits(proto, coefs, dets["boxes"], imgsz)
                else:  # exact: the host computes the masks
                    dets["mask_coefs"] = coefs.float()
                    dets["proto"] = proto
        return dets

    def _batch(self, images, imgsz: int):
        """(frames (B, H, W, 3) uint8, original (h, w) per image, per-image
        host letterbox (ratio, pad) or None). Frames of mixed sizes are
        letterboxed on the host into one square batch; the device letterbox
        is then an identity pass."""
        if isinstance(images, np.ndarray):
            return images, [tuple(images.shape[1:3])] * images.shape[0], None
        orig_shapes = [tuple(im.shape[:2]) for im in images]
        if len(set(orig_shapes)) == 1:
            return images, orig_shapes, None
        lb = [letterbox(im, imgsz) for im in images]
        return [l[0] for l in lb], orig_shapes, [(l[1], l[2]) for l in lb]

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
        frames, orig_shapes, host_lb = self._batch(images, imgsz)
        batch_np = frames if isinstance(frames, np.ndarray) else np.stack(frames, axis=0)

        t0 = time.perf_counter()
        batch_np = np.ascontiguousarray(batch_np)
        if self.mesh is not None:  # this data rank's slice, cut on the host
            batch_np = shard_batch(batch_np, self.mesh)
        frames_dev = torch.from_numpy(batch_np).to(self.device)
        with torch.inference_mode():
            program = self._program(frames_dev, imgsz, max_det, multi_label, None, None)
            run = program.replay if isinstance(program, CapturedProgram) else program
            dets = dict(run(frames_dev, self._dev_scalar(conf, self.device), self._dev_scalar(iou, self.device)))
            if self.mesh is not None:  # every slice's results, outside the graph
                dets = gather_batch(dets, self.mesh)
            # read before the next replay: the dets to the host, and the mask
            # rows in use (the graph's own tensors) copied on the same stream
            packed = dets.pop("mask_bits_up", None)  # stays on the device (LazyMasks)
            dets = {k: v.cpu().numpy() for k, v in dets.items()}
            if packed is not None:
                packed = packed[:, : int(dets["num"].max(initial=0))].clone()
        dt = (time.perf_counter() - t0) * 1000
        return self._postprocess(dets, packed, orig_shapes, host_lb, imgsz, tuple(batch_np.shape[1:3]), dt)

    def predict_many(
        self,
        images: Sequence[np.ndarray],
        conf: float = 0.25,
        iou: float = 0.45,
        imgsz: int = 640,
        batch_size: int = 32,
        multi_label: bool = False,
        max_det: Optional[int] = None,
        pipeline_depth: int = 2,
    ) -> List[Results]:
        """Chunked, pipelined prediction over a long image list.

        One (batch_size, H, W, 3) batch shape serves the whole list: the last
        chunk is padded by repeating its last frame and the padding is
        trimmed from the Results. Frames of mixed sizes are letterboxed on
        the host first. Up to `pipeline_depth` chunks are in flight while
        the host builds the Results of finished ones.

        Every chunk, the padded last one included, runs the one program of
        the (batch_size, H, W) signature (`_get`), built before the pipeline
        starts: on the card a capture may not overlap the staging thread's
        event waits. A second host thread stacks chunks ahead into their
        staging buffers while this one launches the current chunk. On the
        card: `pipeline_depth + 1` pinned staging buffers, refilled only once
        their last upload has completed; the next chunk is copied on an
        upload stream just before the current chunk's replay, beside its
        kernels; the graph replays on a compute stream that waits for its
        copy's event, and its outputs are cloned there (the next chunk's
        replay overwrites the graph's own); the dets go to pinned host
        tensors without blocking, and the drain waits on that chunk's event
        alone.
        Segment masks are copied at drain time in one transfer of the rows
        the chunk uses, so no device buffer stays held per chunk;
        `LazyMasks` unpacks them from the host on read.

        `Results.speed["inference"]` is pipelined wall time per image (from
        dispatch to drain, so it includes waiting behind chunks in flight):
        a throughput figure; `predict` gives latency.
        """
        if len(images) == 0:
            return []
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        frames, orig_shapes, host_lb = self._batch(list(images), imgsz)
        md = max_det or self.max_det
        n = len(frames)
        frame_hw = tuple(frames[0].shape[:2])
        shape = (batch_size,) + tuple(frames[0].shape)
        cuda = self.device.type == "cuda"
        if self.mesh is not None and batch_size % self.mesh.shape["data"]:
            raise ValueError(f"batch_size {batch_size} is not divisible by the data axis ({self.mesh.shape['data']})")
        local = batch_size if self.mesh is None else batch_size // self.mesh.shape["data"]  # a data rank's slice
        self._get(local, frame_hw, imgsz, multi_label, md)  # on the card: captured here, before the stager
        if cuda:
            if self._streams is None:
                self._streams = tuple(torch.cuda.Stream(self.device) for _ in range(3))
            upload, compute, download = self._streams
            compute.wait_stream(torch.cuda.current_stream(self.device))  # the caller's work on the weights
            staging = [torch.empty(shape, dtype=torch.uint8, pin_memory=True) for _ in range(pipeline_depth + 1)]
            uploaded: List[Optional[torch.cuda.Event]] = [None] * len(staging)
        results: List[Results] = []
        pending: collections.deque = collections.deque()

        def drain_one() -> None:
            host, masks, done, lo, hi, t0 = pending.popleft()
            m = hi - lo
            if done is not None:
                done.synchronize()
            dets = {k: v.numpy()[:m].copy() for k, v in host.items()}
            if masks:
                # one bounded copy of the rows any real image uses
                rows = int(dets["num"].max(initial=0))
                if cuda:
                    download.wait_event(done)
                    with torch.cuda.stream(download):
                        masks = {k: v[:m, :rows].cpu() for k, v in masks.items()}
                dets.update({k: v[:m, :rows].numpy() for k, v in masks.items()})
            packed = dets.pop("mask_bits_up", None)
            dt = (time.perf_counter() - t0) * 1000
            results.extend(self._postprocess(dets, packed, orig_shapes[lo:hi],
                                             None if host_lb is None else host_lb[lo:hi], imgsz, frame_hw, dt))

        starts = list(range(0, n, batch_size))

        def stage(i: int) -> np.ndarray:
            """Chunk i's frames, padded with its last, in its staging buffer
            (on the card a pinned one, once that buffer's last upload is done)."""
            lo, hi = starts[i], min(starts[i] + batch_size, n)
            if cuda:
                slot = i % len(staging)
                if uploaded[slot] is not None:
                    uploaded[slot].synchronize()
                buf = staging[slot].numpy()
            else:
                buf = np.empty(shape, np.uint8)
            np.stack(frames[lo:hi], axis=0, out=buf[: hi - lo])
            buf[hi - lo:] = buf[hi - lo - 1]
            return buf

        def upload_chunk(i: int, buf: np.ndarray) -> torch.Tensor:
            """Chunk i's frames on the device (on the card: copied from its
            staging buffer on the upload stream, its event kept)."""
            if not cuda:
                return torch.from_numpy(buf)
            slot = i % len(staging)
            with torch.cuda.stream(upload):
                frames_dev = staging[slot].to(self.device, non_blocking=True)
                uploaded[slot] = upload.record_event()
            return frames_dev

        # A second thread stacks chunks ahead (numpy copies without the GIL)
        # while this one launches. Chunk i + 1 is uploaded just before chunk
        # i's launch, so the copy runs beside chunk i's kernels.
        with ThreadPoolExecutor(max_workers=1) as stager:
            next_dev = upload_chunk(0, stage(0))
            staged = stager.submit(stage, 1) if len(starts) > 1 else None
            for i, lo in enumerate(starts):
                hi = min(lo + batch_size, n)
                t0 = time.perf_counter()
                frames_dev = next_dev
                if staged is not None:
                    next_dev = upload_chunk(i + 1, staged.result())
                    staged = stager.submit(stage, i + 2) if i + 2 < len(starts) else None
                if cuda:
                    compute.wait_event(uploaded[i % len(staging)])
                    frames_dev.record_stream(compute)
                with torch.cuda.stream(compute) if cuda else contextlib.nullcontext():
                    dets = self.predict_raw(frames_dev, conf, iou, imgsz, md, multi_label=multi_label)
                    masks = {k: dets.pop(k) for k in _MASK_ROW_KEYS if k in dets}
                    if cuda:  # into pinned host memory without blocking; the drain waits on `done`
                        dets = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
                                for k, v in dets.items()}
                    done = compute.record_event() if cuda else None
                pending.append((dets, masks, done, lo, hi, t0))  # the device runs on while the host drains
                if len(pending) >= pipeline_depth:
                    drain_one()
            while pending:
                drain_one()
        return results

    def _postprocess(
        self,
        dets: Dict[str, np.ndarray],
        packed_masks: Union[None, torch.Tensor, np.ndarray],
        orig_shapes: List[Tuple[int, int]],
        host_lb: Optional[List[Tuple[float, Tuple[float, float]]]],
        imgsz: int,
        batch_hw: Tuple[int, int],
        dt: float,
    ) -> List[Results]:
        """Host-side assembly of Results from the fetched fixed-shape dets dict."""
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
            masks = None
            if packed_masks is not None and n:
                masks = LazyMasks(packed_masks, i, n, ratio, pad, shape, imgsz)
            elif n and ("mask_q8" in dets or "mask_bits" in dets or "mask_coefs" in dets):
                masks = crop_letterbox_masks(self._host_masks(dets, i, n, imgsz), ratio, pad, shape, downsample=1)
            results.append(Results(
                boxes=boxes, scores=dets["scores"][i, :n], classes=dets["classes"][i, :n].astype(np.int32),
                orig_shape=shape, names=self.names, keypoints=kpts, masks=masks, obb=obb, speed=speed,
            ))
        return results

    @staticmethod
    def _host_masks(dets: Dict[str, np.ndarray], i: int, n: int, imgsz: int) -> np.ndarray:
        """The host-finished modes' (n, imgsz, imgsz) f32 masks of image i,
        upsampled in ultralytics' order (the floats first, then any
        threshold): "q8" soft, "bits" binary, "exact" soft."""
        if "mask_q8" in dets:
            soft = dets["mask_q8"][i, :n].astype(np.float32) / 255.0
            return resize_linear_f32(np.ascontiguousarray(soft.transpose(1, 2, 0)), imgsz, imgsz).transpose(2, 0, 1)
        if "mask_bits" in dets:
            binm = unpack_mask_bits(dets["mask_bits"][i, :n]).astype(np.float32)
            up = resize_linear_f32(np.ascontiguousarray(binm.transpose(1, 2, 0)), imgsz, imgsz)
            return (up > 0.5).astype(np.float32).transpose(2, 0, 1)
        return _assemble_masks(dets["proto"][i], dets["mask_coefs"][i, :n], dets["boxes"][i, :n], imgsz,
                               upsample=True)


def _check_mask_mode(mode: str) -> None:
    if mode not in MASK_MODES:
        raise ValueError(f"mask_mode must be one of {MASK_MODES}, got {mode!r}")


def _assemble_masks(proto: np.ndarray, coefs: np.ndarray, boxes_letterboxed: np.ndarray, imgsz: int,
                    upsample: bool = False) -> np.ndarray:
    """sigmoid(proto @ coefs) cropped to each box at prototype resolution,
    then optionally bilinearly upsampled to (imgsz, imgsz): ultralytics'
    `process_mask(upsample=True)` order, on the host for the n kept rows.
    (Hm, Wm, nm) prototypes, (n, nm) coefficients, (n, 4) letterboxed xyxy
    boxes -> (n, H, W) f32."""
    hm, wm, nm = proto.shape
    logits = proto.reshape(-1, nm).astype(np.float32) @ coefs.astype(np.float32).T  # (Hm*Wm, n)
    with np.errstate(over="ignore"):  # exp(-logit) is inf below -88: the sigmoid is 0 there, as it should be
        m = (1.0 / (1.0 + np.exp(-logits))).T.reshape(-1, hm, wm)
    scale = hm / imgsz
    ys = np.arange(hm)[None, :, None]
    xs = np.arange(wm)[None, None, :]
    b = boxes_letterboxed * scale
    keep = ((xs >= b[:, 0, None, None]) & (xs < b[:, 2, None, None])
            & (ys >= b[:, 1, None, None]) & (ys < b[:, 3, None, None]))
    m = (m * keep).astype(np.float32)
    if upsample and len(m):
        m = resize_linear_f32(np.ascontiguousarray(m.transpose(1, 2, 0)), imgsz, imgsz).transpose(2, 0, 1)
    return m


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
