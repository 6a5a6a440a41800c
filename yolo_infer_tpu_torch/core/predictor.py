"""End-to-end detect prediction on the card.

Port of `yolo_infer_tpu/core/predictor.py` (`Predictor.predict`, the box
branch of `_postprocess`, `Results`) for the detect task: uint8 frames ->
device letterbox + /255 -> BN-folded YOLO11 forward -> per-level class max
-> select-then-decode NMS -> host rescale into `Results`.

The predictor runs on `cuda` unless the caller passes `device="cpu"`; with no
card and no explicit device it raises instead of falling back to the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from yolo_infer_tpu_torch.models.spec import ModelSpec
from yolo_infer_tpu_torch.models.yolo11 import YOLO11, cast_model, fold_model
from yolo_infer_tpu_torch.ops.decode import decode_scores_raw
from yolo_infer_tpu_torch.ops.letterbox import letterbox, letterbox_params, scale_boxes
from yolo_infer_tpu_torch.ops.nms import batched_nms_seldec
from yolo_infer_tpu_torch.ops.preprocess import preprocess_batch
from yolo_infer_tpu_torch.utils.coco_names import COCO_NAMES

# candidate pool of the select-then-decode tail: the smallest 128-multiple
# that still honours the max_det=300 output contract (the JAX serve pool)
SERVE_POOL = 384


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

    def __len__(self) -> int:
        return int(self.boxes.shape[0])


class Predictor:
    """Detect serving over a `YOLO11` model.

    `params` is the port's `YOLO11` module (from `build_model`,
    `models.convert.load_state_dict` or `params_from_jax`); the predictor
    folds its batch norms, casts it to `compute_dtype` and moves it to the
    device, in place.
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
    ):
        if spec.task != "detect":
            raise NotImplementedError(f"task {spec.task!r} is not ported yet; only 'detect' is")
        self.device = resolve_device(device)
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.pre_topk = pre_topk
        self.max_det = max_det
        self.names = names or dict(COCO_NAMES)
        model = cast_model(fold_model(params), compute_dtype).to(self.device).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model

    @torch.inference_mode()
    def predict_raw(self, images_u8: torch.Tensor, conf: float, iou: float, imgsz: int, max_det: int) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) uint8 frames on the device -> the fixed-shape dets dict
        (boxes (B, max_det, 4) in letterboxed pixels, scores, classes, valid,
        num, anchor_idx), left on the device."""
        spec = self.spec
        x = preprocess_batch(images_u8, out_hw=(imgsz, imgsz), dtype=self.compute_dtype)
        feats = self.model(x)["feats"]
        best, cls, dist = decode_scores_raw(feats, spec.nc, spec.reg_max)
        return batched_nms_seldec(
            dist, best, cls, conf, iou,
            feat_shapes=tuple((f.shape[1], f.shape[2]) for f in feats),
            strides=tuple(spec.strides), reg_max=spec.reg_max,
            pre_topk=min(self.pre_topk, SERVE_POOL), max_det=max_det,
        )

    def predict(
        self,
        images: Union[np.ndarray, Sequence[np.ndarray]],
        conf: float = 0.25,
        iou: float = 0.45,
        imgsz: int = 640,
        max_det: Optional[int] = None,
    ) -> List[Results]:
        """images: uint8 RGB HWC array(s). Returns one Results per image."""
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

        md = max_det or self.max_det
        t0 = time.perf_counter()
        frames = torch.from_numpy(np.ascontiguousarray(batch_np)).to(self.device)
        dets = self.predict_raw(frames, conf, iou, imgsz, md)
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        dt = (time.perf_counter() - t0) * 1000
        return self._postprocess(dets, orig_shapes, host_lb, imgsz, tuple(batch_np.shape[1:3]), dt)

    def _postprocess(
        self,
        dets: Dict[str, np.ndarray],
        orig_shapes: List[Tuple[int, int]],
        host_lb: Optional[List[Tuple[float, Tuple[float, float]]]],
        imgsz: int,
        batch_hw: Tuple[int, int],
        dt: float,
    ) -> List[Results]:
        """Host-side assembly of Results from the synced fixed-shape dets dict."""
        batch_n = len(orig_shapes)
        if host_lb is None:
            ratio0, pad0, _ = letterbox_params(batch_hw, imgsz)
        results: List[Results] = []
        for i in range(batch_n):
            ratio, pad = host_lb[i] if host_lb is not None else (ratio0, pad0)
            n = int(dets["num"][i])
            results.append(
                Results(
                    boxes=scale_boxes(dets["boxes"][i, :n], ratio, pad, orig_shapes[i]),
                    scores=dets["scores"][i, :n],
                    classes=dets["classes"][i, :n].astype(np.int32),
                    orig_shape=orig_shapes[i],
                    names=self.names,
                    speed={"inference": dt / batch_n},
                )
            )
        return results
