"""Serving artifacts: the whole serving program on `torch.export`, replayed as one CUDA graph.

Port of `yolo_infer_tpu/core/exported.py` (`export_predictor`,
`ExportedPredictor`). One file holds the whole serving program of a model:
the device letterbox and normalisation, the forward with the weights baked
in, the decode and the NMS of its task, as a `torch.export` program. The
eight CUDA kernels are nodes of it (`torch.ops.yolo_port.*`, the custom ops
of `ops/kernels/`), as the Mosaic custom calls are inside a JAX artifact. A
consumer serves the file without the model code, its spec or a checkpoint:

    ExportedPredictor.load("yolo11n_b32_640.pt2").predict(images)

Like any AOT artifact the program is specialised: batch, imgsz, max_det,
task, multi_label and the static8 scales are fixed when it is exported (the
metadata records them); conf and iou stay runtime inputs, 0-d f32 tensors
that kernels A, C and G read from device memory. The file is a
`torch.export.save` archive with the metadata as its extra file `meta.json`.

On the card the loaded program is captured once into a CUDA graph by the
mechanism the live predictor's program cache uses (`core/graphs.py`: a
warm-up on a side stream, static buffers for the frames, conf and iou);
`predict_raw` copies into them, replays, and returns clones of the outputs,
which the next call leaves alone. A capture that fails raises: there is no
eager fallback on the card. On the CPU the loaded program runs eagerly.

Device note: `make_anchors` and the program's `torch.arange`s are traced on
the device they ran on, so an artifact serves on the device it was exported
for, and loading it for another raises.
"""

from __future__ import annotations

import json
import time
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from yolo_infer_tpu_torch.core.graphs import CapturedProgram
from yolo_infer_tpu_torch.core.predictor import DevScalarCache, Predictor
# importing the wrappers registers the ops an artifact calls (torch.ops.yolo_port.*)
from yolo_infer_tpu_torch.ops.kernels import (  # noqa: F401
    attention_fused,
    dfl_decode,
    greedy_nms,
    int8_conv,
    mask_pack,
    nms_fused,
    rotated_nms_fused,
)
from yolo_infer_tpu_torch.ops.letterbox import letterbox
from yolo_infer_tpu_torch.ops.nms import Threshold

FORMAT_VERSION = 1
META_FILE = "meta.json"


class _ServeProgram(torch.nn.Module):
    """The module `torch.export` traces: (frames, conf, iou) -> dets, the
    body of `Predictor.predict_raw` for one signature. The predictor's
    model is a submodule, so its weights become the program's."""

    def __init__(self, pred: Predictor, imgsz: int, max_det: int, multi_label: bool):
        super().__init__()
        self.model = pred.model
        self._pred = pred  # not a module: reached for its serving code only
        self.imgsz, self.max_det, self.multi_label = imgsz, max_det, multi_label

    def forward(self, images_u8: torch.Tensor, conf: torch.Tensor, iou: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._pred.serve_program(images_u8, conf, iou, self.imgsz, self.max_det, multi_label=self.multi_label)


def export_predictor(
    model: Any,
    path: Union[str, Path],
    *,
    batch: int = 1,
    imgsz: int = 640,
    multi_label: bool = False,
    max_det: Optional[int] = None,
) -> Path:
    """Export `model`'s whole serving program (weights baked) to `path`.

    `model` is a `YOLO11Model`: its predictor's folded, cast (and on the
    card `channels_last`) copy is what the program holds, and its device is
    the device the artifact serves on."""
    pred = model.predictor
    md = max_det or pred.max_det
    dev = pred.device
    frames = torch.zeros((batch, imgsz, imgsz, 3), dtype=torch.uint8, device=dev)
    conf = torch.full((), 0.25, dtype=torch.float32, device=dev)
    iou = torch.full((), 0.45, dtype=torch.float32, device=dev)
    with torch.no_grad():  # inference tensors do not export
        program = torch.export.export(_ServeProgram(pred, imgsz, md, multi_label), (frames, conf, iou))
    meta = {
        "format_version": FORMAT_VERSION,
        "task": model.task,
        "size": model.size,
        "nc": model.nc,
        "names": {str(k): v for k, v in model.names.items()},
        "batch": batch,
        "imgsz": imgsz,
        "max_det": md,
        "multi_label": multi_label,
        "platforms": [dev.type],
        "device": str(dev),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(path), extra_files={META_FILE: json.dumps(meta)})
    return path


def read_meta(path: Union[str, Path]) -> Dict[str, Any]:
    """An artifact's metadata, read without loading its program."""
    with zipfile.ZipFile(path) as zf:
        name = next((n for n in zf.namelist() if n.endswith(f"/extra/{META_FILE}")), None)
        if name is None:
            raise ValueError(f"{path} is not a serving artifact (no {META_FILE})")
        return json.loads(zf.read(name))


class _SpecShim:
    """The part of a `ModelSpec` that `Predictor._postprocess` reads."""

    def __init__(self, task: str):
        self.task = task


class ExportedPredictor:
    """Serve a `torch.export` artifact: no model code or weights needed."""

    def __init__(self, program: torch.export.ExportedProgram, meta: Dict[str, Any]):
        self.meta = meta
        self.task = meta["task"]
        self.batch = int(meta["batch"])
        self.imgsz = int(meta["imgsz"])
        self.device = torch.device(meta["device"])
        self.names = {int(k): v for k, v in meta["names"].items()}
        self.spec = _SpecShim(self.task)  # duck-typed so Predictor._postprocess works unchanged
        self._module = program.module()
        self._dev_scalar = DevScalarCache()
        self._program: Optional[CapturedProgram] = None  # the capture, made by the first predict_raw on the card

    @classmethod
    def load(cls, path: Union[str, Path], device: Union[None, str, torch.device] = None) -> "ExportedPredictor":
        """Load an artifact to serve on the device it was exported for;
        `device`, when given, must be that device."""
        meta = read_meta(path)
        if int(meta.get("format_version", 0)) != FORMAT_VERSION:
            raise ValueError(f"unsupported artifact version {meta.get('format_version')}")
        dev = torch.device(meta["device"])
        want = dev if device is None else torch.device(device)
        if want.type != dev.type or (dev.type == "cuda" and not torch.cuda.is_available()):
            where = want if device is not None else "this host, which has no CUDA device"
            raise RuntimeError(f"the artifact {path} serves on {dev}, the device it was exported for; "
                               f"it cannot serve on {where}")
        return cls(torch.export.load(str(path)), meta)

    # -- raw program ---------------------------------------------------------

    def _check(self, images_u8) -> None:
        want = (self.batch, self.imgsz, self.imgsz, 3)
        if tuple(images_u8.shape) != want:
            raise ValueError(f"artifact is specialized to {want}, got {tuple(images_u8.shape)}")

    def run_eager(self, images_u8: Union[np.ndarray, torch.Tensor], conf: Threshold = 0.25,
                  iou: Threshold = 0.45) -> Dict[str, torch.Tensor]:
        """The loaded program run op by op, without the graph (the CPU's
        `predict_raw`, and the card's yardstick for the replay)."""
        self._check(images_u8)
        x = torch.as_tensor(images_u8).to(self.device)
        with torch.no_grad():
            return self._module(x, self._dev_scalar(conf, self.device), self._dev_scalar(iou, self.device))

    def predict_raw(self, images_u8: Union[np.ndarray, torch.Tensor], conf: Threshold = 0.25,
                    iou: Threshold = 0.45) -> Dict[str, torch.Tensor]:
        """Run the baked program on (batch, imgsz, imgsz, 3) uint8 frames.

        On the card: the frames, conf and iou are copied into the graph's
        static inputs, the graph is replayed, and the outputs come back as
        fresh tensors (clones of the graph's own), which the next call leaves
        alone, as the JAX artifact's arrays are. Nothing here waits for the
        device."""
        if self.device.type != "cuda":
            return self.run_eager(images_u8, conf, iou)
        return {k: v.clone() for k, v in self._replay(images_u8, conf, iou).items()}

    def _replay(self, images_u8, conf: Threshold, iou: Threshold) -> Dict[str, torch.Tensor]:
        """The graph's static outputs after one replay on these inputs
        (captured on the first call); the next replay overwrites them."""
        self._check(images_u8)
        with torch.no_grad():
            if self._program is None:
                shape = (self.batch, self.imgsz, self.imgsz, 3)
                self._program = CapturedProgram(self._module, shape, self.device)
            return self._program.replay(torch.as_tensor(images_u8), self._dev_scalar(conf, self.device),
                                        self._dev_scalar(iou, self.device))

    # -- convenience: same Results surface as Predictor.predict ---------------

    _postprocess = Predictor._postprocess
    _host_masks = staticmethod(Predictor._host_masks)

    def predict(self, images: Union[np.ndarray, Sequence[np.ndarray]], conf: float = 0.25,
                iou: float = 0.45) -> List[Any]:
        """Host-letterbox `images` to the artifact signature and serve.

        Accepts up to `batch` images; the batch is padded with zeros (pad
        results are dropped). The graph's outputs are read before the next
        replay: the dets to the host, and for segment a copy of the mask
        rows the images use, which stays on the device as `LazyMasks`."""
        single = isinstance(images, np.ndarray) and images.ndim == 3
        imgs = [images] if single else list(images)
        if not imgs:
            return []
        if len(imgs) > self.batch:
            raise ValueError(f"artifact batch is {self.batch}, got {len(imgs)} images")
        lb = [letterbox(im, self.imgsz) for im in imgs]
        batch_np = np.zeros((self.batch, self.imgsz, self.imgsz, 3), np.uint8)
        for i, (im, _, _) in enumerate(lb):
            batch_np[i] = im
        n = len(imgs)
        t0 = time.perf_counter()
        dets = dict(self._replay(batch_np, conf, iou) if self.device.type == "cuda"
                    else self.run_eager(batch_np, conf, iou))
        packed = dets.pop("mask_bits_up", None)
        dets = {k: v[:n].cpu().numpy() for k, v in dets.items()}  # drop the padding rows
        if packed is not None:
            packed = packed[:n, : int(dets["num"].max(initial=0))].clone()
        dt = (time.perf_counter() - t0) * 1000
        host_lb = [(l[1], l[2]) for l in lb]
        out = self._postprocess(dets, packed, [tuple(im.shape[:2]) for im in imgs], host_lb, self.imgsz,
                                (self.imgsz, self.imgsz), dt)
        return out[0:1] if single else out
