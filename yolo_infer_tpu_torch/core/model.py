"""YOLO11Model, the user-facing model wrapper, and YOLO11Factory.

Port of `yolo_infer_tpu/core/model.py` (`parse_model_name`, `YOLO11Model`:
build, the cached deploy form, `predictor`, `predict`, `val`,
`get_model_info`, `from_params`; `YOLO11Factory`). The network is the
port's `YOLO11` module, built with the seeded `build_model` or loaded from
an ultralytics-named state dict; prediction runs through the port's
`Predictor`, on `cuda` unless `device="cpu"` is passed.

Not ported yet, and raising: loading a checkpoint file, `save`/`load`/
`export` and `benchmark` (ROADMAP Queue 1 item 6), `train` (item 9), and
`predict` on more than 64 images or with `batch=` (`predict_many`, item 6).
"""

from __future__ import annotations

import copy
import logging
import re
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from yolo_infer_tpu_torch.core.predictor import Predictor, Results, resolve_device
from yolo_infer_tpu_torch.data.loader import list_image_files, load_image
from yolo_infer_tpu_torch.models.convert import load_state_dict
from yolo_infer_tpu_torch.models.spec import SIZES, build_spec
from yolo_infer_tpu_torch.models.yolo11 import YOLO11, build_model, cast_model, fold_model
from yolo_infer_tpu_torch.utils.coco_names import COCO_NAMES
from yolo_infer_tpu_torch.utils.helpers import calculate_model_size

logger = logging.getLogger(__name__)

SUPPORTED_TASKS: Dict[str, str] = {"detect": "", "segment": "-seg", "classify": "-cls", "pose": "-pose", "obb": "-obb"}
MODEL_SIZES = list(SIZES)

_NAME_RE = re.compile(r"yolo11([nsmlx])(?:-(seg|cls|pose|obb))?")
_SUFFIX_TASK = {"seg": "segment", "cls": "classify", "pose": "pose", "obb": "obb", None: "detect"}
_NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item {})"


def parse_model_name(name: str):
    """'yolo11n', 'yolo11s-seg', 'yolo11m.pt' -> (size, task) or None."""
    m = _NAME_RE.search(Path(name).stem.lower())
    if not m:
        return None
    return m.group(1), _SUFFIX_TASK[m.group(2)]


def _names(nc: int, names) -> Dict[int, str]:
    if names is None:
        return dict(COCO_NAMES) if nc == 80 else {i: str(i) for i in range(nc)}
    return {int(k): v for k, v in names.items()} if isinstance(names, dict) else dict(enumerate(names))


class YOLO11Model:
    """YOLO11 model wrapper: build or load, predict, validate.

    `model_path` is a `yolo11[nsmlx](-seg|-cls|-pose|-obb)` name; the
    weights come from `build_model(seed=seed)`, or from `state_dict`, an
    ultralytics-named flat state dict (`models/convert.py load_state_dict`).
    """

    def __init__(
        self,
        model_path: Union[str, Path] = "yolo11n",
        task: Optional[str] = None,
        device: Optional[str] = None,
        nc: int = 80,
        names: Optional[Union[Dict[int, str], Sequence[str]]] = None,
        seed: int = 0,
        compute_dtype: torch.dtype = torch.bfloat16,
        mask_mode: str = "device",
        state_dict: Optional[Mapping[str, Any]] = None,
    ):
        self.model_path = str(model_path)
        if Path(model_path).is_file():
            raise NotImplementedError(f"loading the checkpoint {model_path} {_NOT_PORTED.format(6)}; pass "
                                      "state_dict= (an ultralytics-named state dict) or a model name")
        parsed = parse_model_name(self.model_path)
        if parsed is None:
            raise ValueError(f"cannot resolve model {model_path!r}: not a yolo11[nsmlx](-seg|-cls|-pose|-obb) name")
        self.size, parsed_task = parsed
        self.task = task or parsed_task
        self.nc = nc
        self.names = _names(nc, names)
        self.device = device
        self.compute_dtype = compute_dtype
        self.mask_mode = mask_mode
        self.quant_act_scales = None  # set by PTQ
        self.quant_min_channels = None  # static8 eligibility override (see Predictor)
        if state_dict is not None:
            self.spec = build_spec(self.task, self.size, nc)
            self.model = load_state_dict(state_dict, self.spec)
        else:
            self.model, self.spec = build_model(self.task, self.size, nc, seed=seed)
        self._deploy_model: Optional[YOLO11] = None
        self._predictor: Optional[Predictor] = None

    @classmethod
    def from_params(
        cls,
        model: YOLO11,
        *,
        task: str,
        size: str,
        nc: int = 80,
        names=None,
        fused: bool = True,
        quant_act_scales=None,
        compute_dtype: torch.dtype = torch.bfloat16,
        model_path: str = "in-memory",
        device: Optional[str] = None,
        mask_mode: str = "device",
    ) -> "YOLO11Model":
        """A wrapper around an existing `YOLO11` module (no re-init); with
        `fused` it is taken as the deploy form as it is."""
        obj = cls.__new__(cls)
        obj.model_path = model_path
        obj.task, obj.size, obj.nc = task, size, nc
        obj.names = _names(nc, names)
        obj.device = device
        obj.compute_dtype = compute_dtype
        obj.mask_mode = mask_mode
        obj.quant_act_scales = quant_act_scales
        obj.quant_min_channels = None
        obj.spec = model.spec
        obj.model = model
        obj._deploy_model = model if fused else None
        obj._predictor = None
        return obj

    # ------------------------------------------------------------------ infer

    @property
    def deploy_model(self) -> YOLO11:
        """BN-folded copy of the model in `compute_dtype`, on the CPU (made once, cached)."""
        if self._deploy_model is None:
            self._deploy_model = cast_model(fold_model(copy.deepcopy(self.model)), self.compute_dtype)
        return self._deploy_model

    @property
    def predictor(self) -> Predictor:
        if self._predictor is None:
            self._predictor = Predictor(
                self.deploy_model, self.spec, device=self.device, compute_dtype=self.compute_dtype,
                names=self.names, mask_mode=self.mask_mode, quant_act_scales=self.quant_act_scales,
                quant_min_channels=self.quant_min_channels,
            )
        return self._predictor

    def invalidate(self) -> None:
        """Drop the cached deploy form and predictor after a weights update."""
        self._deploy_model = None
        self._predictor = None

    def predict(
        self,
        source: Union[str, Path, np.ndarray, Sequence[np.ndarray]],
        conf: float = 0.25,
        iou: float = 0.45,
        imgsz: int = 640,
        max_det: int = 300,
        batch: Optional[int] = None,
        **kw,
    ) -> List[Results]:
        """Run inference on an image path, a directory, an array or a list of arrays."""
        if isinstance(source, (str, Path)):
            p = Path(source)
            images = [load_image(f) for f in list_image_files(p)] if p.is_dir() else load_image(p)
        else:
            images = source
        n = len(images) if isinstance(images, (list, tuple)) or (isinstance(images, np.ndarray) and images.ndim == 4) else 1
        if batch is not None or n > 64:
            raise NotImplementedError(f"chunked prediction (predict_many) {_NOT_PORTED.format(6)}; "
                                      "pass at most 64 images and no batch=")
        return self.predictor.predict(images, conf=conf, iou=iou, imgsz=imgsz, max_det=max_det, **kw)

    # ------------------------------------------------------------- train / val

    def train(self, data: str, epochs: int = 100, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError(f"training {_NOT_PORTED.format(9)}")

    def val(self, data, **kwargs) -> Dict[str, Any]:
        from yolo_infer_tpu_torch.core.validator import YOLO11Validator

        return YOLO11Validator(model=self).validate(data=data, **kwargs)

    # ------------------------------------------------------------------ export

    def save(self, path, fused: bool = False):
        raise NotImplementedError(f"saving a checkpoint {_NOT_PORTED.format(6)}")

    def load(self, path):
        raise NotImplementedError(f"loading a checkpoint {_NOT_PORTED.format(6)}")

    def export(self, path=None, format: str = "msgpack"):
        raise NotImplementedError(f"export {_NOT_PORTED.format(6)}")

    def benchmark(self, *args, **kwargs):
        raise NotImplementedError(f"the speed benchmark {_NOT_PORTED.format(6)}")

    # ------------------------------------------------------------------- info

    def get_model_info(self) -> Dict[str, Any]:
        size_info = calculate_model_size(self.model)
        device = resolve_device(self.device)
        return {
            "model_path": self.model_path,
            "task": self.task,
            "model_size": self.size,
            "num_classes": self.nc,
            "device": str(device),
            "parameters": size_info["parameters"],
            "size_mb": size_info["size_mb"],
            "compute_dtype": str(self.compute_dtype).replace("torch.", ""),
            "backend": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        }


class YOLO11Factory:
    """One creator per task."""

    @staticmethod
    def create_detector(size: str = "n", **kw) -> YOLO11Model:
        return YOLO11Model(f"yolo11{size}", task="detect", **kw)

    @staticmethod
    def create_segmenter(size: str = "n", **kw) -> YOLO11Model:
        return YOLO11Model(f"yolo11{size}-seg", task="segment", **kw)

    @staticmethod
    def create_classifier(size: str = "n", **kw) -> YOLO11Model:
        return YOLO11Model(f"yolo11{size}-cls", task="classify", **kw)

    @staticmethod
    def create_pose_estimator(size: str = "n", **kw) -> YOLO11Model:
        return YOLO11Model(f"yolo11{size}-pose", task="pose", **kw)

    @staticmethod
    def create_obb_detector(size: str = "n", **kw) -> YOLO11Model:
        return YOLO11Model(f"yolo11{size}-obb", task="obb", **kw)
