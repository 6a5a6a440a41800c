"""YOLO11Model, the user-facing model wrapper, and YOLO11Factory.

Port of `yolo_infer_tpu/core/model.py` (`parse_model_name`, `YOLO11Model`:
build or load, the cached deploy form, `predictor`, `predict`, `val`,
`save`, `load`, `export`, `benchmark`, `get_model_info`, `from_params`;
`YOLO11Factory`; `train` through `core/trainer.py`). The network is the port's `YOLO11` module, built with the
seeded `build_model`, loaded from an ultralytics-named state dict, an
ultralytics `.pt` file, or a native checkpoint; prediction runs through the
port's `Predictor`, on `cuda` unless `device="cpu"` is passed.

Native checkpoints are the JAX package's files (`.msgpack`, `.ckpt`): flax's
msgpack wire format (`utils/msgpack.py`) of {"meta", "params", and "state"
when unfused, "quant_act_scales" after PTQ}, the params in the JAX package's
tree layout (`models/convert.py params_from_jax`, `params_to_jax`), so a
file moves between the two packages as it is. `export(format="safetensors")`
writes the deploy weights under the JAX package's flat names.

`train` runs `YOLO11Trainer` over this model (every task) and leaves the
trained EMA weights in it. A model narrower than its spec (a slim model of
`optimization/surgery.py`) saves and loads with its own shapes.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import re
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from yolo_infer_tpu_torch.core.predictor import Predictor, Results, resolve_device
from yolo_infer_tpu_torch.data.loader import list_image_files, load_image
from yolo_infer_tpu_torch.models.convert import load_pt_checkpoint, load_state_dict, params_from_jax, params_to_jax
from yolo_infer_tpu_torch.models.spec import SIZES, build_spec
from yolo_infer_tpu_torch.models.yolo11 import YOLO11, build_model, cast_model, fold_model
from yolo_infer_tpu_torch.utils.coco_names import COCO_NAMES
from yolo_infer_tpu_torch.utils.helpers import calculate_model_size, device_busy
from yolo_infer_tpu_torch.utils.msgpack import msgpack_restore, msgpack_serialize

logger = logging.getLogger(__name__)

SUPPORTED_TASKS: Dict[str, str] = {"detect": "", "segment": "-seg", "classify": "-cls", "pose": "-pose", "obb": "-obb"}
MODEL_SIZES = list(SIZES)

_NAME_RE = re.compile(r"yolo11([nsmlx])(?:-(seg|cls|pose|obb))?")
_SUFFIX_TASK = {"seg": "segment", "cls": "classify", "pose": "pose", "obb": "obb", None: "detect"}


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


def _host_tree(tree: Any) -> Any:
    """A restored tree with float32 numpy leaves where the file held
    bfloat16 (read as torch tensors) and numpy arrays as they are."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host_tree(v) for v in tree]
    return tree.float().numpy() if torch.is_tensor(tree) else tree


def _leaves(tree: Any):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def _has_batch_norms(model: YOLO11) -> bool:
    return any(m.bn is not None for m in model.modules() if hasattr(m, "bn"))


class YOLO11Model:
    """YOLO11 model wrapper: build or load, predict, validate, save, export.

    `model_path` is a `yolo11[nsmlx](-seg|-cls|-pose|-obb)` name, whose
    weights come from `build_model(seed=seed)` or from `state_dict`, an
    ultralytics-named flat state dict (`models/convert.py load_state_dict`);
    or a checkpoint file: a native `.msgpack`/`.ckpt` (the JAX package's
    format, fused or unfused, with PTQ scales where it has them) or an
    ultralytics `.pt`.
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
        self.device = device
        self.compute_dtype = compute_dtype
        self.mask_mode = mask_mode
        self.quant_act_scales = None  # set by PTQ
        self.quant_min_channels = None  # static8 eligibility override (see Predictor)
        self._deploy_model: Optional[YOLO11] = None
        self._predictor: Optional[Predictor] = None
        path = Path(model_path)
        if path.is_file():
            if path.suffix in (".msgpack", ".ckpt"):
                self._load_native(path, task_override=task)
            elif path.suffix == ".pt":
                self.model, self.spec, meta = load_pt_checkpoint(path)
                self.task, self.size, self.nc = meta["task"], meta["size"], meta["nc"]
                self.names = _names(self.nc, meta["names"])
            else:
                raise ValueError(f"unsupported checkpoint format {path.suffix!r} (.msgpack, .ckpt, .pt)")
            return
        parsed = parse_model_name(self.model_path)
        if parsed is None:
            raise ValueError(f"cannot resolve model {model_path!r}: not a yolo11[nsmlx](-seg|-cls|-pose|-obb) name")
        self.size, parsed_task = parsed
        self.task = task or parsed_task
        self.nc = nc
        self.names = _names(nc, names)
        if state_dict is not None:
            self.spec = build_spec(self.task, self.size, nc)
            self.model = load_state_dict(state_dict, self.spec)
        else:
            self.model, self.spec = build_model(self.task, self.size, nc, seed=seed)

    def _load_native(self, path: Path, task_override: Optional[str] = None) -> None:
        """A native checkpoint: the JAX package's `_load_native`. The model
        is the file's (folded when the file is, int8 where it is quantized),
        in f32 on the CPU; the predictor casts it. A fused file of f32
        weights is its own deploy form, in f32 (the JAX package's
        `_deploy_params` of a fused file are the file's leaves): what it
        saves fused and what a quantizer quantizes."""
        raw = msgpack_restore(path.read_bytes())
        meta = raw.get("meta", {})
        self.task = task_override or meta.get("task", "detect")
        self.size = meta.get("size", "n")
        self.nc = int(meta.get("nc", 80))
        self.names = _names(self.nc, meta.get("names"))
        self.spec = build_spec(self.task, self.size, self.nc)
        fused = bool(meta.get("fused", "state" not in raw))
        state = None if fused else _host_tree(raw["state"])
        self.model = params_from_jax(_host_tree(raw["params"]), self.spec, state)
        if "quant_act_scales" in raw:
            self.quant_act_scales = np.array(_host_tree(raw["quant_act_scales"]), np.float32)
        self._deploy_model = None
        stored = {str(leaf.dtype) for leaf in _leaves(raw["params"])}
        if fused and stored == {"float32"}:  # the JAX package serves a fused float file's weights as stored
            self._deploy_model = self.model
        logger.info("loaded %s (%s/%s, fused=%s)", path, self.task, self.size, fused)

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
        """Run inference on an image path, a directory, an array or a list of arrays.

        Lists of more than 64 images, and any call with `batch`, stream
        through `Predictor.predict_many` (one batch shape, uploads overlapped
        with compute); `batch` sets the chunk size (default 32).
        """
        if isinstance(source, (str, Path)):
            p = Path(source)
            images = [load_image(f) for f in list_image_files(p)] if p.is_dir() else load_image(p)
        else:
            images = source
        if isinstance(images, np.ndarray) and images.ndim == 4 and batch is not None:
            images = list(images)  # a stacked batch with a chunk size: chunked too
        if isinstance(images, (list, tuple)) and (batch is not None or len(images) > 64):
            return self.predictor.predict_many(images, conf=conf, iou=iou, imgsz=imgsz, max_det=max_det,
                                               batch_size=batch or 32, **kw)
        return self.predictor.predict(images, conf=conf, iou=iou, imgsz=imgsz, max_det=max_det, **kw)

    # ------------------------------------------------------------- train / val

    def train(self, data: str, epochs: int = 100, **kwargs) -> Dict[str, Any]:
        """Train on a dataset YAML (or a classify folder) with `TrainingConfig`'s
        fields as keywords; on this model's device."""
        from yolo_infer_tpu_torch.core.trainer import TrainingConfig, YOLO11Trainer

        cfg = TrainingConfig(data=data, epochs=epochs, **kwargs)
        return YOLO11Trainer(model=self, config=cfg).train()

    def val(self, data, **kwargs) -> Dict[str, Any]:
        from yolo_infer_tpu_torch.core.validator import YOLO11Validator

        return YOLO11Validator(model=self).validate(data=data, **kwargs)

    # ------------------------------------------------------------------ export

    def save(self, path: Union[str, Path], fused: bool = False) -> Path:
        """Save a native checkpoint, as the JAX package writes it: the deploy
        form (folded, in `compute_dtype`, int8 where quantized) when `fused`
        or when the model has no batch norms left, else the f32 params and
        their batch-norm state; PTQ scales beside them."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        fused = fused or not _has_batch_norms(self.model)
        meta = {"task": self.task, "size": self.size, "nc": self.nc,
                "names": {str(k): v for k, v in self.names.items()}, "fused": fused}
        payload: Dict[str, Any] = {"meta": meta}
        if fused:
            payload["params"], _ = params_to_jax(self.deploy_model, self.spec, fused=True)
        else:
            payload["params"], payload["state"] = params_to_jax(self.model, self.spec, fused=False)
        if self.quant_act_scales is not None:
            payload["quant_act_scales"] = np.asarray(self.quant_act_scales, np.float32)
        path.write_bytes(msgpack_serialize(payload))
        logger.info("saved model to %s", path)
        return path

    def load(self, path: Union[str, Path]) -> "YOLO11Model":
        """Replace the weights (and task, names, PTQ scales) with a native checkpoint's."""
        self.quant_act_scales = None
        self._load_native(Path(path))
        self.invalidate()
        return self

    def export(self, path: Optional[Union[str, Path]] = None, format: str = "msgpack") -> Path:
        """Export the fused deploy model: a native msgpack checkpoint, or a
        safetensors file of its tree flattened to dotted names in f32 (the
        JAX package's names and metadata)."""
        path = Path(path or f"{Path(self.model_path).stem}_deploy.{format}")
        if format == "msgpack":
            return self.save(path, fused=True)
        if format == "safetensors":
            from yolo_infer_tpu_torch.utils.safetensors import save_file

            flat: Dict[str, np.ndarray] = {}

            def walk(tree, prefix):
                if isinstance(tree, dict):
                    for k, v in tree.items():
                        walk(v, f"{prefix}.{k}" if prefix else k)
                elif isinstance(tree, list):
                    for i, v in enumerate(tree):
                        walk(v, f"{prefix}.{i}")
                else:
                    flat[prefix] = (tree.float().numpy() if torch.is_tensor(tree)
                                    else np.asarray(tree).astype(np.float32))

            walk(params_to_jax(self.deploy_model, self.spec, fused=True)[0], "")
            path.parent.mkdir(parents=True, exist_ok=True)
            return save_file(flat, path, metadata={"task": self.task, "size": self.size, "nc": str(self.nc)})
        raise ValueError(f"unsupported export format {format!r}")

    def benchmark(self, imgsz: int = 640, batch: int = 1, runs: int = 100, warmup: int = 10, conf: float = 0.25,
                  iou: float = 0.45, profile_dir: Optional[str] = None) -> Dict[str, Any]:
        """Timed end-to-end `predict_raw` on seeded frames already on the
        device, every time read after a device synchronisation.

        - `compile_time_s`: the first call, which includes building any
          CUDA kernel with nvcc, loading it, cuDNN's algorithm search and,
          on the card, the warm-up and capture of the signature's CUDA graph
          (`core/graphs.py`); every later call replays it.
        - Sustained throughput (`avg_time_s`, `fps`): `runs` calls queued
          back to back and one `torch.cuda.synchronize`, timed by the host
          clock between two synchronisations; three such windows, the
          median taken (`window_avgs_ms` lists them, `std_time_s` is their
          spread).
        - Per-call latency (`latency_s`, `min_time_s`, `max_time_s`): up to
          20 calls, each synchronised, host clock.
        `profile_dir` writes a `torch.profiler` chrome trace of the sustained
        windows there. The windows count as device-busy time
        (`utils.helpers.device_busy`).
        """
        pred = self.predictor
        cuda = pred.device.type == "cuda"
        images = np.random.default_rng(0).integers(0, 255, (batch, imgsz, imgsz, 3), dtype=np.uint8)
        frames = torch.from_numpy(images).to(pred.device)

        def sync():
            if cuda:
                torch.cuda.synchronize(pred.device)

        t0 = time.perf_counter()
        pred.predict_raw(frames, conf, iou, imgsz)
        sync()
        compile_s = time.perf_counter() - t0
        for _ in range(warmup):
            pred.predict_raw(frames, conf, iou, imgsz)
        sync()

        n_windows = 3 if runs >= 6 else 1
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            trace_cm = profile(activities=acts)
        else:
            trace_cm = contextlib.nullcontext()
        windows = []
        with trace_cm as prof, device_busy():
            for _ in range(n_windows):
                t0 = time.perf_counter()
                for _ in range(runs):
                    pred.predict_raw(frames, conf, iou, imgsz)
                sync()
                windows.append((time.perf_counter() - t0) / runs)
        if profile_dir:
            Path(profile_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(Path(profile_dir) / "benchmark_trace.json"))
        sustained = float(np.median(windows))

        times = []
        for _ in range(min(runs, 20)):
            t0 = time.perf_counter()
            pred.predict_raw(frames, conf, iou, imgsz)
            sync()
            times.append(time.perf_counter() - t0)
        times_np, windows_np = np.array(times), np.array(windows)
        return {
            "imgsz": imgsz,
            "batch": batch,
            "runs": n_windows * runs,
            "avg_time_s": sustained,
            "std_time_s": float(windows_np.std()),
            "window_avgs_ms": [round(w * 1e3, 3) for w in windows],
            "min_time_s": float(times_np.min()),
            "max_time_s": float(times_np.max()),
            "latency_s": float(np.median(times_np)),
            "latency_std_s": float(times_np.std()),
            "fps": batch / sustained,
            "throughput_imgs_per_s": batch / sustained,
            "compile_time_s": compile_s,
            "device": torch.cuda.get_device_name(pred.device) if cuda else "cpu",
        }

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
