"""YOLO11Trainer: training orchestration for every task.

Port of `yolo_infer_tpu/core/trainer.py` (`TrainingConfig`,
`TrainingCallbacks`, `YOLO11Trainer.train`, `fine_tune`, `transfer_learn`,
`resume_training`, `validate`, `_freeze_predicate`, `_adapt_head_nc`,
`_validate_ema`, `_sync_model_from_state`, `_write_summary`,
`create_trainer`, `MultiChipTrainer`, `_select_devices`, `_build_mesh`).
The step is `core/train_step.py` on the state's device, the batches come
from `data/train_loader.py` (or `data/classify.py ClassifyLoader`), built on
host threads ahead of the steps. The trainer runs on `cuda` unless the model
or the caller says `device="cpu"`; with no card it raises.

Several devices. The JAX trainer spans every device of its program through a
('data', 'model') mesh; the port spans every process of an initialized
`torch.distributed` group (`torchrun --nproc_per_node=N -m
yolo_infer_tpu_torch train ...`), one device each: an index-free "cuda" is
card r for process r. `_build_mesh` takes the JAX rule (the data axis is the
largest count of devices that divides both the batch and the devices) over
the whole world, and each process runs `make_train_step(..., mesh=)` on its
slice of the global batch `config.batch`: the loader builds this process's
own batches of batch / dp images (`shard=(process_index, process_count)`;
classify, whose loader has no shard, builds the global batch and keeps its
slice). Only the main process writes the run directory, config.json, the
checkpoints and the summary; the early-stop decision is rank 0's
(`broadcast_scalar`); rank 0's starting state is broadcast to the others;
per-epoch validation serves on the training mesh (a meshed `Predictor`: each
process its slice of every batch, the whole batch's detections on every
process, equal metrics everywhere). `MultiChipTrainer(device_ids=...)`
trains on the named cards: inside a group process r takes card
`device_ids[r]`; outside one, `train()` starts the group itself
(`parallel/distributed.py launch`: one process per card of the mesh, a
`FileStore` rendezvous, NCCL on cards and gloo for `device="cpu"`) and takes
the trained model back from rank 0.

After every epoch the EMA weights are validated (`YOLO11Validator`'s
multi-label NMS: kernels F and G on the card; classify through
`evaluate_classifier`: kernel B). One `Predictor` serves every epoch: the new
EMA weights, folded and cast, are copied into its module in place
(`_validate_ema`), so a CUDA graph it captured reads this epoch's weights.

Beside the JAX package's files (config.json, checkpoints/,
training_summary.txt, history.json) the run directory gets timing.json:
per epoch the steps, images, wall seconds, the seconds the loop waited for
the loader and the validation seconds.

Three hooks change the step (`core/train_step.py`): `TrainingConfig.qat`
(fake-quant training, `QATQuantizer`), `trainer.param_mask` (pruning masks
held in the step, `PruningOptimizer`) and `trainer.distill` (a teacher
inside the step, `DistillationOptimizer`: {"model": a `YOLO11`,
"temperature", "alpha"}; its folded copy runs on the trainer's device).

"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

logger = logging.getLogger(__name__)

BACKBONE_LAYERS = tuple(str(i) for i in range(11))  # layers 0-10
# threads that build a batch's samples (data/train_loader.py); the result does not depend on it
LOADER_WORKERS = min(8, os.cpu_count() or 1)


@dataclasses.dataclass
class TrainingConfig:
    """Typed training config with a JSON round trip (the JAX package's fields and defaults)."""

    data: str = ""
    epochs: int = 100
    batch: int = 16
    imgsz: int = 640
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    cos_lr: bool = True
    patience: int = 50
    save_period: int = -1
    max_boxes: int = 120
    seed: int = 0
    project: str = "runs/train"
    name: str = "exp"
    exist_ok: bool = False
    freeze: Optional[Union[int, Sequence[str]]] = None
    resume: bool = False
    val: bool = True
    close_mosaic: int = 10
    qat: bool = False  # quantization-aware training (fake-quant in the step)
    # loss weights
    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5
    # augmentation
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    fliplr: float = 0.5
    flipud: float = 0.0
    mosaic: float = 1.0
    mixup: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainingConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def save(self, path: Union[str, Path]) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: Union[str, Path]) -> "TrainingConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))

    def aug_hyp(self) -> Dict[str, float]:
        return {
            k: getattr(self, k)
            for k in ("hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale", "shear", "fliplr", "flipud",
                      "mosaic", "mixup", "close_mosaic")
        }

    def loss_hyp(self) -> Dict[str, float]:
        return {"box": self.box, "cls": self.cls, "dfl": self.dfl, "tal_topk": 10, "tal_alpha": 0.5, "tal_beta": 6.0}


class TrainingCallbacks:
    """Event registry."""

    EVENTS = (
        "on_train_start",
        "on_epoch_start",
        "on_batch_start",
        "on_batch_end",
        "on_epoch_end",
        "on_val_end",
        "on_checkpoint_save",
        "on_train_end",
    )

    def __init__(self):
        self._handlers: Dict[str, List[Callable]] = {e: [] for e in self.EVENTS}

    def register(self, event: str, fn: Callable) -> None:
        if event not in self._handlers:
            raise ValueError(f"unknown event {event!r}; expected one of {self.EVENTS}")
        self._handlers[event].append(fn)

    def fire(self, event: str, **kw) -> None:
        for fn in self._handlers.get(event, []):
            fn(**kw)


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class YOLO11Trainer:
    """Standard trainer. `model` is a `YOLO11Model` (its weights are replaced
    by the trained EMA weights at the end); `device` overrides the model's."""

    def __init__(
        self,
        model: Any = None,
        model_path: str = "yolo11n",
        config: Optional[TrainingConfig] = None,
        output_dir: Optional[Union[str, Path]] = None,
        callbacks: Optional[TrainingCallbacks] = None,
        device: Optional[str] = None,
    ):
        from yolo_infer_tpu_torch.core.model import YOLO11Model
        from yolo_infer_tpu_torch.core.predictor import resolve_device

        if model is None:
            model = YOLO11Model(model_path, device=device)
        self.model = model
        self.device = resolve_device(device if device is not None else model.device)
        self.config = config or TrainingConfig()
        base = Path(output_dir) if output_dir else Path(self.config.project)
        run_dir = base / self.config.name
        if run_dir.exists() and not self.config.exist_ok and any(run_dir.iterdir()):
            i = 2
            while (base / f"{self.config.name}{i}").exists():
                i += 1
            run_dir = base / f"{self.config.name}{i}"
        self.run_dir = run_dir
        self.callbacks = callbacks or TrainingCallbacks()
        self._freeze: Optional[Union[int, Sequence[str]]] = self.config.freeze
        # optimizer hooks of pruning and distillation (optimization/pruning.py, optimization/distillation.py)
        self.param_mask: Any = None
        self.distill: Optional[Dict[str, Any]] = None
        self.timing: List[Dict[str, float]] = []
        self._val_predictor = None
        self._mesh = None  # the training mesh of the last `train` (None: one device)

    # ------------------------------------------------------------------ train

    def train(self, resume: Optional[bool] = None, **overrides) -> Dict[str, Any]:
        from yolo_infer_tpu_torch.core.train_step import init_train_state, make_optimizer, make_train_step
        from yolo_infer_tpu_torch.data.dataset import YOLODataset
        from yolo_infer_tpu_torch.data.train_loader import TrainLoader
        from yolo_infer_tpu_torch.parallel import distributed as dist
        from yolo_infer_tpu_torch.parallel.mesh import shard_batch
        from yolo_infer_tpu_torch.utils.checkpoint import CheckpointManager
        from yolo_infer_tpu_torch.utils.helpers import device_busy

        cfg = dataclasses.replace(self.config, **overrides) if overrides else self.config
        if resume is not None:
            cfg = dataclasses.replace(cfg, resume=resume)
        mesh = self._build_mesh(cfg)
        self._mesh = mesh
        dp = 1
        if mesh is not None:
            dp = mesh.shape["data"]
            self.device = self._select_devices()[dist.process_index()]
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self.run_dir = Path(_from_rank0(str(self.run_dir)))  # the name rank 0 chose
        # one writer: the reference's `RANK in {-1, 0}` gates
        main = dist.is_main_process()
        if main:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            cfg.save(self.run_dir / "config.json")
        log = logging.getLogger("yolo_infer_tpu_torch.train")

        slice_batch = False  # classify: every process builds the global batch and keeps its slice
        if self.model.task == "classify":
            from yolo_infer_tpu_torch.data.classify import ClassifyDataset, ClassifyLoader

            train_ds = ClassifyDataset(cfg.data, split="train")
            loader = ClassifyLoader(train_ds, batch_size=cfg.batch, imgsz=cfg.imgsz, seed=cfg.seed)
            slice_batch = mesh is not None
        else:
            ds_task = self.model.task if self.model.task in ("segment", "pose", "obb") else "detect"
            train_ds = YOLODataset(cfg.data, split="train", task=ds_task)
            loader = TrainLoader(train_ds, batch_size=cfg.batch // dp, imgsz=cfg.imgsz, max_boxes=cfg.max_boxes,
                                 hyp=cfg.aug_hyp(), seed=cfg.seed, workers=LOADER_WORKERS,
                                 shard=(dist.process_index(), dist.process_count()))
        steps_per_epoch = len(loader)
        total_steps = steps_per_epoch * cfg.epochs
        # the reference's warmup window, max(round(warmup_epochs * nb), 100)
        # batches; the 100-batch floor is capped at a third of a short run
        floor = min(100, max(total_steps // 3, 1))
        warmup_steps = max(round(cfg.warmup_epochs * steps_per_epoch), floor) if cfg.warmup_epochs > 0 else 0

        model = self.model
        if model.nc != train_ds.nc:
            log.info("re-initializing the head: model nc=%d -> dataset nc=%d (other layers kept)", model.nc,
                     train_ds.nc)
            _adapt_head_nc(model, train_ds.nc, train_ds.names, seed=cfg.seed)

        tx = make_optimizer(cfg.lr0, lrf=cfg.lrf, total_steps=total_steps, warmup_steps=warmup_steps,
                            momentum=cfg.momentum, weight_decay=cfg.weight_decay, cos_lr=cfg.cos_lr,
                            freeze=self._freeze_predicate())
        distill = None
        if self.distill is not None:  # the teacher's deploy form on this device
            from yolo_infer_tpu_torch.models.yolo11 import fold_model

            teacher = fold_model(copy.deepcopy(self.distill["model"])).to(self.device).eval()
            distill = {**self.distill, "model": teacher}
        step_fn = make_train_step(model.spec, tx, hyp=cfg.loss_hyp(), compute_dtype=model.compute_dtype,
                                  qat=cfg.qat, param_mask=self.param_mask, distill=distill, mesh=mesh)
        ts = init_train_state(model.model, tx, seed=cfg.seed, device=self.device)

        ckpt_mgr = CheckpointManager(self.run_dir / "checkpoints")
        start_epoch = 0
        if cfg.resume:
            latest = ckpt_mgr.get_latest_checkpoint()
            if latest is not None:
                restored = ckpt_mgr.load_checkpoint(latest, target=ts.tree())
                ts.load_tree(restored["train_state"])
                start_epoch = int(restored.get("epoch", -1)) + 1
                log.info("resumed from %s (epoch %d)", latest, start_epoch)
            else:
                log.info("resume requested but no checkpoint found; starting fresh")
        if mesh is not None:  # every process starts from rank 0's state
            for t in (ts.params, ts.bn_state, ts.ema_params, ts.opt_state["mom"], ts.opt_state["count"], ts.step,
                      ts.skipped):
                torch.distributed.broadcast(t, src=0)

        best_fitness = -1.0
        epochs_without_improvement = 0
        history: List[Dict[str, float]] = []
        self.timing = []
        t_start = time.perf_counter()
        self.callbacks.fire("on_train_start", trainer=self, config=cfg)

        final_epoch = start_epoch
        for epoch in range(start_epoch, cfg.epochs):
            final_epoch = epoch
            if cfg.close_mosaic and epoch >= cfg.epochs - cfg.close_mosaic:
                loader.close_mosaic()
            self.callbacks.fire("on_epoch_start", epoch=epoch)
            t_epoch = time.perf_counter()
            last_metrics: Dict[str, Any] = {}
            wait_s, n_steps, n_images = 0.0, 0, 0
            batches = loader.epoch_batches(epoch)
            bi = 0
            while True:
                t_wait = time.perf_counter()
                batch = next(batches, None)
                wait_s += time.perf_counter() - t_wait
                if batch is None:
                    break
                self.callbacks.fire("on_batch_start", epoch=epoch, batch=bi)
                if slice_batch:
                    batch = shard_batch(batch, mesh)
                # the loader's wait stays outside the busy window; the metric
                # read every 50 steps waits for the queued steps to finish
                with device_busy():
                    ts, metrics = step_fn(ts, _to_device(batch, self.device))
                    if bi == steps_per_epoch - 1 or bi % 50 == 49:
                        last_metrics = {k: float(v) for k, v in metrics.items()}
                self.callbacks.fire("on_batch_end", epoch=epoch, batch=bi, metrics=metrics)
                n_steps += 1
                n_images += len(batch["images"])
                bi += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            epoch_time = time.perf_counter() - t_epoch
            skipped = int(ts.skipped)
            log.info(
                "epoch %d/%d loss=%.4f (box %.3f cls %.3f dfl %.3f) %.1fs skipped=%d",
                epoch + 1, cfg.epochs, last_metrics.get("loss", float("nan")),
                last_metrics.get("loss_box", 0), last_metrics.get("loss_cls", 0),
                last_metrics.get("loss_dfl", 0), epoch_time, skipped,
            )

            row = {"epoch": epoch, **last_metrics, "time_s": epoch_time}
            timing = {"epoch": epoch, "steps": n_steps, "images": n_images, "train_s": epoch_time,
                      "loader_wait_s": wait_s, "val_s": 0.0}
            if cfg.val:
                t_val = time.perf_counter()
                val_metrics = self._validate_ema(ts, cfg)
                timing["val_s"] = time.perf_counter() - t_val
                self.callbacks.fire("on_val_end", epoch=epoch, metrics=val_metrics)
                row.update({f"val_{k}": v for k, v in val_metrics.items()})
                if self.model.task == "classify":
                    fitness = val_metrics.get("top1", 0.0)
                else:
                    fitness = 0.9 * val_metrics["mAP50-95"] + 0.1 * val_metrics["mAP50"]
                if fitness > best_fitness:
                    best_fitness = fitness
                    epochs_without_improvement = 0
                    if main:
                        ckpt_mgr.save_checkpoint(ts.tree(), epoch=epoch, metrics=row, is_best=True)
                    self.callbacks.fire("on_checkpoint_save", epoch=epoch, best=True)
                else:
                    epochs_without_improvement += 1
            history.append(row)
            self.timing.append(timing)
            self.callbacks.fire("on_epoch_end", epoch=epoch, metrics=row)

            if cfg.save_period > 0 and (epoch + 1) % cfg.save_period == 0:
                if main:
                    ckpt_mgr.save_checkpoint(ts.tree(), epoch=epoch, metrics=row)
                self.callbacks.fire("on_checkpoint_save", epoch=epoch, best=False)

            # the stop decision agreed across processes (the reference's
            # broadcast_object_list stop flag)
            should_stop = 1.0 if (cfg.patience > 0 and epochs_without_improvement >= cfg.patience) else 0.0
            if dist.broadcast_scalar(should_stop) > 0.5:
                log.info("early stopping at epoch %d (patience %d)", epoch + 1, cfg.patience)
                break

        self._sync_model_from_state(ts)
        total_time = time.perf_counter() - t_start
        if main:
            ckpt_mgr.save_checkpoint(ts.tree(), epoch=final_epoch, metrics=history[-1] if history else {})
            self._write_summary(history, total_time)
        self.callbacks.fire("on_train_end", history=history)
        return {
            "status": "completed",
            "epochs_completed": len(history),
            "best_fitness": best_fitness,
            "skipped_steps": int(ts.skipped),
            "corrupt_samples": getattr(loader, "corrupt_samples", 0),
            "history": history,
            "run_dir": str(self.run_dir),
            "training_time_s": total_time,
        }

    # --------------------------------------------------------------- variants

    def fine_tune(self, data: str, epochs: int = 50, freeze: Union[int, Sequence[str]] = 10, lr: float = 1e-3,
                  **kw) -> Dict[str, Any]:
        """Freeze early layers and train the rest at a low lr."""
        self._freeze = freeze
        return self.train(data=data, epochs=epochs, lr0=lr, **kw)

    def transfer_learn(self, data: str, epochs_frozen: int = 10, epochs_unfrozen: int = 40, **kw) -> Dict[str, Any]:
        """Two-phase transfer learning: the backbone frozen first, then the
        whole model at a tenth of the lr. Each phase gets its own trainer (and
        run directory) over the same model."""
        cfg1 = dataclasses.replace(self.config, freeze=list(BACKBONE_LAYERS), name=f"{self.config.name}_phase1")
        t1 = YOLO11Trainer(model=self.model, config=cfg1, callbacks=self.callbacks, device=str(self.device))
        phase1 = t1.train(data=data, epochs=epochs_frozen, **kw)
        cfg2 = dataclasses.replace(self.config, freeze=None, name=f"{self.config.name}_phase2",
                                   lr0=self.config.lr0 * 0.1)
        t2 = YOLO11Trainer(model=self.model, config=cfg2, callbacks=self.callbacks, device=str(self.device))
        phase2 = t2.train(data=data, epochs=epochs_unfrozen, **kw)
        return {"phase1": phase1, "phase2": phase2, "status": "completed"}

    def resume_training(self, **kw) -> Dict[str, Any]:
        return self.train(resume=True, **kw)

    def validate(self, data: Optional[str] = None, **kw) -> Dict[str, Any]:
        from yolo_infer_tpu_torch.core.validator import YOLO11Validator

        return YOLO11Validator(model=self.model, output_dir=self.run_dir / "val").validate(
            data or self.config.data, **kw
        )

    # ---------------------------------------------------------------- helpers

    def _select_devices(self) -> List[torch.device]:
        """The devices the training mesh spans, one per process: with no
        process group this trainer's device alone; inside one, a device per
        rank (an index-free "cuda" is card r % cards for rank r, the local
        rank of `torchrun` on one host; an explicit device or the CPU serves
        every rank). Overridden by `MultiChipTrainer`."""
        from yolo_infer_tpu_torch.parallel import distributed as dist

        world = dist.process_count()
        if self.device.type == "cuda" and self.device.index is None and dist.initialized():
            cards = torch.cuda.device_count()
            return [torch.device("cuda", r % cards) for r in range(world)]
        return [self.device] * world

    def _build_mesh(self, cfg):
        """The ('data', 'model') mesh: the data axis is the largest count of
        the selected devices that divides both the batch and the devices (the
        JAX rule), model 1. None with no process group (one device, the
        unmeshed step). Every process must be on the data axis: each is one
        device, and one off the mesh would have no step to run."""
        from yolo_infer_tpu_torch.parallel import distributed as dist
        from yolo_infer_tpu_torch.parallel.mesh import create_mesh

        devices = self._select_devices()
        if not dist.initialized():
            return None
        n_dev = len(devices)
        dp = _data_axis(cfg.batch, n_dev)
        if dp != n_dev:
            raise ValueError(f"the batch {cfg.batch} and the {n_dev} processes share only a data axis of {dp}: "
                             f"each process is one device, so the batch must be divisible by the world size")
        return create_mesh(n_devices=dp, devices=devices[:dp])

    def _freeze_predicate(self) -> Optional[Callable[[str], bool]]:
        freeze = self._freeze
        if freeze is None:
            return None
        if isinstance(freeze, int):
            frozen = {str(i) for i in range(freeze)}
        else:
            frozen = {str(f) for f in freeze}
        return lambda layer_key: layer_key in frozen

    def _validate_ema(self, ts, cfg) -> Dict[str, float]:
        """Score the EMA weights. One predictor serves every epoch: the
        folded, cast EMA weights are copied into its module in place."""
        from yolo_infer_tpu_torch.core.predictor import Predictor
        from yolo_infer_tpu_torch.core.validator import YOLO11Validator
        from yolo_infer_tpu_torch.data.dataset import YOLODataset

        ema = ts.ema_model()
        if self._val_predictor is None:  # on the training mesh: each process serves its slice of every batch
            self._val_predictor = Predictor(ema, ts.spec, device=self.device, compute_dtype=self.model.compute_dtype,
                                            names=self.model.names, mesh=self._mesh)
        else:
            self._val_predictor.load_weights(ema)
        predictor = self._val_predictor
        if self.model.task == "classify":
            from yolo_infer_tpu_torch.data.classify import ClassifyDataset, evaluate_classifier

            try:
                ds = ClassifyDataset(cfg.data, split="val")
            except (FileNotFoundError, ValueError):
                return {"top1": 0.0, "top5": 0.0}
            out = evaluate_classifier(self.model, ds, imgsz=cfg.imgsz, batch=cfg.batch, predictor=predictor)
            return {"top1": out["top1"], "top5": out["top5"]}
        try:
            ds_task = self.model.task if self.model.task in ("segment", "pose", "obb") else "detect"
            val_ds = YOLODataset(cfg.data, split="val", task=ds_task)
        except (FileNotFoundError, ValueError):
            return {"mAP50-95": 0.0, "mAP50": 0.0, "mAP75": 0.0, "precision": 0.0, "recall": 0.0}
        v = YOLO11Validator(model=self.model, output_dir=self.run_dir / "val")
        out = v._validate_dataset(val_ds, predictor=predictor, imgsz=cfg.imgsz, batch=cfg.batch)
        return out["metrics"]

    def _sync_model_from_state(self, ts) -> None:
        # ship the EMA weights: they are what per-epoch validation scored
        # (the raw params stay in the checkpoints for an exact resume)
        self.model.model = ts.ema_model()
        self.model.invalidate()

    def _write_summary(self, history: List[Dict[str, float]], total_time: float) -> None:
        lines = ["Training Summary", "=" * 40, f"epochs: {len(history)}", f"total_time_s: {total_time:.1f}"]
        if history:
            last = history[-1]
            for k, v in last.items():
                if isinstance(v, float):
                    lines.append(f"{k}: {v:.4f}")
        (self.run_dir / "training_summary.txt").write_text("\n".join(lines) + "\n")
        (self.run_dir / "history.json").write_text(json.dumps(history, indent=2, default=float))
        (self.run_dir / "timing.json").write_text(json.dumps(self.timing, indent=2))


def _adapt_head_nc(model, nc: int, names, seed: int = 0) -> None:
    """Swap the model's head for a new class count, keeping every other
    layer's weights (the transfer-learning path): the new head is that of
    `build_model(..., seed=seed)` (a seeded `torch.Generator`)."""
    from yolo_infer_tpu_torch.models.yolo11 import build_model

    fresh, spec = build_model(model.task, model.size, nc, seed=seed)
    for layer in spec.layers[:-1]:
        fresh.model[layer.idx] = model.model.model[layer.idx]
    model.model = fresh.eval()
    model.spec = spec
    model.nc = nc
    model.names = {int(k): v for k, v in names.items()} if isinstance(names, dict) else dict(enumerate(names))
    model.invalidate()


class MultiChipTrainer(YOLO11Trainer):
    """Data-parallel training over chosen cards (the reference's
    MultiGPUTrainer device string). `device_ids` name cards by index:
    `_select_devices` raises `ValueError` for one that names no card (on
    the CPU, `device="cpu"`, each id is one more CPU process and must be >=
    0). Inside an initialized process group, process r trains on card
    `device_ids[r]`, and the caller's group is used as it is (two gloo
    processes may share one card). Outside one, `train()` starts the group:
    one process per device of the mesh (`parallel/distributed.py launch`,
    NCCL on cards, gloo on the CPU, a `FileStore` rendezvous), trains there
    and takes the trained model back from rank 0 into `self.model`.
    Callbacks registered on the trainer do not fire then: they would run in
    the other processes."""

    def __init__(self, *args, device_ids: Optional[Sequence[int]] = None, **kw):
        super().__init__(*args, **kw)
        self.device_ids = None if device_ids is None else [int(i) for i in device_ids]

    def _select_devices(self) -> List[torch.device]:
        """Exactly the devices of `device_ids`, in their order."""
        if self.device_ids is None:
            return super()._select_devices()
        if self.device.type != "cuda":
            bad = [i for i in self.device_ids if i < 0]
            if bad:
                raise ValueError(f"requested device ids {bad} are negative")
            return [self.device] * len(self.device_ids)
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        missing = [i for i in self.device_ids if not 0 <= i < cards]
        if missing:
            raise ValueError(f"requested device ids {missing} not available (have {list(range(cards))})")
        return [torch.device("cuda", i) for i in self.device_ids]

    def train(self, resume: Optional[bool] = None, **overrides) -> Dict[str, Any]:
        from yolo_infer_tpu_torch.core.model import YOLO11Model
        from yolo_infer_tpu_torch.parallel import distributed as dist

        if self.device_ids is None or dist.initialized():
            return super().train(resume=resume, **overrides)
        devices = self._select_devices()
        cfg = dataclasses.replace(self.config, **overrides) if overrides else self.config
        dp = _data_axis(cfg.batch, len(devices))
        m = self.model
        model = YOLO11Model.from_params(copy.deepcopy(m.model).cpu(), task=m.task, size=m.size, nc=m.nc, names=m.names,
                                        fused=False, compute_dtype=m.compute_dtype, device=str(self.device))
        spec = (model, self.config, str(self.run_dir), str(self.device), self.device_ids[:dp], self._freeze,
                self.param_mask, self.distill, resume, overrides)
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
        out = dist.launch(_train_rank, dp, backend=backend, devices=devices[:dp], args=spec, timeout_s=24 * 3600)[0]
        m.model, m.spec, m.nc, m.names = out["model"], out["model"].spec, out["nc"], out["names"]
        m.invalidate()
        return out["result"]


def _data_axis(batch: int, n_devices: int) -> int:
    """The JAX trainer's data axis: the largest count of devices that divides
    both the batch and the devices."""
    return max(d for d in range(1, n_devices + 1) if batch % d == 0 and n_devices % d == 0)


def _from_rank0(value: Any) -> Any:
    """Rank 0's `value` on every process (a picklable object)."""
    box = [value]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def _train_rank(model, config, run_dir, device, device_ids, freeze, param_mask, distill, resume, overrides):
    """One process of `MultiChipTrainer.train`'s own group: the trainer
    rebuilt here, trained; rank 0 hands back the result and the model."""
    from yolo_infer_tpu_torch.parallel import distributed as dist

    trainer = MultiChipTrainer(model=model, config=config, device=device, device_ids=device_ids)
    trainer.run_dir = Path(run_dir)
    trainer._freeze, trainer.param_mask, trainer.distill = freeze, param_mask, distill
    result = trainer.train(resume=resume, **overrides)
    if not dist.is_main_process():
        return None
    return {"result": result, "model": trainer.model.model, "nc": trainer.model.nc, "names": trainer.model.names}


def create_trainer(
    model_path: str = "yolo11n",
    config: Optional[Union[TrainingConfig, Dict[str, Any]]] = None,
    multi_gpu: bool = False,
    **kw,
) -> YOLO11Trainer:
    """Factory: a `MultiChipTrainer` with `multi_gpu` (pass `device_ids=`),
    else a `YOLO11Trainer`."""
    if isinstance(config, dict):
        config = TrainingConfig.from_dict(config)
    cls = MultiChipTrainer if multi_gpu else YOLO11Trainer
    return cls(model_path=model_path, config=config, **kw)
