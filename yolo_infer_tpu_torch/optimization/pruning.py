"""Pruning: magnitude, unstructured, structured and gradual masks, and the
physical (surgery) path.

Port of `yolo_infer_tpu/optimization/pruning.py` (`magnitude_masks`,
`channel_masks`, `apply_masks`, `combine_masks`, `sparsity_report`,
`gradual_sparsity_schedule`, `PruningOptimizer`, `create_pruner`). A mask is
{parameter name: f32 {0, 1} tensor} over every `named_parameters()` entry of
a `YOLO11` (the JAX package's params leaves; all-ones where nothing is
pruned). Pruned coordinates are zeroed, not removed: shapes stay, and during
a fine-tune the train step multiplies params and EMA by the mask after every
update (`core/train_step.py param_mask`), so pruned weights cannot regrow.
`physical: true` with the structured method removes channels instead
(`optimization/surgery.py`).

The prunable surface is the JAX package's: on an unfolded model every `Conv`
with its batch norm; on a folded one every `Conv` (the head branches' output
projections are `HeadConv2d`, the classifier a `Linear`, and neither is a
`Conv`: pruning them would delete outputs, not capacity). int8 convs are
never prunable. The masks are computed on the model's JAX-layout tree
(`models/convert.py params_to_jax`) walked in a JAX pytree's order (sorted
keys) by the JAX package's own numpy arithmetic, so they are its masks bit
for bit, ties included (`np.argpartition` and `np.argsort` on the same
arrays).
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from yolo_infer_tpu_torch.core.model import _has_batch_norms
from yolo_infer_tpu_torch.models import blocks as B
from yolo_infer_tpu_torch.models.convert import params_to_jax, state_dict_from_jax
from yolo_infer_tpu_torch.optimization.base import BaseOptimizer, OptimizationRegistry
from yolo_infer_tpu_torch.optimization.surgery import _tree_map

logger = logging.getLogger(__name__)

METHODS = ("magnitude", "structured", "unstructured", "gradual")

Masks = Dict[str, torch.Tensor]


def _prunable(model, fused: bool = False) -> List[Tuple[str, B.Conv]]:
    """(name, Conv) of every prunable conv."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, B.Conv) and not m.quantized and ((m.bn is None) if fused else (m.bn is not None))]


def _sorted_tree(t: Any) -> Any:
    """A JAX-layout tree with every dict's keys in sorted order, the order a
    JAX pytree (anything `jax.tree_util.tree_map` returns, a restored
    checkpoint) keeps: the order in which the JAX package ranks."""
    if isinstance(t, dict):
        return {k: _sorted_tree(t[k]) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return [_sorted_tree(v) for v in t]
    return t


def _is_conv(d: Any) -> bool:
    return isinstance(d, dict) and "w" in d


def _iter_prunable(params: Any, masks: Any, fused: bool):
    """(conv dict, parallel mask dict) of every prunable conv of a JAX-layout
    tree: the JAX package's `_iter_prunable`."""

    def walk(p, m, skip):
        if isinstance(p, dict):
            if _is_conv(p):
                if (not skip and "b" in p) if fused else ("gamma" in p):
                    yield p, m
                return
            for k in p:
                yield from walk(p[k], m[k], skip or k == "linear")
        elif isinstance(p, (list, tuple)):
            is_branch = len(p) > 0 and all(_is_conv(v) for v in p)
            for i, v in enumerate(p):
                yield from walk(v, m[i], skip or (is_branch and i == len(p) - 1))

    yield from walk(params, masks, False)


def _tree_masks(model, fused: bool):
    """(the model's JAX-layout f32 params tree in JAX's order, a tree of ones
    beside it, and the state tree or None)."""
    f32 = copy.deepcopy(model).float()
    params, state = params_to_jax(f32, model.spec, fused=not _has_batch_norms(f32))
    params = _sorted_tree(params)
    ones = {k: _tree_map(lambda x: np.ones(np.shape(x), np.float32), v) for k, v in params.items()}
    return params, ones, state


def _port_masks(masks_tree, model, state) -> Masks:
    """A JAX-layout mask tree as {parameter name: tensor} of the model."""
    ones_state = None if state is None else _tree_map(lambda x: np.ones(np.shape(x), np.float32), state)
    sd = state_dict_from_jax(masks_tree, model.spec, ones_state)
    return {n: torch.from_numpy(np.ascontiguousarray(sd[n], np.float32)) for n, _ in model.named_parameters()}


def _exact_k_zero_mask(flat_mags: np.ndarray, k: int) -> np.ndarray:
    """Boolean zero-mask of EXACTLY k smallest-magnitude entries (ties broken
    by `np.argpartition`, as the JAX package breaks them)."""
    zero = np.zeros(flat_mags.size, bool)
    if k >= flat_mags.size:
        zero[:] = True
    elif k > 0:
        zero[np.argpartition(flat_mags, k - 1)[:k]] = True
    return zero


def magnitude_masks(model, sparsity: float, scope: str = "global", fused: bool = False) -> Masks:
    """Weight masks zeroing the smallest-|w| fraction: scope "global" ranks
    every prunable conv's weights in one pool (the magnitude method), "layer"
    each conv on its own (the unstructured method). Exactly floor(sparsity *
    n) weights are zeroed per pool."""
    sparsity = float(np.clip(sparsity, 0.0, 1.0))
    params, masks, state = _tree_masks(model, fused)
    pairs = list(_iter_prunable(params, masks, fused))
    if pairs and sparsity > 0.0:
        mags = [np.abs(np.asarray(c["w"], np.float32)).reshape(-1) for c, _ in pairs]
        if scope == "global":
            flat = np.concatenate(mags)
            zero = _exact_k_zero_mask(flat, int(sparsity * flat.size))
            off = 0
            for (conv, m), w in zip(pairs, mags):
                z = zero[off: off + w.size]
                off += w.size
                m["w"] = (~z).astype(np.float32).reshape(np.shape(conv["w"]))
        else:
            for (conv, m), w in zip(pairs, mags):
                zero = _exact_k_zero_mask(w, int(sparsity * w.size))
                m["w"] = (~zero).astype(np.float32).reshape(np.shape(conv["w"]))
    return _port_masks(masks, model, state)


def channel_masks(model, sparsity: float, fused: bool = False) -> Masks:
    """Structured masks zeroing whole output channels, lowest L2 norm of
    w[..., c] first, in the weights and the channel's affine tail (batch-norm
    scale and shift, or the folded bias), so the channel's output is
    identically zero after SiLU. At least one channel per conv survives."""
    sparsity = float(np.clip(sparsity, 0.0, 1.0))
    params, masks, state = _tree_masks(model, fused)
    if sparsity > 0.0:
        for conv, m in _iter_prunable(params, masks, fused):
            w = np.asarray(conv["w"], np.float32)
            c_out = w.shape[-1]
            norms = np.sqrt((w.reshape(-1, c_out) ** 2).sum(axis=0))
            n_prune = min(int(sparsity * c_out), c_out - 1)
            if n_prune <= 0:
                continue
            ch = np.ones(c_out, np.float32)
            ch[np.argsort(norms)[:n_prune]] = 0.0
            m["w"] = np.broadcast_to(ch, w.shape).copy()
            for key in ("gamma", "beta", "b"):
                if key in conv:
                    m[key] = ch.copy()
    return _port_masks(masks, model, state)


@torch.no_grad()
def apply_masks(model, masks: Masks):
    """params * masks in place, each parameter keeping its dtype; returns the model."""
    for name, p in model.named_parameters():
        if name in masks:
            p.mul_(masks[name].to(p.device, p.dtype))
    return model


def combine_masks(a: Masks, b: Masks) -> Masks:
    return {k: a[k] * b[k] for k in a}


def sparsity_report(model, fused: bool = False) -> Dict[str, float]:
    """Achieved sparsity over the prunable surface, and zeros over every parameter."""
    prunable_total = prunable_zero = 0
    for _, m in _prunable(model, fused):
        prunable_total += m.conv.weight.numel()
        prunable_zero += int((m.conv.weight == 0).sum())
    params = [p for _, p in model.named_parameters()]
    total = sum(p.numel() for p in params)
    zeros = sum(int((p == 0).sum()) for p in params)
    return {
        "prunable_params": prunable_total,
        "prunable_zeros": prunable_zero,
        "prunable_sparsity": prunable_zero / max(prunable_total, 1),
        "total_params": total,
        "total_zeros": zeros,
        "total_sparsity": zeros / max(total, 1),
    }


def gradual_sparsity_schedule(si: float, sf: float, t: float) -> float:
    """Zhu & Gupta's cubic ramp: s(t) = sf + (si - sf) * (1 - t)^3, t in [0, 1]."""
    t = float(np.clip(t, 0.0, 1.0))
    return sf + (si - sf) * (1.0 - t) ** 3


class PruningOptimizer(BaseOptimizer):
    """Mask-based pruning over the YOLO11 conv stack. Config keys:
      method            magnitude | unstructured | structured | gradual
      sparsity          target fraction of prunable weights zeroed (0.5)
      initial_sparsity  gradual start point (0.0)
      prune_rounds      gradual: prune -> fine-tune rounds (4)
      fine_tune_lr      lr of the fine-tune (1e-3)
      physical, align   structured only: channel surgery (`optimization/surgery.py`)

    `optimize(data=None, epochs=4, **train_kw)`: without data a one-shot
    prune; with data, prune then fine-tune with the mask held in the step;
    "gradual" ramps the sparsity over `prune_rounds` rounds of `epochs //
    prune_rounds` epochs each. A folded model prunes only (no fine-tune)."""

    METHODS = METHODS

    def __init__(self, model: Any, config: Optional[Dict[str, Any]] = None):
        super().__init__(model, config)
        self.method = self.config.get("method", "magnitude")
        if self.method not in METHODS:
            raise ValueError(f"method {self.method!r} not in {METHODS}")
        self.sparsity = float(self.config.get("sparsity", 0.5))
        self.initial_sparsity = float(self.config.get("initial_sparsity", 0.0))
        self.prune_rounds = int(self.config.get("prune_rounds", 4))
        self.fine_tune_lr = float(self.config.get("fine_tune_lr", 1e-3))
        self.physical = bool(self.config.get("physical", False))
        self.align = int(self.config.get("align", 8))
        if self.physical and self.method != "structured":
            raise ValueError("physical surgery requires method='structured'")
        self.masks: Optional[Masks] = None

    def _masks_at(self, model, sparsity: float, fused: bool = False) -> Masks:
        if self.method == "structured":
            return channel_masks(model, sparsity, fused=fused)
        return magnitude_masks(model, sparsity, scope="layer" if self.method == "unstructured" else "global",
                               fused=fused)

    def _wrap(self, module, fused: bool, suffix: str):
        from yolo_infer_tpu_torch.core.model import YOLO11Model

        m = self.model
        return YOLO11Model.from_params(module, task=m.task, size=m.size, nc=m.nc, names=m.names, fused=fused,
                                       compute_dtype=m.compute_dtype, model_path=f"{m.model_path}-{suffix}",
                                       device=m.device, mask_mode=m.mask_mode)

    def _student_copy(self):
        """A trainable copy of the model (the original stays for `compare_models`)."""
        if not _has_batch_norms(self.model.model):
            raise ValueError("fine-tuning a pruned model needs training-form (unfused) params; "
                             f"{self.model.model_path!r} was loaded fused — re-load the unfused checkpoint")
        return self._wrap(copy.deepcopy(self.model.model), False, "pruned")

    def _fine_tune(self, student, masks, data: str, epochs: int, **train_kw) -> Dict[str, Any]:
        from yolo_infer_tpu_torch.core.trainer import TrainingConfig, YOLO11Trainer

        cfg = TrainingConfig(data=data, epochs=epochs, lr0=train_kw.pop("lr0", self.fine_tune_lr),
                             warmup_epochs=train_kw.pop("warmup_epochs", 0.0), mosaic=train_kw.pop("mosaic", 0.0),
                             **train_kw)
        trainer = YOLO11Trainer(model=student, config=cfg)
        trainer.param_mask = masks  # held in the step
        return trainer.train()

    def _optimize_physical(self, data: Optional[str], epochs: int, **train_kw) -> Any:
        from yolo_infer_tpu_torch.optimization.surgery import slim_model

        m = self.model
        unfused = _has_batch_norms(m.model)
        slim, _, rep = slim_model(m.model if unfused else m.deploy_model, keep_frac=1.0 - self.sparsity,
                                  align=self.align)
        student = self._wrap(slim, not unfused, "slim")
        fine_tune_info = None
        if data:
            if not unfused:
                raise ValueError("fine-tuning a slimmed model needs training-form (unfused) params")
            out = self._fine_tune(student, None, data, epochs, **train_kw)  # the slim model needs no masks
            fine_tune_info = {k: v for k, v in out.items() if k in ("status", "epochs_completed", "best_fitness")}
        self.optimized_model = student
        self.optimization_info = {"method": "structured-physical", "target_sparsity": self.sparsity, "surgery": rep,
                                  "fine_tune": fine_tune_info}
        return student

    def optimize(self, data: Optional[str] = None, epochs: int = 4, **train_kw) -> Any:
        if self.physical:
            return self._optimize_physical(data, epochs, **train_kw)
        model_fused = not _has_batch_norms(self.model.model)
        before = sparsity_report(self.model.deploy_model if model_fused else self.model.model, fused=model_fused)

        if self.method == "gradual" and data:
            student = self._student_copy()
            rounds = max(self.prune_rounds, 1)
            per_round = max(epochs // rounds, 1)
            history = []
            for r in range(rounds):
                s_t = gradual_sparsity_schedule(self.initial_sparsity, self.sparsity, (r + 1) / rounds)
                self.masks = self._masks_at(student.model, s_t)
                apply_masks(student.model, self.masks)
                student.invalidate()
                out = self._fine_tune(student, self.masks, data, per_round, exist_ok=True, **train_kw)
                history.append({"round": r, "sparsity": s_t, "epochs": per_round,
                                "loss": (out["history"][-1].get("loss") if out["history"] else None)})
                logger.info("gradual prune round %d/%d: sparsity %.3f", r + 1, rounds, s_t)
            fine_tune_info: Any = history
        else:
            if not model_fused:
                student = self._student_copy()
            elif data:
                # fine-tuning needs the batch-norm state, which a folded model has lost
                raise ValueError("fine-tuning a pruned model needs training-form (unfused) params; "
                                 f"{self.model.model_path!r} was loaded fused — re-load the unfused checkpoint, "
                                 "or call optimize() without data for prune-only")
            else:  # a folded model: prune-only on the deploy form
                student = self._wrap(copy.deepcopy(self.model.deploy_model), True, "pruned")
            self.masks = self._masks_at(student.model, self.sparsity, fused=model_fused)
            apply_masks(student.model, self.masks)
            student.invalidate()
            if model_fused:
                student._deploy_model = student.model
            fine_tune_info = None
            if data:
                out = self._fine_tune(student, self.masks, data, epochs, **train_kw)
                fine_tune_info = {k: v for k, v in out.items() if k in ("status", "epochs_completed", "best_fitness")}

        student_fused = not _has_batch_norms(student.model)
        after = sparsity_report(student.model, fused=student_fused)
        self.optimized_model = student
        self.optimization_info = {"method": self.method, "target_sparsity": self.sparsity, "before": before,
                                  "after": after, "fine_tune": fine_tune_info}
        return student


OptimizationRegistry.register("prune", PruningOptimizer)


def create_pruner(model: Any, config: Optional[Dict[str, Any]] = None) -> PruningOptimizer:
    return PruningOptimizer(model, config)
