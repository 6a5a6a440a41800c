"""The training step: forward, loss, backward, SGD update, EMA, finite guard.

Port of `yolo_infer_tpu/core/train_step.py` (`TrainState`, `yolo_sgd`,
`make_optimizer`, `init_train_state`, `make_train_step`). The JAX package
jits the step into one XLA program over a pytree state; the port keeps the
same state as flat f32 buffers on the device, one for each tree:

  params      every parameter of the training module, in `named_parameters`
              order; the module's `Parameter`s are views into it
  bn_state    every batch norm's running mean and variance, in `named_buffers`
              order; the module's buffers are views into it
  opt_state   {"count": int32 0-d, "mom": the momentum buffer, params' layout}
  ema_params  the EMA of params
  step, skipped (int32 0-d), rng (int64 (2,): seed and a counter advanced
  every step; nothing in the step draws from it yet)

so the optimizer is a handful of whole-buffer operations, and a dropped step
is one `torch.where` per buffer. `TrainState.tree()` shows the buffers as the
JAX package's tree names with the port's leaf names (`model.0.conv.weight`,
`model.0.bn.running_mean`, ...); `train_state_from_jax` and
`train_state_to_jax` carry a JAX `TrainState` tree across.

Choices the port makes (each as the JAX step has it):
- Batch-norm state and the finite guard. The training forward returns the new
  running statistics as values (`models/yolo11.py YOLO11.forward`); nothing
  updates them in place. A step whose loss or gradient norm is not finite
  keeps params, optimizer state and batch-norm state bit for bit.
- Clipping is optax's `clip_by_global_norm(10)`: g unchanged below the norm,
  else (g / norm) * 10; not `torch.nn.utils.clip_grad_norm_`'s
  max / (norm + 1e-6).
- Weight decay goes on conv and linear weights with more than one dimension,
  the leaves the JAX package keys "w" (not the transposed conv's "wt", not
  batch-norm scales, not biases). The bias group, whose warmup lr ramps down
  from `warmup_bias_lr`, is the JAX package's "b" and "beta" leaves: every
  port name ending in ".bias" (conv and linear biases, batch-norm betas).
- The freeze mask zeroes the updates of frozen top-level layers after SGD:
  their momentum still accumulates.
- The lr and momentum of a step are computed on the device from the count in
  f32, as the jitted schedule is, so no step reads a value back to the host.

Options of the step, as the JAX package's `make_train_step` has them:
- `qat`: the training forward runs under a "fake" `QuantContext`
  (`nn/quantize.py`): every conv's weights and input fake-quantized with
  straight-through gradients.
- `param_mask`: {parameter name: {0, 1} tensor} (`optimization/pruning.py`
  masks), flattened into the params' layout; after the finite guard it
  multiplies the params and then the EMA, so pruned weights cannot regrow
  through momentum or weight decay.
- `distill`: {"model": the teacher, a folded deploy `YOLO11` in eval mode,
  "temperature", "alpha"}: the teacher runs inside the step under
  `torch.no_grad` (its attention through kernel B on the card), and the loss
  becomes alpha * soft + (1 - alpha) * hard, the soft detect term scaled by
  the batch size as the hard losses are.
- `mesh` (`parallel/mesh.py create_mesh`, inside an initialized process
  group): the step of one rank of a data-parallel (and tensor-parallel)
  step. GSPMD makes the JAX step's reductions global; here the rank's
  forward and loss run under `data_parallel(mesh)`, so batch-norm
  statistics and loss normalizers are those of the global batch and the
  ranks' losses and gradients sum to the JAX package's. The flat gradient
  (this rank's slices of sharded leaves) is then summed over the data axis
  in one all-reduce, and so are the metrics (the loss among them): the clip
  norm (the sharded leaves' squares summed over the model axis, the
  replicated ones counted once) and the finite guard see the global values,
  so every rank keeps or drops the same step and the data ranks' states
  stay equal bit for bit. The collectives run at a world of one too.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from yolo_infer_tpu_torch.core.losses import (
    DEFAULT_HYP,
    classification_loss,
    detection_loss,
    distill_classify_loss,
    distill_detect_loss,
    obb_loss,
    pose_loss,
    segmentation_loss,
)
from yolo_infer_tpu_torch.models.spec import ModelSpec
from yolo_infer_tpu_torch.models.yolo11 import YOLO11, reshape_like
from yolo_infer_tpu_torch.nn.quantize import QuantContext, quant_context
from yolo_infer_tpu_torch.parallel.mesh import Mesh, data_parallel, global_batch

GRAD_CLIP_NORM = 10.0


@dataclasses.dataclass
class Layout:
    """Names, shapes and offsets of the tensors in one flat buffer."""

    names: List[str]
    shapes: List[Tuple[int, ...]]
    offsets: List[int]

    @classmethod
    def of(cls, named: List[Tuple[str, torch.Tensor]]) -> "Layout":
        offsets, n = [], 0
        for _, t in named:
            offsets.append(n)
            n += t.numel()
        return cls([k for k, _ in named], [tuple(t.shape) for _, t in named], offsets)

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: flat[o: o + math.prod(s)].view(s) for k, s, o in zip(self.names, self.shapes, self.offsets)}

    def flatten(self, tree: Dict[str, Any], device) -> torch.Tensor:
        """One flat f32 buffer of `tree[name]` (tensors or numpy arrays) in layout order."""
        missing = [k for k in self.names if k not in tree]
        if missing:
            raise KeyError(f"the tree lacks {missing[:5]}")
        parts = (tree[k].detach().float() if torch.is_tensor(tree[k]) else torch.from_numpy(np.array(tree[k], np.float32))
                 for k in self.names)
        return torch.cat([t.reshape(-1).to(device) for t in parts])


def _schedule_fn(lr: float, lrf: float, total_steps: int, cos_lr: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """optax's `cosine_decay_schedule(lr, T, alpha=lrf)` or
    `linear_schedule(lr, lr*lrf, T)` over all T steps, in f32 on the count's device."""
    total = max(total_steps, 1)
    if cos_lr:
        def decay(count):
            c = torch.clamp(count.float(), max=float(total))
            cosine = 0.5 * (1 + torch.cos(math.pi * c / float(total)))
            return lr * ((1 - lrf) * cosine + lrf)
    else:
        end = lr * lrf

        def decay(count):
            c = torch.clamp(count, 0, total)
            frac = 1 - c.float() / total
            return (lr - end) * frac + end
    return decay


@dataclasses.dataclass
class YoloSGD:
    """The optimizer chain of `make_optimizer`: clip by a global norm of 10 ->
    masked weight decay -> `yolo_sgd` (torch SGD with nesterov and
    the reference's per-group warmup) -> freeze mask."""

    lr: float = 0.01
    lrf: float = 0.01
    total_steps: int = 10_000
    warmup_steps: int = 1000
    momentum: float = 0.937
    weight_decay: float = 5e-4
    cos_lr: bool = True
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    freeze: Optional[Callable[[str], bool]] = None  # top-level layer key ("0".."23") -> frozen

    def __post_init__(self):
        self._decay = _schedule_fn(self.lr, self.lrf, self.total_steps, self.cos_lr)

    def hyperparams(self, count: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(lr of the other groups, lr of the bias group, momentum) at step `count`:
        `np.interp(ni, [0, nw], [0 | warmup_bias_lr, lr(t)])` and
        `np.interp(ni, [0, nw], [warmup_momentum, momentum])` inside warmup."""
        base = self._decay(count)
        nw = float(max(self.warmup_steps, 0))
        if nw == 0:
            return base, base, torch.full_like(base, self.momentum)
        t = count.float()
        frac = torch.clamp(t / nw, 0.0, 1.0)
        in_warm = t <= nw
        mom = torch.where(in_warm, self.warmup_momentum + (self.momentum - self.warmup_momentum) * frac,
                          torch.full_like(frac, self.momentum))
        lr_other = torch.where(in_warm, frac * base, base)
        lr_bias = torch.where(in_warm, self.warmup_bias_lr + frac * (base - self.warmup_bias_lr), base)
        return lr_other, lr_bias, mom

    def masks(self, layout: Layout, device) -> Dict[str, torch.Tensor]:
        """Flat bool masks over params: weight decay, bias group, frozen."""
        decay, bias, frozen = [], [], []
        for name, shape in zip(layout.names, layout.shapes):
            n = math.prod(shape)
            decay.append(torch.full((n,), name.endswith(".weight") and len(shape) > 1
                                    and not name.endswith("upsample.weight")))
            bias.append(torch.full((n,), name.endswith(".bias")))
            frozen.append(torch.full((n,), bool(self.freeze and self.freeze(name.split(".")[1]))))
        return {k: torch.cat(v).to(device) for k, v in (("decay", decay), ("bias", bias), ("frozen", frozen))}

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"count": torch.zeros((), dtype=torch.int32, device=params.device), "mom": torch.zeros_like(params)}

    def update(self, g: torch.Tensor, gnorm: torch.Tensor, opt_state: Dict[str, torch.Tensor], params: torch.Tensor,
               masks: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(new params, new optimizer state) from the flat gradient."""
        g = torch.where(gnorm < GRAD_CLIP_NORM, g, (g / gnorm) * GRAD_CLIP_NORM)
        g = torch.where(masks["decay"], g + self.weight_decay * params, g)
        lr_other, lr_bias, mom_t = self.hyperparams(opt_state["count"])
        new_mom = mom_t * opt_state["mom"] + g
        d = g + mom_t * new_mom  # nesterov
        u = -torch.where(masks["bias"], lr_bias, lr_other) * d
        u = torch.where(masks["frozen"], 0.0, u)
        return params + u, {"count": opt_state["count"] + 1, "mom": new_mom}


def make_optimizer(
    lr: float = 0.01,
    *,
    lrf: float = 0.01,
    total_steps: int = 10_000,
    warmup_steps: int = 1000,
    momentum: float = 0.937,
    weight_decay: float = 5e-4,
    cos_lr: bool = True,
    warmup_momentum: float = 0.8,
    warmup_bias_lr: float = 0.1,
    freeze: Optional[Callable[[str], bool]] = None,
) -> YoloSGD:
    """SGD + nesterov momentum with the reference's warmup, then cosine or
    linear decay to lr*lrf over all steps. warmup_steps <= 0 disables warmup;
    it is capped at total_steps - 1 (at least 1)."""
    warmup_steps = min(max(warmup_steps, 0), max(total_steps - 1, 1))
    return YoloSGD(lr=lr, lrf=lrf, total_steps=total_steps, warmup_steps=warmup_steps, momentum=momentum,
                   weight_decay=weight_decay, cos_lr=cos_lr, warmup_momentum=warmup_momentum,
                   warmup_bias_lr=warmup_bias_lr, freeze=freeze)


@dataclasses.dataclass
class TrainState:
    """The flat training buffers (see the module docstring) and the static
    handles: the training module bound to them, the spec, the optimizer and
    its masks, and the two layouts."""

    params: torch.Tensor
    bn_state: torch.Tensor
    opt_state: Dict[str, torch.Tensor]
    ema_params: torch.Tensor
    step: torch.Tensor
    skipped: torch.Tensor
    rng: torch.Tensor
    module: YOLO11
    spec: ModelSpec
    tx: YoloSGD
    param_layout: Layout
    bn_layout: Layout
    masks: Dict[str, torch.Tensor]

    def tree(self) -> Dict[str, Any]:
        """The JAX package's tree names over views of the buffers."""
        return {
            "params": self.param_layout.views(self.params),
            "bn_state": self.bn_layout.views(self.bn_state),
            "opt_state": {"count": self.opt_state["count"], "mom": self.param_layout.views(self.opt_state["mom"])},
            "ema_params": self.param_layout.views(self.ema_params),
            "step": self.step,
            "skipped": self.skipped,
            "rng": self.rng,
        }

    @torch.no_grad()
    def load_tree(self, tree: Dict[str, Any]) -> "TrainState":
        """Copy a tree of `tree()`'s structure (tensors or numpy arrays, e.g.
        a restored checkpoint) into the buffers, in place."""
        dev = self.params.device
        self.params.copy_(self.param_layout.flatten(tree["params"], dev))
        self.bn_state.copy_(self.bn_layout.flatten(tree["bn_state"], dev))
        self.ema_params.copy_(self.param_layout.flatten(tree["ema_params"], dev))
        self.opt_state["mom"].copy_(self.param_layout.flatten(tree["opt_state"]["mom"], dev))
        for buf, v in ((self.opt_state["count"], tree["opt_state"]["count"]), (self.step, tree["step"]),
                       (self.skipped, tree["skipped"]), (self.rng, tree["rng"])):
            buf.copy_((v if torch.is_tensor(v) else torch.from_numpy(np.array(v))).reshape(buf.shape))
        return self

    def model_from(self, params: torch.Tensor) -> YOLO11:
        """A new CPU `YOLO11` (unfolded, f32, eval mode, of the training
        module's shapes: a slim model's too) holding the flat `params` (the
        live params or the EMA) and the batch-norm state."""
        model = reshape_like(YOLO11(self.spec), dict(zip(self.param_layout.names, self.param_layout.shapes)))
        sd = {**self.param_layout.views(params), **self.bn_layout.views(self.bn_state)}
        missing, unexpected = model.load_state_dict({k: v.detach().cpu() for k, v in sd.items()}, strict=False)
        if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
            raise KeyError(f"the state does not fit the spec: missing {missing[:5]}, unexpected {unexpected[:5]}")
        return model.eval()

    def ema_model(self) -> YOLO11:
        """The EMA weights with the batch-norm state: what validation scores."""
        return self.model_from(self.ema_params)


def init_train_state(model: YOLO11, tx: YoloSGD, *, seed: int = 0,
                     device: Optional[torch.device] = None) -> TrainState:
    """A training state from an unfolded model (the model itself is not
    changed): a f32 copy of it on `device` in training mode, its parameters
    and batch-norm buffers rebound as views of the flat buffers."""
    if any(getattr(m, "bn", 1) is None for m in model.modules()):
        int8 = any(t.dtype == torch.int8 for t in model.state_dict().values())
        raise ValueError("training needs the unfolded model (batch norms present); this is a fused deploy "
                         f"checkpoint{', int8 (quantized)' if int8 else ' (float)'}, which has none")
    module = copy.deepcopy(model).float().to(device).train()
    named_p = list(module.named_parameters())
    named_b = [(n, b) for n, b in module.named_buffers() if n.endswith(("running_mean", "running_var"))]
    p_layout, b_layout = Layout.of(named_p), Layout.of(named_b)
    params = torch.cat([p.detach().reshape(-1) for _, p in named_p]).contiguous()
    bn_state = torch.cat([b.reshape(-1) for _, b in named_b]).contiguous()
    with torch.no_grad():
        for (_, p), v in zip(named_p, p_layout.views(params).values()):
            p.data = v
        for (_, b), v in zip(named_b, b_layout.views(bn_state).values()):
            b.data = v
    dev = params.device
    return TrainState(
        params=params,
        bn_state=bn_state,
        opt_state=tx.init(params),
        ema_params=params.clone(),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        skipped=torch.zeros((), dtype=torch.int32, device=dev),
        rng=torch.tensor([seed, 0], dtype=torch.int64, device=dev),
        module=module,
        spec=module.spec,
        tx=tx,
        param_layout=p_layout,
        bn_layout=b_layout,
        masks=tx.masks(p_layout, dev),
    )


def make_train_step(
    spec: ModelSpec,
    tx: YoloSGD,
    *,
    hyp: Dict[str, float] = DEFAULT_HYP,
    compute_dtype: torch.dtype = torch.bfloat16,
    ema_decay: float = 0.9999,
    ema_ramp: float = 2000.0,
    qat: bool = False,
    param_mask: Any = None,
    distill: Optional[Dict[str, Any]] = None,
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The step function `step(ts, batch) -> (ts, metrics)`. Batch (detect):
    images (B, H, W, 3) uint8 (normalised /255 here) or f32 in [0, 1] |
    boxes (B, M, 4) xyxy px | classes (B, M) | mask (B, M); segment adds
    masks (B, H/4, W/4), pose kpts (B, M, K, 3), OBB has boxes (B, M, 5);
    classify: images, labels (B,); all on the state's device. The state's
    buffers are updated in place and the same state is returned; metrics are
    device tensors. `qat`, `param_mask`, `distill` and `mesh`: see the
    module docstring; under a mesh the batch is this rank's slice
    (`parallel/mesh.py shard_batch`) and the metrics are global."""
    flat_mask: Dict[Any, torch.Tensor] = {}  # (device) -> the mask in the params' layout, made at the first step
    tp_mask: Dict[Any, torch.Tensor] = {}  # (device) -> the params sharded over the model axis, flat
    if mesh is not None:
        mesh.require_groups("a meshed training step")

    def loss_fn(out, batch):
        kw = dict(nc=spec.nc, reg_max=spec.reg_max, strides=spec.strides, hyp=hyp)
        if spec.task == "classify":
            return classification_loss(out["logits"], batch["labels"])
        if spec.task == "segment" and "masks" in batch:
            return segmentation_loss(out, batch, **kw)
        if spec.task == "pose" and "kpts" in batch:
            return pose_loss(out, batch, **kw)
        if spec.task == "obb" and batch["boxes"].shape[-1] == 5:
            return obb_loss(out, batch, **kw)
        return detection_loss(out["feats"], batch, **kw)

    def distill_loss(out, images, loss, metrics):
        with torch.no_grad():
            t_out = distill["model"](images, compute_dtype)
        temperature = float(distill.get("temperature", 4.0))
        alpha = float(distill.get("alpha", 0.7))
        if spec.task == "classify":
            soft = distill_classify_loss(out["logits"], t_out["logits"], temperature)
            kd_metrics = {"loss_kd": soft}
        else:
            soft, kd = distill_detect_loss(out["feats"], t_out["feats"], nc=spec.nc, reg_max=spec.reg_max,
                                           temperature=temperature)
            soft = soft * global_batch(images.shape[0])  # as the hard losses: alpha means the same at any batch
            kd_metrics = {"loss_kd": soft, **kd}
        loss = (1.0 - alpha) * loss + alpha * soft
        return loss, {**metrics, **kd_metrics, "loss": loss}

    def step_fn(ts: TrainState, batch: Dict[str, torch.Tensor]):
        images = batch["images"]
        if images.dtype == torch.uint8:  # loaders ship uint8
            images = images.float() * (1.0 / 255.0)
        with data_parallel(mesh):
            if qat:
                with quant_context(QuantContext("fake")):
                    out, new_bn = ts.module(images, compute_dtype)
            else:
                out, new_bn = ts.module(images, compute_dtype)
            loss, metrics = loss_fn(out, batch)
            if distill is not None:
                loss, metrics = distill_loss(out, images, loss, metrics)
        grads = torch.autograd.grad(loss, list(ts.module.parameters()))
        with torch.no_grad():
            g = torch.cat([x.reshape(-1) for x in grads])
            if mesh is not None:  # this rank's parts -> the global loss, metrics and gradient
                metrics = _sum_over(metrics, mesh.data_group)
                loss = metrics["loss"]
                dist.all_reduce(g, group=mesh.data_group)
            # guard on the gradient too: a finite loss can have inf/NaN grads.
            # optax's global norm, sqrt of the sum of squares: torch's CPU
            # `vector_norm` accumulates 2.6M squares to 4e-5 relative error
            if mesh is not None and mesh.shape["model"] > 1:
                dev = g.device
                if dev not in tp_mask:
                    tp_mask[dev] = _sharded_mask(ts, dev)
                gnorm = _global_norm_tp(g, tp_mask[dev], mesh.model_group)
            else:
                gnorm = torch.sqrt(torch.sum(g * g))
            finite = torch.isfinite(loss) & torch.isfinite(gnorm)
            new_params, new_opt = ts.tx.update(g, gnorm, ts.opt_state, ts.params, ts.masks)
            new_bn_flat = torch.cat([new_bn[k].reshape(-1) for k in ts.bn_layout.names])
            ts.params.copy_(torch.where(finite, new_params, ts.params))
            ts.opt_state["mom"].copy_(torch.where(finite, new_opt["mom"], ts.opt_state["mom"]))
            ts.opt_state["count"].copy_(torch.where(finite, new_opt["count"], ts.opt_state["count"]))
            ts.bn_state.copy_(torch.where(finite, new_bn_flat, ts.bn_state))
            if param_mask is not None:  # pruning: pinned zeros survive the update
                dev = ts.params.device
                if dev not in flat_mask:
                    flat_mask[dev] = ts.param_layout.flatten(param_mask, dev)
                ts.params.mul_(flat_mask[dev])
            ts.step.add_(1)
            d = ema_decay * (1.0 - torch.exp(-ts.step.float() / ema_ramp))
            ts.ema_params.copy_(torch.where(finite, ts.ema_params * d + ts.params * (1.0 - d), ts.ema_params))
            if param_mask is not None:
                ts.ema_params.mul_(flat_mask[ts.params.device])
            ts.skipped.add_((~finite).to(torch.int32))
            ts.rng[1] += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["step_skipped"] = (~finite).to(torch.int32)
        return ts, metrics

    return step_fn


def _sum_over(metrics: Dict[str, torch.Tensor], group: Any) -> Dict[str, torch.Tensor]:
    """Every metric summed over `group` in one all-reduce (each rank's losses
    are its parts of the global ones), in its own dtype."""
    keys = sorted(metrics)
    vec = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(vec, group=group)
    return {k: vec[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


def _sharded_mask(ts: TrainState, device) -> torch.Tensor:
    """Flat bool over the params: the leaves sharded over the model axis
    (`parallel/mesh.py shard_params`)."""
    sharded = {f"{name}.{leaf}" for name, m in ts.module.named_modules() if getattr(m, "tp", None) is not None
               for leaf in m.tp.leaves}
    return torch.cat([torch.full((math.prod(s),), n in sharded, device=device)
                      for n, s in zip(ts.param_layout.names, ts.param_layout.shapes)])


def _global_norm_tp(g: torch.Tensor, sharded: torch.Tensor, model_group: Any) -> torch.Tensor:
    """The global norm of a gradient whose sharded leaves hold this rank's
    slices: their squares summed over the model axis, the replicated leaves'
    (equal on every rank of it) counted once."""
    sq = g * g
    zero = torch.zeros((), dtype=sq.dtype, device=sq.device)
    shard_sq = torch.sum(torch.where(sharded, sq, zero)).reshape(1)
    dist.all_reduce(shard_sq, group=model_group)
    return torch.sqrt(shard_sq[0] + torch.sum(torch.where(sharded, zero, sq)))


# ---------------------------------------------------------------------------
# JAX TrainState trees <-> the port's state
# ---------------------------------------------------------------------------

def _sgd_state(opt_state: Any) -> Dict[str, Any]:
    """The `yolo_sgd` entry ({"count", "mom"}) of a JAX optimizer chain state
    (a tuple, or its checkpoint form, a dict keyed "0", "1", ...)."""
    if isinstance(opt_state, dict):
        if "count" in opt_state and "mom" in opt_state:
            return opt_state
        opt_state = list(opt_state.values())
    for e in opt_state:
        if isinstance(e, dict) and "count" in e and "mom" in e:
            return e
    raise ValueError("no yolo_sgd state (count, mom) in the optimizer state")


def train_state_from_jax(tree: Dict[str, Any], ts: TrainState) -> TrainState:
    """Copy a JAX `TrainState.tree()` (numpy leaves) into the port's state:
    params, batch-norm state, momentum, EMA, count, step and skipped. The
    JAX PRNG key is not carried (the port's `rng` is its own counter)."""
    from yolo_infer_tpu_torch.models.convert import state_dict_from_jax

    spec, bn = ts.spec, tree["bn_state"]

    def port(p):
        return state_dict_from_jax(p, spec, bn)

    sgd = _sgd_state(tree["opt_state"])
    sd = port(tree["params"])
    ts.load_tree({
        "params": sd,
        "bn_state": sd,
        "opt_state": {"count": np.asarray(sgd["count"]), "mom": port(sgd["mom"])},
        "ema_params": port(tree["ema_params"]),
        "step": np.asarray(tree["step"]),
        "skipped": np.asarray(tree["skipped"]),
        "rng": ts.rng.cpu().numpy(),
    })
    return ts


def train_state_to_jax(ts: TrainState) -> Dict[str, Any]:
    """The port's params, EMA and batch-norm state as the JAX package's
    trees: {"params", "bn_state", "ema_params"} (numpy leaves)."""
    from yolo_infer_tpu_torch.models.convert import params_to_jax

    params, bn_state = params_to_jax(ts.model_from(ts.params), ts.spec, fused=False)
    ema_params, _ = params_to_jax(ts.ema_model(), ts.spec, fused=False)
    return {"params": params, "bn_state": bn_state, "ema_params": ema_params}
