"""The multi-device dry run: one training step of yolo11n detect over a
('data', 'model') mesh of processes.

Port of `__graft_entry__.py dryrun_multichip`: tp = 2 when n is even (wide
convs' output channels over the model axis), the batch over the data axis,
one step at 64 px with one box per image (bf16 compute, the optimizer of
`init_train_state`), a finite-loss check and the same line printed. It runs
on cards unless the caller passes `device="cpu"`, and raises with no card.
Inside an initialized group of n processes it runs in each, on the
process's current CUDA device (the caller's choice: two gloo processes may
share one card) or on the CPU. Outside one, `dryrun_multichip(n)` starts n
processes (`distributed.launch`): process r on card r over NCCL, which needs
n cards (to share fewer, start the group yourself), or on the CPU over gloo.

    python -c "from yolo_infer_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2)"
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from yolo_infer_tpu_torch.parallel import distributed as dist


def dryrun_multichip(n_devices: int, model: Optional[torch.nn.Module] = None,
                     compute_dtype: torch.dtype = torch.bfloat16, device: Optional[str] = None) -> float:
    """Run the step over n_devices processes and return the step's (global)
    loss. `model` is the starting yolo11n detect `YOLO11` (default: the
    seeded `build_model("detect", "n", seed=0)`); `compute_dtype` that of
    the forward (bf16, as the JAX dry run's; f32 to hold the step to JAX's
    at f32 precision); `device` "cuda" (the default) or "cpu"."""
    kind = torch.device(device or "cuda").type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU explicitly")
    args = (n_devices, model, compute_dtype, kind)
    if dist.initialized():
        return _dryrun_rank(*args)
    if kind == "cpu":
        return dist.launch(_dryrun_rank, n_devices, backend="gloo", devices="cpu", args=args)[0]
    cards = torch.cuda.device_count()
    if cards < n_devices:
        raise ValueError(f"{n_devices} processes need {n_devices} cards and this host has {cards}: to share "
                         "fewer, start the process group yourself and call dryrun_multichip inside it")
    return dist.launch(_dryrun_rank, n_devices, backend="nccl", devices=[f"cuda:{i}" for i in range(n_devices)],
                       args=args)[0]


def _dryrun_rank(n_devices: int, model: Optional[torch.nn.Module], compute_dtype: torch.dtype, kind: str) -> float:
    from yolo_infer_tpu_torch.core.train_step import init_train_state, make_optimizer, make_train_step
    from yolo_infer_tpu_torch.models.yolo11 import build_model
    from yolo_infer_tpu_torch.parallel.mesh import create_mesh, shard_batch, shard_params

    tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = create_mesh(n_devices=n_devices, tp=tp)
    if model is None:
        model, _ = build_model("detect", "n", seed=0)
    device = torch.device("cuda", torch.cuda.current_device()) if kind == "cuda" else torch.device("cpu")
    tx = make_optimizer(0.01, total_steps=10_000, warmup_steps=1000)  # the JAX `init_train_state`'s defaults
    ts = init_train_state(shard_params(model, mesh), tx, device=device)
    step = make_train_step(model.spec, tx, compute_dtype=compute_dtype, mesh=mesh)
    b = 2 * mesh.shape["data"]
    max_boxes = 8
    batch = {
        "images": np.random.default_rng(0).uniform(0, 1, (b, 64, 64, 3)).astype(np.float32),
        "boxes": np.zeros((b, max_boxes, 4), np.float32),  # xyxy, letterboxed px
        "classes": np.zeros((b, max_boxes), np.int32),
        "mask": np.zeros((b, max_boxes), np.bool_),
    }
    batch["boxes"][:, 0] = [8.0, 8.0, 40.0, 48.0]  # one real box per image
    batch["mask"][:, 0] = True
    batch = {k: torch.from_numpy(v).to(device) for k, v in shard_batch(batch, mesh).items()}
    ts, metrics = step(ts, batch)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if dist.is_main_process():
        print(f"dryrun_multichip ok: n={n_devices} mesh={dict(mesh.shape)} loss={loss:.4f}")
    return loss
