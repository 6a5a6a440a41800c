"""Rank functions of the port's multi-process tests (`tests/test_torch_parallel*.py`).

`parallel/distributed.py launch` runs each in new processes (the `spawn`
start method), joined in one gloo group over a `FileStore`; a rank that
fails or hangs fails the launch within its `timeout_s`. They import torch,
numpy and the port only: a spawned process imports this module, and the
test modules import JAX. What they return comes back by value (numpy arrays,
tensors, plain objects).
"""

import time

import numpy as np
import torch

TIMEOUT_S = 240.0  # a launch of these tests takes seconds; a hung rank fails it at this limit


# ---------------------------------------------------------------------------
# distributed helpers
# ---------------------------------------------------------------------------

def helpers_rank():
    from yolo_infer_tpu_torch.parallel import distributed as dist

    rank = dist.process_index()
    out = {"index": rank, "count": dist.process_count(), "main": dist.is_main_process(),
           "bcast0": dist.broadcast_scalar(10.0 + rank), "bcast1": dist.broadcast_scalar(10.0 + rank, root=1),
           **{op: dist.all_reduce_scalar(1.5 * (rank + 1), op) for op in ("sum", "max", "min")}}
    try:
        dist.all_reduce_scalar(1.0, "mean")
    except ValueError:
        out["bad_op_raises"] = True
    if rank == 1:
        time.sleep(2.0)
    t0 = time.perf_counter()
    dist.sync_processes()
    out["sync_wait_s"] = time.perf_counter() - t0  # rank 0 waits for rank 1's sleep
    return out


def failing_rank():
    from yolo_infer_tpu_torch.parallel import distributed as dist

    if dist.process_index() == 1:
        raise ArithmeticError("rank 1 fails on purpose")
    dist.sync_processes()  # rank 0 waits here for a rank that never comes


def dying_rank():
    import os

    from yolo_infer_tpu_torch.parallel import distributed as dist

    if dist.process_index() == 1:
        os._exit(3)  # gone without a report, as a process the system kills
    dist.sync_processes()


def hanging_rank():
    from yolo_infer_tpu_torch.parallel import distributed as dist

    if dist.process_index() == 1:
        time.sleep(600)
    return dist.process_index()


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def step_batch(b=4, imgsz=64, m=6, seed=1, nc=3):
    """A detect batch whose images hold unequal target counts (5, 1, 3, 2, ...)
    of 30-60 px boxes: the two halves of the batch have different
    target-score sums (2.8 and 3.9 at yolo11n's seeded state), so a rank that
    normalised by its own would differ from the global step. (Boxes of 6-30
    px sum below 1 there, and the clamp to >= 1 would hide the normalizer.)"""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 34, (b, m, 2))
    wh = rng.uniform(30, 60, (b, m, 2))
    mask = np.zeros((b, m), bool)
    for i in range(b):
        mask[i, : (5, 1, 3, 2)[i % 4]] = True
    return {"images": rng.integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8),
            "boxes": np.concatenate([xy, np.minimum(xy + wh, imgsz)], -1).astype(np.float32),
            "classes": rng.integers(0, nc, (b, m)).astype(np.int32), "mask": mask}


def dryrun_batch(b=2):
    """`__graft_entry__.dryrun_multichip`'s batch: 64 px, one box per image."""
    batch = {"images": np.random.default_rng(0).uniform(0, 1, (b, 64, 64, 3)).astype(np.float32),
             "boxes": np.zeros((b, 8, 4), np.float32), "classes": np.zeros((b, 8), np.int32),
             "mask": np.zeros((b, 8), np.bool_)}
    batch["boxes"][:, 0] = [8.0, 8.0, 40.0, 48.0]
    batch["mask"][:, 0] = True
    return batch


def port_state(model, tx):
    from yolo_infer_tpu_torch.core.train_step import init_train_state

    return init_train_state(model, tx, device="cpu")


def one_step(model, batch, mesh=None, tx_kw=None):
    """One f32 step from `model` on `batch` (this rank's slice under a mesh):
    (loss, metrics, the params' update as {name: array}, bn_state as {name:
    array}, skipped) in this rank's layout."""
    from yolo_infer_tpu_torch.core.train_step import make_optimizer, make_train_step
    from yolo_infer_tpu_torch.parallel.mesh import shard_batch, shard_params

    tx = make_optimizer(0.01, **(tx_kw or {"total_steps": 10, "warmup_steps": 0}))
    local = model if mesh is None else shard_params(model, mesh)
    ts = port_state(local, tx)
    before = ts.params.clone()
    step = make_train_step(local.spec, tx, compute_dtype=torch.float32, mesh=mesh)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    ts, metrics = step(ts, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
    update = {k: v.numpy().copy() for k, v in ts.param_layout.views(ts.params - before).items()}
    bn = {k: v.numpy().copy() for k, v in ts.bn_layout.views(ts.bn_state).items()}
    return {"loss": float(metrics["loss"]), "metrics": {k: float(v) for k, v in metrics.items()}, "update": update,
            "bn": bn, "skipped": int(ts.skipped), "count": int(ts.opt_state["count"])}


def train_step_ranks(model, batch, cls_model, cls_batch):
    """Every meshed step the tests hold, from one starting model: the DP step
    (dp 2); the same with the loss normalizers left per rank, and with the
    batch-norm statistics left per rank (the negative controls); the DP step
    with a non-finite loss on rank 1 alone; the TP step (tp 2) on the whole
    batch; the TP step of a classify model (`cls_model`, 1000 classes: its
    linear bias sharded too) on `cls_batch`."""
    import yolo_infer_tpu_torch.core.losses as losses
    import yolo_infer_tpu_torch.core.train_step as train_step
    import yolo_infer_tpu_torch.models.blocks as blocks
    from yolo_infer_tpu_torch.parallel import distributed as dist
    from yolo_infer_tpu_torch.parallel.mesh import create_mesh

    dp_mesh = create_mesh()
    out = {"dp": one_step(model, batch, dp_mesh)}

    real_sum = losses.data_sum
    losses.data_sum = lambda t: t  # each rank's own normalizers
    try:
        out["local_normalizers"] = one_step(model, batch, dp_mesh)
    finally:
        losses.data_sum = real_sum

    real_stats = blocks.data_mean_var

    def local_stats(y, dims):
        var, mean = torch.var_mean(y, dim=tuple(dims), correction=0)
        return mean, var, y.numel() // y.shape[1]

    blocks.data_mean_var = local_stats  # each rank's own batch statistics
    try:
        out["local_bn"] = one_step(model, batch, dp_mesh)
    finally:
        blocks.data_mean_var = real_stats

    real_loss = train_step.detection_loss

    def nan_on_rank1(*a, **kw):
        total, metrics = real_loss(*a, **kw)
        bad = total * float("nan") if dist.process_index() == 1 else total
        return bad, {**metrics, "loss": bad}

    train_step.detection_loss = nan_on_rank1
    try:
        out["nonfinite"] = one_step(model, batch, dp_mesh)
    finally:
        train_step.detection_loss = real_loss

    out["tp"] = one_step(model, batch, create_mesh(tp=2))
    out["tp_sharded"] = sorted(n for n, m in _tp_convs(model))
    out["tp_classify"] = one_step(cls_model, cls_batch, create_mesh(tp=2))
    return out


def classify_batch(b=4, imgsz=64, nc=1000, seed=2):
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8),
            "labels": rng.integers(0, nc, (b,)).astype(np.int32)}


def f64_net():
    """A small net in f64, training mode, with every kind of layer that
    shards at tp = 2: conv blocks (a 256-channel 1x1, a 256-channel
    depthwise 3x3), a head's 256-channel output projection and a classify
    head of 256 classes (its 256-channel conv and its linear bias)."""
    from yolo_infer_tpu_torch.models.blocks import Classify, Conv, HeadConv2d

    torch.manual_seed(0)
    return torch.nn.Sequential(Conv(3, 8, 3), Conv(8, 256, 1), Conv(256, 256, 3, g=256),
                               HeadConv2d(256, 256, 3, 2, 1), Conv(256, 16, 1),
                               Classify(16, 256, 256)).double().train()


def f64_grads(x, w, mesh=None):
    """Loss sum(net(x) * w) / global batch and its gradient ({name: local
    tensor}, summed over the data axis), all in f64: the batch norms'
    statistics too, which the blocks take in f32 (`Tensor.float` is made to
    keep f64 while this runs)."""
    import torch.distributed as td

    from yolo_infer_tpu_torch.parallel.mesh import data_parallel, global_batch, shard_batch, shard_params

    real_float = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **kw: t if t.dtype == torch.float64 else real_float(t, *a, **kw)
    try:
        net = f64_net() if mesh is None else shard_params(f64_net(), mesh)
        if mesh is not None:
            x, w = shard_batch(x, mesh), shard_batch(w, mesh)
        with data_parallel(mesh):
            loss = (net(x) * w).sum() / global_batch(x.shape[0])
        names = [n for n, _ in net.named_parameters()]
        grads = torch.autograd.grad(loss, list(net.parameters()))
    finally:
        torch.Tensor.float = real_float
    loss = loss.detach().reshape(1).clone()
    if mesh is not None:
        td.all_reduce(loss, group=mesh.data_group)
        for g in grads:
            td.all_reduce(g, group=mesh.data_group)
    return float(loss), dict(zip(names, grads))


def f64_rank(x, w, tp):
    from yolo_infer_tpu_torch.parallel.mesh import create_mesh

    return f64_grads(x, w, create_mesh(tp=tp))


def _tp_convs(model):
    from yolo_infer_tpu_torch.models.blocks import Conv
    from yolo_infer_tpu_torch.parallel.mesh import param_pspec

    return [(n, m) for n, m in model.named_modules() if isinstance(m, Conv) and param_pspec(m.conv.weight, 2)]


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def write_rect_dataset(root, n_train=8, n_val=4, seed=0):
    """Coloured rectangles on gray (64x80 PNGs), two classes, exact labels."""
    from yolo_infer_tpu_torch.data.loader import create_dataset_config, save_image

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            img = np.full((64, 80, 3), 100, np.uint8)
            rows = []
            for _ in range(2):
                c = int(rng.integers(0, 2))
                w, h = int(rng.integers(12, 30)), int(rng.integers(12, 30))
                x0, y0 = int(rng.integers(0, 80 - w)), int(rng.integers(0, 64 - h))
                img[y0:y0 + h, x0:x0 + w] = (230, 40, 40) if c == 0 else (40, 40, 230)
                rows.append(f"{c} {(x0 + w / 2) / 80:.6f} {(y0 + h / 2) / 64:.6f} {w / 80:.6f} {h / 64:.6f}")
            save_image(root / "images" / split / f"{i}.png", img)
            (root / "labels" / split / f"{i}.txt").write_text("\n".join(rows) + "\n")
    return create_dataset_config(root / "data.yaml", str(root / "images" / "train"), str(root / "images" / "val"),
                                 ["red", "blue"])


def trainer_ranks(data, root):
    """Each rank trains yolo11n (f32, 64 px, global batch 4, 2 epochs,
    patience 1, validation every epoch) with its own output directory, with
    `broadcast_scalar` and every writer of the run directory (config,
    checkpoints, summary) spied on; then `MultiChipTrainer(device_ids=[0,
    1])` builds its mesh inside the group."""
    from pathlib import Path

    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.core.trainer import MultiChipTrainer, TrainingConfig, YOLO11Trainer
    from yolo_infer_tpu_torch.parallel import distributed as dist

    from yolo_infer_tpu_torch.utils.checkpoint import CheckpointManager

    rank = dist.process_index()
    calls, writes = [], []
    spied = [(dist, "broadcast_scalar", calls), (CheckpointManager, "save_checkpoint", writes),
             (YOLO11Trainer, "_write_summary", writes), (TrainingConfig, "save", writes)]
    real = [getattr(owner, name) for owner, name, _ in spied]

    def spy(fn, log, name):
        def wrapped(*a, **kw):
            log.append(a[0] if name == "broadcast_scalar" else name)  # the stop flag, or which writer
            return fn(*a, **kw)
        return wrapped

    for (owner, name, log), fn in zip(spied, real):
        setattr(owner, name, spy(fn, log, name))
    try:
        cfg = TrainingConfig(data=str(data), epochs=2, batch=4, imgsz=64, max_boxes=8, mosaic=0.0, patience=1,
                             project=str(Path(root) / f"rank{rank}"), name="run")
        trainer = YOLO11Trainer(model=YOLO11Model("yolo11n", nc=2, device="cpu", compute_dtype=torch.float32),
                                config=cfg, device="cpu")
        result = trainer.train()
    finally:
        for (owner, name, _), fn in zip(spied, real):
            setattr(owner, name, fn)
    mc = MultiChipTrainer(model=YOLO11Model("yolo11n", nc=2, device="cpu"), config=cfg, device="cpu",
                          device_ids=[0, 1])
    mesh = mc._build_mesh(cfg)
    return {"rank": rank, "result": result, "broadcasts": calls, "writes": writes, "run_dir": str(trainer.run_dir),
            "mesh_shape": dict(trainer._mesh.shape),
            "val_on_train_mesh": trainer._val_predictor is not None and trainer._val_predictor.mesh is trainer._mesh,
            "mc_mesh": (dict(mesh.shape), [str(d) for d in mesh.devices]),
            "params": {k: v.detach().numpy().copy() for k, v in trainer.model.model.state_dict().items()}}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _unpack(dets):
    return {k: v.numpy().copy() for k, v in dets.items()}


def serve_ranks(models, frames, seg_frames, many_frames, val_data, cls_root):
    """Meshed (dp 2) f32 predictors of every task on the CPU: `predict_raw`
    of detect, pose, OBB and classify on `frames` (8 images), segment
    `predict` on `seg_frames` (masks read), detect `predict_many` on
    `many_frames` (batch_size 4), a batch of 3 (not divisible), the
    validator on `val_data` (the "val_detect" model, nc 2) and
    `evaluate_classifier` on `cls_root`, each beside the unmeshed
    predictor's."""
    from yolo_infer_tpu_torch.core.predictor import Predictor
    from yolo_infer_tpu_torch.core.validator import YOLO11Validator
    from yolo_infer_tpu_torch.data.classify import ClassifyDataset, evaluate_classifier
    from yolo_infer_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh()
    out = {}
    x = torch.from_numpy(frames)
    for task, model in models.items():
        if task == "val_detect":
            continue
        meshed = Predictor(model, model.spec, device="cpu", compute_dtype=torch.float32, mesh=mesh)
        single = Predictor(model, model.spec, device="cpu", compute_dtype=torch.float32)
        if task == "segment":
            out[task] = {k: [_result(r) for r in p.predict(list(seg_frames), conf=0.001, imgsz=64)]
                         for k, p in (("meshed", meshed), ("single", single))}
            continue
        if task == "classify":
            out[task] = {"meshed": _unpack(meshed.predict_raw(x, 0.0, 0.0, 64)),
                         "single": _unpack(single.predict_raw(x, 0.0, 0.0, 64))}
            ds = ClassifyDataset(cls_root, split="val")
            out["classify_eval"] = {k: evaluate_classifier(None, ds, imgsz=64, batch=4, predictor=p)
                                    for k, p in (("meshed", meshed), ("single", single))}
            continue
        out[task] = {"meshed": _unpack(meshed.predict_raw(x, 1e-4, 0.5, 64)),
                     "single": _unpack(single.predict_raw(x, 1e-4, 0.5, 64))}
        if task == "detect":
            out["many"] = {"meshed": [_result(r) for r in meshed.predict_many(list(many_frames), conf=0.01, imgsz=64,
                                                                               batch_size=4)],
                           "single": [_result(r) for r in single.predict(list(many_frames), conf=0.01, imgsz=64)]}
            out["predict"] = {k: [_result(r) for r in p.predict(frames, conf=0.01, imgsz=64)]
                              for k, p in (("meshed", meshed), ("single", single))}
            try:
                meshed.predict_raw(x[:3], 0.25, 0.45, 64)
            except ValueError as exc:
                out["odd_batch"] = str(exc)
            out["pool"] = _keep_inputs(meshed, single, torch.from_numpy(np.repeat(np.repeat(frames[:2], 3, 1), 3, 2)))
    val_model = models["val_detect"]
    preds = {k: Predictor(val_model, val_model.spec, device="cpu", compute_dtype=torch.float32, mesh=m)
             for k, m in (("meshed", mesh), ("single", None))}
    out["val"] = {k: YOLO11Validator(model=p, output_dir=val_data.parent / "val").validate(
        str(val_data), imgsz=64, batch=4)["metrics"] for k, p in preds.items()}
    return out


def _keep_inputs(meshed, single, x):
    """The shapes of the boxes that reach the keep mask (`ops/nms.py
    nms_keep`) in a meshed and an unmeshed `predict_raw` of `x` at conf 0
    (192 px: 756 anchors, more than the 384 of the serve pool), and both
    results."""
    import yolo_infer_tpu_torch.ops.nms as nms_ops

    shapes, real = [], nms_ops.nms_keep

    def seen(boxes, *a, **kw):
        shapes.append(tuple(boxes.shape))
        return real(boxes, *a, **kw)

    nms_ops.nms_keep = seen
    try:
        out = {}
        for k, p in (("meshed", meshed), ("single", single)):
            shapes.clear()
            dets = _unpack(p.predict_raw(x, 0.0, 0.5, x.shape[1]))
            out[k] = {"keep_inputs": list(shapes), "dets": dets}
        return out
    finally:
        nms_ops.nms_keep = real


def _result(r):
    return {"boxes": r.boxes, "scores": r.scores, "classes": r.classes,
            "masks": None if r.masks is None else np.asarray(r.masks)}
