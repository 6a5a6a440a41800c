"""The port's trainer (`yolo_infer_tpu_torch/core/trainer.py`) end to end on
the CPU: detect training at 64 px, b2, with validation after every epoch.

A run writes the JAX package's files (config.json, history.json,
training_summary.txt, checkpoints/) and timing.json; a run interrupted after
its first epoch and resumed from that epoch's checkpoint ends in the same
state, bit for bit, as the run that was not interrupted; the validation
predictor serves each epoch's EMA weights from the same tensors;
`YOLO11Model.train`, `fine_tune` and `transfer_learn` run; with no card and
no `device="cpu"` the trainer raises. The comparisons with the JAX trainer,
its command line and its robust statuses are in `test_torch_train_cli.py`.
"""

import copy
import json

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from yolo_infer_tpu.core.trainer import TrainingConfig as JaxTrainingConfig
from yolo_infer_tpu_torch.core.model import YOLO11Model
from yolo_infer_tpu_torch.core.trainer import (
    TrainingCallbacks,
    TrainingConfig,
    YOLO11Trainer,
    create_trainer,
)
from yolo_infer_tpu_torch.data.loader import create_dataset_config, save_image
from yolo_infer_tpu_torch.models.yolo11 import cast_model, fold_model
from yolo_infer_tpu_torch.utils.checkpoint import CheckpointManager

JAX_FILES = {"config.json", "history.json", "training_summary.txt", "checkpoints"}


def write_rect_dataset(root, n_train=8, n_val=4, seed=0):
    """Coloured rectangles on gray (64x80 PNGs), two classes, exact labels."""
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


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_rect_dataset(tmp_path_factory.mktemp("train_ds"))


def f32_model(name="yolo11n"):
    return YOLO11Model(name, device="cpu", compute_dtype=torch.float32)


def config(data, tmp_path, name, **kw):
    return TrainingConfig(**{"data": str(data), "epochs": 2, "batch": 2, "imgsz": 64, "save_period": 1,
                             "project": str(tmp_path), "name": name, **kw})


def test_training_config_has_the_jax_fields_and_round_trips(tmp_path):
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(TrainingConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainingConfig)}
    assert ours == theirs
    cfg = TrainingConfig(data="d.yaml", epochs=3, freeze=[0, 1], hsv_h=0.0)
    cfg.save(tmp_path / "c.json")
    assert TrainingConfig.load(tmp_path / "c.json") == TrainingConfig.from_dict({**cfg.to_dict(), "unknown": 1})
    assert cfg.aug_hyp() == JaxTrainingConfig(**cfg.to_dict()).aug_hyp()
    assert cfg.loss_hyp() == JaxTrainingConfig(**cfg.to_dict()).loss_hyp()


def test_a_resumed_run_ends_as_the_uninterrupted_one(data, tmp_path):
    """Two epochs straight, against one epoch, an interruption, and a resume
    from the first epoch's checkpoint: the final states are equal. The
    validation predictor serves every epoch from the same tensors."""
    seen = []

    def on_val_end(epoch, metrics):
        w = trainer._val_predictor.model.model[0].conv.weight
        seen.append((w.data_ptr(), w.detach().clone()))

    calls = TrainingCallbacks()
    calls.register("on_val_end", on_val_end)
    trainer = YOLO11Trainer(model=f32_model(), config=config(data, tmp_path, "straight"), callbacks=calls)
    result = trainer.train()
    assert result["status"] == "completed" and result["epochs_completed"] == 2 and result["skipped_steps"] == 0
    run = tmp_path / "straight"
    assert {p.name for p in run.iterdir()} == JAX_FILES | {"timing.json"}
    assert {p.name for p in (run / "checkpoints").iterdir()} >= {
        "best.msgpack", "checkpoint_epoch_0000.msgpack", "checkpoint_epoch_0001.msgpack"}
    history = json.loads((run / "history.json").read_text())
    assert [h["epoch"] for h in history] == [0, 1]
    assert {"loss", "loss_box", "loss_cls", "loss_dfl", "num_fg", "step_skipped", "time_s", "val_mAP50"} <= set(
        history[0])
    timing = json.loads((run / "timing.json").read_text())
    assert [t["steps"] for t in timing] == [4, 4] and all(t["loader_wait_s"] >= 0 for t in timing)
    # validation: one predictor, its weights copied in place each epoch, the last being the final EMA
    assert len(seen) == 2 and seen[0][0] == seen[1][0] and not torch.equal(seen[0][1], seen[1][1])
    served = cast_model(fold_model(copy.deepcopy(trainer.model.model)), torch.float32).model[0].conv.weight
    torch.testing.assert_close(seen[1][1], served, rtol=0, atol=0)

    class Stop(Exception):
        pass

    def stop(epoch):
        if epoch == 1:
            raise Stop("stopped after the first epoch")

    calls = TrainingCallbacks()
    calls.register("on_epoch_start", stop)
    with pytest.raises(Stop):
        YOLO11Trainer(model=f32_model(), config=config(data, tmp_path, "resumed"), callbacks=calls).train()
    resumed = YOLO11Trainer(model=f32_model(), config=config(data, tmp_path, "resumed", exist_ok=True))
    assert resumed.resume_training()["epochs_completed"] == 1
    want = CheckpointManager(run / "checkpoints").load_checkpoint(run / "checkpoints" / "checkpoint_epoch_0001.msgpack")
    got = CheckpointManager(tmp_path / "resumed" / "checkpoints").load_checkpoint(
        tmp_path / "resumed" / "checkpoints" / "checkpoint_epoch_0001.msgpack")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(tree)

    w, g = dict(leaves(want["train_state"])), dict(leaves(got["train_state"]))
    assert w.keys() == g.keys() and len(w) > 100
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_model_train_fine_tune_and_transfer_learn(data, tmp_path):
    model = f32_model()
    before = model.model.model[0].conv.weight.detach().clone()
    result = model.train(str(data), epochs=1, batch=2, imgsz=64, project=str(tmp_path), name="model")
    assert result["status"] == "completed" and model.nc == 2 and model.names == {0: "red", 1: "blue"}
    assert not torch.equal(model.model.model[0].conv.weight, before)
    assert len(model.predict(np.full((64, 80, 3), 100, np.uint8), conf=0.0, imgsz=64, max_det=5)[0]) == 5

    # frozen parameters (their batch norms' running statistics still follow the batches, as in the JAX package)
    frozen_before = {k: v.detach().clone() for k, v in model.model.named_parameters() if int(k.split(".")[1]) < 10}
    trainer = YOLO11Trainer(model=model, config=TrainingConfig(project=str(tmp_path), name="ft", batch=2,
                                                               imgsz=64, val=False))
    assert trainer.fine_tune(str(data), epochs=1, freeze=10, lr=1e-3)["status"] == "completed"
    after = dict(model.model.named_parameters())
    for k, v in frozen_before.items():  # the EMA of an unchanged parameter moves by rounding only
        torch.testing.assert_close(after[k], v, rtol=0, atol=1e-6)

    out = YOLO11Trainer(model=model, config=TrainingConfig(project=str(tmp_path), name="tl", batch=2, imgsz=64,
                                                           val=False)).transfer_learn(str(data), 1, 1)
    assert out["status"] == "completed"
    assert out["phase1"]["run_dir"].endswith("tl_phase1") and out["phase2"]["run_dir"].endswith("tl_phase2")


def test_the_trainer_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YOLO11Trainer(model=YOLO11Model("yolo11n"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_trainer("yolo11n")
    assert YOLO11Trainer(model=YOLO11Model("yolo11n"), device="cpu").device.type == "cpu"


def test_segment_training_raises_with_a_roadmap_pointer(data, tmp_path):
    """Segment training raised, citing ROADMAP Queue 1 item 8.2, until the
    segment loss was ported: the loader builds a segment batch (instance
    masks from the rectangles' polygons) and the step now trains on it."""
    model = YOLO11Model("yolo11n-seg", device="cpu", compute_dtype=torch.float32)
    out = model.train(str(data), epochs=1, batch=2, imgsz=64, project=str(tmp_path), val=False)
    assert out["status"] == "completed" and out["skipped_steps"] == 0
    assert np.isfinite(out["history"][0]["loss_mask"]) and model.task == "segment"


def test_multi_card_training_raises_with_a_roadmap_pointer():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
        create_trainer("yolo11n", multi_gpu=True, device="cpu")
