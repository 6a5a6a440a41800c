"""The port's trainer over a process group on the CPU (the counterparts of
`tests/test_round2.py`'s multi-process cases): two gloo processes
(`parallel/distributed.py launch`, `tests/torch_dist.py trainer_ranks`) each
train yolo11n (f32, 64 px, global batch 4, two epochs, validation after each)
with their own output directory; then `MultiChipTrainer(device_ids=[0, 1])`
starts its own two processes from this one.
"""

import numpy as np
import pytest
import torch

from torch_dist import TIMEOUT_S, trainer_ranks, write_rect_dataset
from torch_threads import one_torch_thread  # noqa: F401
from yolo_infer_tpu_torch.core.model import YOLO11Model
from yolo_infer_tpu_torch.core.trainer import MultiChipTrainer, TrainingConfig
from yolo_infer_tpu_torch.parallel.distributed import launch


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_train")
    data = write_rect_dataset(root / "data")
    return root, launch(trainer_ranks, 2, args=(data, root / "runs"), timeout_s=TIMEOUT_S)


def test_non_main_process_writes_nothing(trained):
    """Rank 0 writes config.json, the checkpoints and the summary into the
    run directory it chose, which rank 1 takes for its own; rank 1 calls no
    writer and leaves its own output directory uncreated."""
    root, (r0, r1) = trained
    assert r0["result"]["status"] == r1["result"]["status"] == "completed"
    run0 = root / "runs" / "rank0" / "run"
    assert r0["run_dir"] == r1["run_dir"] == str(run0)
    assert {p.name for p in run0.iterdir()} >= {"config.json", "history.json", "training_summary.txt", "checkpoints"}
    assert list((run0 / "checkpoints").glob("*.msgpack"))
    assert {"save", "save_checkpoint", "_write_summary"} <= set(r0["writes"]) and r1["writes"] == []
    assert not (root / "runs" / "rank1").exists()


def test_early_stop_goes_through_the_broadcast(trained):
    """patience 1 over 2 epochs: each epoch's stop decision is rank 0's
    `broadcast_scalar`, and both ranks run the same epochs."""
    _, (r0, r1) = trained
    assert len(r0["broadcasts"]) == len(r1["broadcasts"]) == r0["result"]["epochs_completed"] >= 1
    assert r0["result"]["epochs_completed"] == r1["result"]["epochs_completed"]


def test_per_epoch_validation_uses_the_training_mesh(trained):
    _, (r0, r1) = trained
    for r in (r0, r1):
        assert r["mesh_shape"] == {"data": 2, "model": 1} and r["val_on_train_mesh"]
    for k in ("val_mAP50-95", "val_mAP50", "loss"):
        assert [h[k] for h in r0["result"]["history"]] == [h[k] for h in r1["result"]["history"]]


def test_data_ranks_train_the_same_model(trained):
    _, (r0, r1) = trained
    assert all(np.array_equal(r0["params"][k], r1["params"][k]) for k in r0["params"])


def test_multichip_trainer_honours_device_ids(trained, monkeypatch, tmp_path):
    _, (r0, _) = trained
    assert r0["mc_mesh"] == ({"data": 2, "model": 1}, ["cpu", "cpu"])  # built from device_ids [0, 1] in the group
    cfg = TrainingConfig(batch=4, imgsz=64, project=str(tmp_path))
    model = YOLO11Model("yolo11n", nc=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    t = MultiChipTrainer(model=model, config=cfg, device="cuda", device_ids=[2, 0])
    assert t._select_devices() == [torch.device("cuda", 2), torch.device("cuda", 0)]
    assert t._build_mesh(cfg) is None  # no process group here: no mesh
    with pytest.raises(ValueError, match="99"):
        MultiChipTrainer(model=model, config=cfg, device="cuda", device_ids=[0, 99])._select_devices()
    with pytest.raises(ValueError):
        MultiChipTrainer(model=model, config=cfg, device="cpu", device_ids=[0, -1])._select_devices()


def test_multichip_trainer_starts_its_own_group(trained, tmp_path):
    """Outside a process group `train()` starts one gloo process per id,
    trains there and takes the trained model back from rank 0."""
    root, (r0, _) = trained
    data = root / "data" / "data.yaml"
    model = YOLO11Model("yolo11n", nc=2, device="cpu", compute_dtype=torch.float32)
    before = {k: v.clone() for k, v in model.model.state_dict().items()}
    cfg = TrainingConfig(data=str(data), epochs=1, batch=4, imgsz=64, max_boxes=8, mosaic=0.0, val=False,
                         project=str(tmp_path), name="mc")
    out = MultiChipTrainer(model=model, config=cfg, device="cpu", device_ids=[0, 1]).train()
    assert out["status"] == "completed" and out["skipped_steps"] == 0
    assert (tmp_path / "mc" / "config.json").exists() and list((tmp_path / "mc" / "checkpoints").glob("*.msgpack"))
    assert any(not torch.equal(before[k], v) for k, v in model.model.state_dict().items())
