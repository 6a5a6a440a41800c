"""Training through the port's entry points against the JAX package's, on the CPU.

`python -m yolo_infer_tpu_torch train` (with `--device cpu`) and `main.py
train` on one PNG detect dataset (64 px, b2, one epoch with validation):
the same exit code, the same keys in the printed JSON and in history.json,
and the JAX package's files in the run directory (the port adds
timing.json). A classify model through `create_trainer` on both sides gives
the same result and history keys. The robust trainer reports the JAX
package's statuses: "failed" with its error type for a run that raises,
"completed_with_skipped_errors" with a count when steps were dropped, and
raises instead with `skip_errors=False`. The two packages start from
different seeded weights, so their numbers are not compared here (the step
and the losses are, in `test_torch_train_step.py` and
`test_torch_train_losses.py`).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))  # main.py

import main as jax_main  # noqa: E402
import yolo_infer_tpu.core.robust_trainer as jax_robust  # noqa: E402
import yolo_infer_tpu.core.trainer as jax_trainer  # noqa: E402
import yolo_infer_tpu_torch.core.robust_trainer as port_robust  # noqa: E402
import yolo_infer_tpu_torch.core.trainer as port_trainer  # noqa: E402
from test_torch_train_trainer import write_rect_dataset  # noqa: E402
from yolo_infer_tpu_torch import cli as port_cli  # noqa: E402
from yolo_infer_tpu_torch.data.loader import save_image  # noqa: E402


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_rect_dataset(tmp_path_factory.mktemp("cli_train_ds"))


def run_cli(cli, argv, capsys):
    rc = cli.YOLO11CLI().run(argv)
    out = capsys.readouterr().out
    return rc, json.loads(out[out.index("{"):])


def test_train_cli_matches_main_py(data, tmp_path, capsys):
    base = ["train", "--data", str(data), "--epochs", "1", "--batch", "2", "--imgsz", "64", "--name", "run"]
    jax_rc, jax_out = run_cli(jax_main, base + ["--project", str(tmp_path / "jax")], capsys)
    port_rc, port_out = run_cli(port_cli, base + ["--project", str(tmp_path / "port"), "--device", "cpu"], capsys)
    assert jax_rc == port_rc == 0
    assert port_out.keys() == jax_out.keys() and port_out["status"] == jax_out["status"] == "completed"
    jax_run, port_run = Path(jax_out["run_dir"]), Path(port_out["run_dir"])
    assert {p.name for p in port_run.iterdir()} == {p.name for p in jax_run.iterdir()} | {"timing.json"}
    assert ({p.name for p in (port_run / "checkpoints").iterdir()}
            == {p.name for p in (jax_run / "checkpoints").iterdir()})
    jax_hist = json.loads((jax_run / "history.json").read_text())
    port_hist = json.loads((port_run / "history.json").read_text())
    assert [h.keys() for h in port_hist] == [h.keys() for h in jax_hist]
    port_cfg, jax_cfg = (json.loads((r / "config.json").read_text()) for r in (port_run, jax_run))
    assert {**port_cfg, "project": None} == {**jax_cfg, "project": None}


def write_classify_tree(root, n=4):
    rng = np.random.default_rng(1)
    for split in ("train", "val"):
        for c, colour in (("red", (220, 30, 30)), ("blue", (30, 30, 220))):
            for i in range(n):
                img = rng.integers(0, 60, (40, 48, 3), dtype=np.uint8) + np.array(colour, np.uint8) // 2
                save_image(root / split / c / f"{i}.png", img.astype(np.uint8))
    return root


def test_classify_training_matches_the_jax_trainer(tmp_path):
    root = write_classify_tree(tmp_path / "cls")
    cfg = {"data": str(root), "epochs": 1, "batch": 2, "imgsz": 32, "name": "cls"}
    jax_out = jax_trainer.create_trainer("yolo11n-cls", {**cfg, "project": str(tmp_path / "jax")}).train()
    port_out = port_trainer.create_trainer("yolo11n-cls", {**cfg, "project": str(tmp_path / "port")},
                                           device="cpu").train()
    assert port_out.keys() == jax_out.keys() and port_out["status"] == jax_out["status"] == "completed"
    assert [h.keys() for h in port_out["history"]] == [h.keys() for h in jax_out["history"]]
    assert {"val_top1", "val_top5", "accuracy"} <= set(port_out["history"][0])


def test_robust_statuses_match_jax(tmp_path, monkeypatch):
    missing = {"data": str(tmp_path / "missing.yaml"), "epochs": 1, "batch": 2, "imgsz": 64}
    jax_out = jax_robust.create_robust_trainer("yolo11n", {**missing, "project": str(tmp_path / "j")}).train()
    port_out = port_robust.create_robust_trainer("yolo11n", {**missing, "project": str(tmp_path / "p")},
                                                 device="cpu").train()
    assert port_out.keys() == jax_out.keys()
    assert (port_out["status"], port_out["error_type"], port_out["error_skipped"]) == (
        jax_out["status"], jax_out["error_type"], jax_out["error_skipped"]) == ("failed", "data", True)
    for make in (lambda: jax_robust.create_robust_trainer("yolo11n", missing, skip_errors=False),
                 lambda: port_robust.create_robust_trainer("yolo11n", missing, skip_errors=False, device="cpu")):
        with pytest.raises(FileNotFoundError):
            make().train()

    def dropped_two(self, **kw):
        return {"status": "completed", "skipped_steps": 2}

    monkeypatch.setattr(jax_trainer.YOLO11Trainer, "train", dropped_two)
    monkeypatch.setattr(port_trainer.YOLO11Trainer, "train", dropped_two)
    jax_out = jax_robust.create_robust_trainer("yolo11n", {"project": str(tmp_path / "j2")}).train()
    port_out = port_robust.create_robust_trainer("yolo11n", {"project": str(tmp_path / "p2")}, device="cpu").train()
    assert port_out == jax_out == {"status": "completed_with_skipped_errors", "skipped_steps": 2, "skipped_batches": 2}


@pytest.mark.parametrize("exc", [ValueError("shapes (2, 3) and (4,) do not broadcast"), MemoryError("out of memory"),
                                 FloatingPointError("loss is nan"), FileNotFoundError("data.yaml"),
                                 ValueError("bad label"), RuntimeError("boom")])
def test_error_classes_match_jax(exc):
    assert port_robust.classify_training_error(exc) == jax_robust.classify_training_error(exc)
