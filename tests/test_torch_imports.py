"""Port hygiene: the whole package imports, serves and validates with neither jax nor OpenCV.

A fresh interpreter (`-I`: no PYTHONPATH, no user site) has `jax`, `cv2`,
`flax`, `msgpack` and `safetensors` blocked in `sys.modules`, imports every
module of `yolo_infer_tpu_torch`, and runs a CPU `Predictor.predict` on two
frames of different sizes, which takes the host letterbox. Another exports,
loads and serves a serving artifact and writes, reads and exports native
checkpoints with those blocked. A second one also blocks `yaml` and runs
`YOLO11Validator.validate` on a PNG dataset that the port writes itself. A
third builds a `YOLO11Model`, quantizes it with PTQ and serves it in static8.
A fourth also blocks `psutil` and serves `predict_many` (segment, host
masks), runs `YOLO11Model.benchmark` and a `ResourceMonitor`. Last, every
"ROADMAP Queue 1 item N" in the port's sources names an item that ROADMAP's
Queue 1 has.
"""

import re

import subprocess
import sys
from pathlib import Path

from torch_threads import TORCH_SUBPROCESS_ENV

REPO = Path(__file__).resolve().parent.parent

_BLOCKED = ("jax", "cv2", "flax", "msgpack", "safetensors")

_CODE = """
import importlib, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
import numpy as np
import yolo_infer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(yolo_infer_tpu_torch.__path__, "yolo_infer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
from yolo_infer_tpu_torch import Predictor, build_model
model, spec = build_model("segment", "n", nc=3, seed=0)
pred = Predictor(model, spec, device="cpu")
rng = np.random.default_rng(0)
frames = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), rng.integers(0, 256, (64, 40, 3), dtype=np.uint8)]
out = pred.predict(frames, conf=0.0, imgsz=64, max_det=20)
assert [r.orig_shape for r in out] == [(48, 64), (64, 40)]
assert all(len(r) > 0 and r.masks.numpy().shape == (len(r),) + r.orig_shape for r in out)
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "flax", "msgpack", "safetensors", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_imports_and_serves_mixed_sizes_without_jax_or_opencv():
    subprocess.run([sys.executable, "-I", "-c", _CODE.format(repo=str(REPO), blocked=_BLOCKED)], check=True,
                   timeout=300, env=TORCH_SUBPROCESS_ENV)


_EXPORT_CODE = """
import sys, tempfile
from pathlib import Path
for name in {blocked!r}:
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from yolo_infer_tpu_torch import YOLO11Model
from yolo_infer_tpu_torch.core.exported import ExportedPredictor, export_predictor
from yolo_infer_tpu_torch.utils.checkpoint import CheckpointManager
from yolo_infer_tpu_torch.utils.safetensors import load_file
root = Path(tempfile.mkdtemp())
model = YOLO11Model("yolo11n", nc=3, device="cpu", compute_dtype=torch.float32)
frames = np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
ep = ExportedPredictor.load(export_predictor(model, root / "a.pt2", batch=1, imgsz=64))
got = ep.predict_raw(frames, 1e-4, 0.45)
want = model.predictor.predict_raw(torch.from_numpy(frames), 1e-4, 0.45, 64)
assert all(torch.equal(got[k], want[k]) for k in want) and int(got["num"][0]) > 0
back = YOLO11Model(model.save(root / "m.msgpack", fused=True), device="cpu", compute_dtype=torch.float32)
assert back.task == "detect" and back.nc == 3
tensors, meta = load_file(model.export(root / "m.safetensors", format="safetensors"))
assert meta["task"] == "detect" and len(tensors) > 100
mgr = CheckpointManager(root / "ckpt")
mgr.save_checkpoint({{"w": np.arange(3, dtype=np.float32)}}, epoch=0)
assert mgr.load_checkpoint()["train_state"]["w"].tolist() == [0.0, 1.0, 2.0]
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "flax", "msgpack", "safetensors", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_exports_and_checkpoints_without_jax_flax_msgpack_or_safetensors():
    """An artifact exported, loaded and served (equal to live), and native
    checkpoints, safetensors and CheckpointManager files written and read,
    with jax, cv2, flax, msgpack and safetensors blocked."""
    subprocess.run([sys.executable, "-I", "-c", _EXPORT_CODE.format(repo=str(REPO), blocked=_BLOCKED)], check=True,
                   timeout=300, env=TORCH_SUBPROCESS_ENV)


_VAL_CODE = """
import sys, tempfile
from pathlib import Path
sys.modules["jax"] = sys.modules["cv2"] = sys.modules["yaml"] = None  # any import of these raises
sys.path.insert(0, {repo!r})
import numpy as np
from yolo_infer_tpu_torch import Predictor, build_model
from yolo_infer_tpu_torch.core.validator import YOLO11Validator
from yolo_infer_tpu_torch.data.loader import save_image
root = Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
for i, shape in enumerate([(48, 64, 3), (64, 40, 3), (48, 64, 3)]):
    save_image(root / "images" / "val" / f"{{i}}.png", rng.integers(0, 256, shape, dtype=np.uint8))
(root / "labels" / "val").mkdir(parents=True)
(root / "labels" / "val" / "0.txt").write_text("1 0.5 0.5 0.4 0.3\\n")
model, spec = build_model("detect", "n", nc=3, seed=0)
out = YOLO11Validator(model=Predictor(model, spec, device="cpu"), output_dir=root / "out").validate(
    {{"path": str(root), "val": "images/val", "names": ["a", "b", "c"]}}, imgsz=64, batch=2, verbose=False)
assert out["num_images"] == 3 and set(out["metrics"]) == {{"mAP50-95", "mAP50", "mAP75", "precision", "recall"}}
assert (root / "out" / "validation_summary.txt").exists()
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_validates_without_jax_opencv_or_yaml():
    subprocess.run([sys.executable, "-I", "-c", _VAL_CODE.format(repo=str(REPO))], check=True, timeout=300,
                   env=TORCH_SUBPROCESS_ENV)


_QUANT_CODE = """
import sys
sys.modules["jax"] = sys.modules["cv2"] = None  # any import of either raises
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from yolo_infer_tpu_torch import YOLO11Model
from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer
model = YOLO11Model("yolo11n", device="cpu", compute_dtype=torch.float32)
rng = np.random.default_rng(0)
q = create_quantizer("ptq", model, {{"imgsz": 64}})
q.set_calibration_data([rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)])
qmodel = q.optimize()
out = qmodel.predict(rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8), conf=0.0, imgsz=64, max_det=10)
assert qmodel.quant_act_scales.shape == (72, 2) and [len(r) for r in out] == [10, 10]
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yolo_infer_tpu") for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_quantizes_and_serves_static8_without_jax_or_opencv():
    """YOLO11Model -> PTQ calibration -> static8 predict, with jax and cv2 blocked."""
    subprocess.run([sys.executable, "-I", "-c", _QUANT_CODE.format(repo=str(REPO))], check=True, timeout=300,
                   env=TORCH_SUBPROCESS_ENV)


_SERVE_CODE = """
import sys
sys.modules["jax"] = sys.modules["cv2"] = sys.modules["psutil"] = None  # any import of these raises
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from yolo_infer_tpu_torch import YOLO11Model
from yolo_infer_tpu_torch.utils.helpers import ResourceMonitor
model = YOLO11Model("yolo11n-seg", device="cpu", nc=3, compute_dtype=torch.float32)
rng = np.random.default_rng(0)
frames = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(4)]
frames.append(rng.integers(0, 256, (64, 40, 3), dtype=np.uint8))
mon = ResourceMonitor(interval=0.05)
mon.start()
out = model.predict(frames, conf=0.0, imgsz=64, max_det=10, batch=2)
summary = mon.stop()
assert [r.orig_shape for r in out] == [(48, 64)] * 4 + [(64, 40)]
assert all(0 < len(r) <= 10 and r.masks.numpy().shape == (len(r),) + r.orig_shape for r in out)
bench = model.benchmark(imgsz=64, batch=1, runs=1, warmup=0)
assert bench["fps"] > 0 and summary["samples"] >= 1 and "avg_cpu_percent" in summary
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "psutil", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_serves_many_and_benchmarks_without_jax_opencv_or_psutil():
    """predict_many (segment, mixed sizes, host masks) and YOLO11Model.benchmark with jax, cv2 and psutil blocked."""
    subprocess.run([sys.executable, "-I", "-c", _SERVE_CODE.format(repo=str(REPO))], check=True, timeout=300,
                   env=TORCH_SUBPROCESS_ENV)


def _queue1_items():
    """The numbered items of ROADMAP.md's Queue 1 ("N" and "N.M")."""
    text = (REPO / "ROADMAP.md").read_text()
    section = text[text.index("### Queue 1"):text.index("### Queue 2")]
    items, top = set(), None
    for line in section.splitlines():
        m = re.match(r"^(\d+)\. ", line)
        if m:
            top = m.group(1)
            items.add(top)
            continue
        m = re.match(r"^ {3}(\d+)\. ", line)
        if m and top:
            items.add(f"{top}.{m.group(1)}")
    return items


def test_port_roadmap_pointers_name_queue1_items():
    items = _queue1_items()
    assert {"1", "3", "4.1", "4.2", "5", "6", "8"} <= items
    cited = []
    for path in sorted((REPO / "yolo_infer_tpu_torch").rglob("*.py")):
        text = path.read_text()
        for m in re.finditer(r"Queue\s+1\s+items?\s+([\d.]+(?:\s+and\s+[\d.]+)?)", text):
            cited += [(path.name, n.rstrip(".")) for n in re.split(r"\s+and\s+", m.group(1))]
        cited += [(path.name, n) for n in re.findall(r"_NOT_PORTED\.format\((\d+)\)", text)]
    assert len(cited) >= 10
    missing = [c for c in cited if c[1] not in items]
    assert not missing, f"pointers to no item of ROADMAP Queue 1: {missing}"
