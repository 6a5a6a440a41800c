"""Port hygiene: the whole package imports, serves and validates with neither jax nor OpenCV.

A fresh interpreter (`-I`: no PYTHONPATH, no user site) has `jax` and `cv2`
blocked in `sys.modules`, imports every module of `yolo_infer_tpu_torch`, and
runs a CPU `Predictor.predict` on two frames of different sizes, which takes
the host letterbox. A second one also blocks `yaml` and runs
`YOLO11Validator.validate` on a PNG dataset that the port writes itself.
"""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_CODE = """
import importlib, pkgutil, sys
sys.modules["jax"] = sys.modules["cv2"] = None  # any import of either raises
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
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yolo_infer_tpu") for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_imports_and_serves_mixed_sizes_without_jax_or_opencv():
    subprocess.run([sys.executable, "-I", "-c", _CODE.format(repo=str(REPO))], check=True, timeout=300)


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
    subprocess.run([sys.executable, "-I", "-c", _VAL_CODE.format(repo=str(REPO))], check=True, timeout=300)
