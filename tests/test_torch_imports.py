"""Port hygiene: the whole package imports, serves and validates with neither jax nor OpenCV.

A fresh interpreter (`-I`: no PYTHONPATH, no user site) has `jax`, `cv2`,
`flax`, `msgpack` and `safetensors` blocked in `sys.modules`, imports every
module of `yolo_infer_tpu_torch`, and runs a CPU `Predictor.predict` on two
frames of different sizes, which takes the host letterbox. Another exports,
loads and serves a serving artifact and writes, reads and exports native
checkpoints with those blocked. A second one also blocks `yaml` and runs
`YOLO11Validator.validate` on PNG datasets that the port writes itself, for
a detect, a segment (polygon labels) and an OBB model (corner labels), and
`evaluate_classifier` on a class-per-directory tree. A
third builds a `YOLO11Model`, quantizes it with PTQ and serves it in static8.
A fourth also blocks `psutil` and serves `predict_many` (segment, host
masks), runs `YOLO11Model.benchmark` and a `ResourceMonitor`. A fifth
blocks `yaml` and `PIL` too and runs the command line (`python -m
yolo_infer_tpu_torch`): a demo on a JPEG and on a directory, validation
from a dataset YAML, PTQ and info. A sixth trains with the same blocks:
`train` on the command line and `YOLO11Model.train` for a classify model.
Another writes a motion-JPEG AVI with the port's writer, reads it back
and runs the video demo on it through the command line (the batched detect
pipeline, an `.avi` out) with jax, `yolo_infer_tpu`, cv2, yaml and PIL
blocked. A seventh runs every optimize method with those blocks: dynamic int8,
magnitude and physical pruning, distillation, QAT and segment, pose and OBB
training. An eighth runs `yolo_infer_tpu_torch.parallel` (a meshed step,
predictor and dry run in a gloo group of one) with jax and `yolo_infer_tpu`
blocked. A ninth reads every image fixture to its manifest's hash and
round-trips every writer with jax, cv2, PIL and `yolo_infer_tpu` blocked.
A tenth runs the port's scripts (`yolo_infer_tpu_torch.scripts`) with jax,
the JAX package, cv2, yaml and PIL blocked.
Last, every "ROADMAP Queue 1 item N" in
the port's sources names an item that ROADMAP's Queue 1 has.
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
(root / "labels" / "val" / "1.txt").write_text("0 0.1 0.1 0.8 0.2 0.6 0.9 0.2 0.7\\n")  # a polygon, or OBB corners
for task in ("segment", "obb"):
    model, spec = build_model(task, "n", nc=3, seed=0)
    out = YOLO11Validator(model=Predictor(model, spec, device="cpu"), output_dir=root / task).validate(
        {{"path": str(root), "val": "images/val", "names": ["a", "b", "c"]}}, imgsz=64, batch=2, verbose=False)
    assert out["num_images"] == 3 and ("mask_metrics" in out) == (task == "segment")
from yolo_infer_tpu_torch.data.classify import ClassifyDataset, evaluate_classifier
for i, shape in enumerate([(40, 30, 3), (30, 50, 3)]):
    save_image(root / "cls" / f"c{{i}}" / "im.png", rng.integers(0, 256, shape, dtype=np.uint8))
model, spec = build_model("classify", "n", nc=2, seed=0)
out = evaluate_classifier(None, ClassifyDataset(root / "cls"), imgsz=32, batch=4, predictor=Predictor(model, spec, device="cpu"))
assert out["num_images"] == 2 and out["top5"] == 1.0
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


_CLI_CODE = """
import contextlib, io, json, sys, tempfile
from pathlib import Path
for name in ("jax", "cv2", "yaml", "PIL", "flax", "msgpack", "safetensors"):
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
import numpy as np
from yolo_infer_tpu_torch.cli import YOLO11CLI
from yolo_infer_tpu_torch.data.loader import create_dataset_config, load_image, save_image
root = Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
for i in range(3):
    save_image(root / "ds" / "images" / "val" / f"{{i}}.jpg", rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
(root / "ds" / "labels" / "val").mkdir(parents=True)
(root / "ds" / "labels" / "val" / "0.txt").write_text("1 0.5 0.5 0.4 0.3\\n")
data = create_dataset_config(root / "ds" / "data.yaml", str(root / "ds" / "images" / "val"),
                             str(root / "ds" / "images" / "val"), [str(c) for c in range(80)])

def run(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = YOLO11CLI().run(list(argv) + ["--device", "cpu"])
    assert rc == 0, (argv, rc)
    text = out.getvalue()
    return json.loads(text) if text.lstrip().startswith("{{") else text

image = root / "ds" / "images" / "val" / "0.jpg"
one = run("demo", "--input", str(image), "--output", str(root / "out.jpg"), "--imgsz", "64", "--conf", "1e-9")
assert one["num_detections"] > 0 and load_image(root / "out.jpg").shape == (48, 64, 3)
many = run("demo", "--input", str(image.parent), "--output", str(root / "outdir"), "--imgsz", "64")
assert many["num_images"] == 3 and len(list((root / "outdir").iterdir())) == 3
val = run("val", "--data", str(data), "--imgsz", "64", "--batch", "2", "--output-dir", str(root / "val"))
assert val["num_images"] == 3
q = run("optimize", "--method", "ptq", "--imgsz", "64", "--calibration-batches", "1",
        "--output", str(root / "q.msgpack"))
assert Path(q["saved"]).exists()
assert not run("info")["dependencies"]["yaml (optional)"]
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml", "PIL", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_cli_runs_without_jax_opencv_yaml_or_pil():
    """The command line on JPEGs the port writes, a dataset YAML the port
    writes, PTQ and info, with jax, cv2, yaml and PIL blocked."""
    subprocess.run([sys.executable, "-I", "-c", _CLI_CODE.format(repo=str(REPO))], check=True, timeout=300,
                   env=TORCH_SUBPROCESS_ENV)


_VIDEO_CODE = """
import contextlib, io, json, sys, tempfile
from pathlib import Path
for name in ("jax", "yolo_infer_tpu", "cv2", "yaml", "PIL", "flax", "msgpack", "safetensors"):
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
import numpy as np
from yolo_infer_tpu_torch.cli import YOLO11CLI
from yolo_infer_tpu_torch.data.loader import get_video_info, load_video
from yolo_infer_tpu_torch.utils.visualization import create_video_writer
root = Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
grad = np.add.outer(np.arange(48), np.arange(64))[..., None] * np.array([1, 2, 3]) % 256
frames = [np.clip(grad + rng.integers(-8, 9, (48, 64, 3)), 0, 255).astype(np.uint8) for _ in range(5)]
writer = create_video_writer(root / "v.avi", 29.97, (64, 48))
for f in frames:
    writer.write(f)
writer.release()
assert get_video_info(root / "v.avi") == {{"width": 64, "height": 48, "fps": 29.97, "frame_count": 5,
                                          "duration_s": 5 / 29.97}}
back = list(load_video(root / "v.avi", rgb=False))
assert len(back) == 5 and all(b.shape == (48, 64, 3) for b in back)
assert np.abs(back[0].astype(int) - frames[0]).mean() < 20
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = YOLO11CLI().run(["demo", "--input", str(root / "v.avi"), "--output", str(root / "o.avi"), "--imgsz", "64",
                          "--batch", "2", "--conf", "1e-9", "--device", "cpu"])
summary = json.loads(out.getvalue())
assert rc == 0 and summary["total_frames"] == 5 and summary["total_detections"] > 0, summary
assert get_video_info(root / "o.avi")["frame_count"] == 5 and len(list(load_video(root / "o.avi"))) == 5
# MPEG-4 Part 2: written to MP4, read from every container the fixtures hold, and through the demo
import hashlib
from yolo_infer_tpu_torch.data import mkv, mp4, mpeg4, video  # noqa: F401
writer = create_video_writer(root / "v.mp4", 25, (64, 48))
recon = []
for f in frames:
    writer.write(f)
    recon.append(writer.encoder.reconstruction)
writer.release()
assert all(np.array_equal(a, b) for a, b in zip(load_video(root / "v.mp4", rgb=False), recon))
fixtures = Path({repo!r}) / "tests" / "torch_video"
manifest = json.loads((fixtures / "manifest.json").read_text())
for name in ("mp4v_100x60_25.mov", "mp4v_64x48_30.mkv", "xvid_100x60_30.avi", "acpred_dcac_100x60_25.mp4",
             "vp8_64x48.webm"):
    hashes = [hashlib.sha256(f.tobytes()).hexdigest() for f in load_video(fixtures / name, rgb=False)]
    assert hashes == manifest["files"][name]["frames"] and get_video_info(fixtures / name) == \
        manifest["files"][name]["info"], name
vp8_fixtures = Path({repo!r}) / "tests" / "torch_vp8"
vp8_manifest = json.loads((vp8_fixtures / "manifest.json").read_text())
for name in ("vp8_altref_64x48.webm", "vp8_version1_64x48.webm"):
    hashes = [hashlib.sha256(f.tobytes()).hexdigest() for f in load_video(vp8_fixtures / name, rgb=False)]
    assert hashes == vp8_manifest["files"][name]["frames"] and get_video_info(vp8_fixtures / name) == \
        vp8_manifest["files"][name]["info"], name
vp9_fixtures = Path({repo!r}) / "tests" / "torch_vp9"
vp9_manifest = json.loads((vp9_fixtures / "manifest.json").read_text())
for name in ("vp9_64x48_25.webm", "vp9_99x60.webm"):
    hashes = [hashlib.sha256(f.tobytes()).hexdigest() for f in load_video(vp9_fixtures / name, rgb=False)]
    assert hashes == vp9_manifest["files"][name]["frames"] and get_video_info(vp9_fixtures / name) == \
        vp9_manifest["files"][name]["info"], name
with contextlib.redirect_stdout(io.StringIO()):
    rc = YOLO11CLI().run(["demo", "--input", str(fixtures / "mp4v_64x48_30.mkv"), "--output", str(root / "o.mp4"),
                          "--imgsz", "64", "--batch", "4", "--conf", "1e-9", "--device", "cpu"])
assert rc == 0 and get_video_info(root / "o.mp4")["frame_count"] == 13 == len(list(load_video(root / "o.mp4")))
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml", "PIL", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_video_runs_without_jax_opencv_yaml_or_pil():
    """Motion-JPEG AVI, MPEG-4 Part 2 (MP4 written; MOV, Matroska, AVI and
    MP4 fixtures read to their manifest's hashes) and VP8 and VP9 video
    (WebM fixtures from OpenCV's writer and libvpx, VP8's hidden frames
    included, read to theirs) run through the readers, the writers and the
    video demo on the command line, with jax, yolo_infer_tpu, cv2, yaml and
    PIL blocked."""
    subprocess.run([sys.executable, "-I", "-c", _VIDEO_CODE.format(repo=str(REPO))], check=True, timeout=300,
                   env=TORCH_SUBPROCESS_ENV)


_TRAIN_CODE = """
import contextlib, io, json, sys, tempfile
from pathlib import Path
for name in ("jax", "cv2", "yaml", "PIL", "flax", "msgpack", "safetensors"):
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
import numpy as np
from yolo_infer_tpu_torch.cli import YOLO11CLI
from yolo_infer_tpu_torch.core.model import YOLO11Model
from yolo_infer_tpu_torch.data.loader import create_dataset_config, save_image
root = Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
for split in ("train", "val"):
    (root / "ds" / "labels" / split).mkdir(parents=True)
    for i in range(4):
        img = np.full((48, 64, 3), 100, np.uint8)
        img[8:30, 10:40] = (220, 30, 30)
        save_image(root / "ds" / "images" / split / f"{{i}}.png", img)
        (root / "ds" / "labels" / split / f"{{i}}.txt").write_text("0 0.390625 0.395833 0.46875 0.458333\\n")
    for c in ("a", "b"):
        save_image(root / "cls" / split / c / "0.png", rng.integers(0, 256, (40, 40, 3), dtype=np.uint8))
        save_image(root / "cls" / split / c / "1.png", rng.integers(0, 256, (40, 40, 3), dtype=np.uint8))
data = create_dataset_config(root / "ds" / "data.yaml", str(root / "ds" / "images" / "train"),
                             str(root / "ds" / "images" / "val"), ["box"])
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = YOLO11CLI().run(["train", "--data", str(data), "--epochs", "1", "--batch", "2", "--imgsz", "64",
                          "--project", str(root / "runs"), "--device", "cpu"])
result = json.loads(out.getvalue())
assert rc == 0 and result["status"] == "completed", result
assert (Path(result["run_dir"]) / "history.json").exists()
cls = YOLO11Model("yolo11n-cls", device="cpu", nc=2).train(str(root / "cls"), epochs=1, batch=2, imgsz=32,
                                                          project=str(root / "runs"), name="cls")
assert cls["status"] == "completed" and "val_top1" in cls["history"][0], cls
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml", "PIL", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_trains_without_jax_opencv_yaml_or_pil():
    """`train` on the command line (detect) and `YOLO11Model.train` (classify)
    on PNG files the port writes, with jax, cv2, yaml and PIL blocked."""
    subprocess.run([sys.executable, "-I", "-c", _TRAIN_CODE.format(repo=str(REPO))], check=True, timeout=300,
                   env=TORCH_SUBPROCESS_ENV)


_OPTIMIZE_CODE = """
import sys, tempfile
from pathlib import Path
for name in ("jax", "cv2", "yaml", "PIL", "flax", "msgpack", "safetensors"):
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from yolo_infer_tpu_torch import YOLO11Model
from yolo_infer_tpu_torch.data.loader import create_dataset_config, save_image
from yolo_infer_tpu_torch.optimization import create_distiller, create_pruner, create_quantizer
root = Path(tempfile.mkdtemp())
for split in ("train", "val"):
    (root / "labels" / split).mkdir(parents=True)
    for i in range(2):
        img = np.full((48, 64, 3), 100, np.uint8)
        img[8:30, 10:40] = (220, 30, 30)
        save_image(root / "images" / split / f"{{i}}.png", img)
        kp = " ".join("0.39 0.39 2" for _ in range(17))
        (root / "labels" / split / f"{{i}}.txt").write_text(f"0 0.390625 0.395833 0.46875 0.458333 {{kp}}\\n")
data = str(create_dataset_config(root / "data.yaml", str(root / "images" / "train"), str(root / "images" / "val"),
                                 ["box"]))
kw = dict(batch=2, imgsz=64, project=str(root / "runs"), val=False)
frame = np.full((48, 64, 3), 100, np.uint8)
model = YOLO11Model("yolo11n", device="cpu", nc=1, compute_dtype=torch.float32)
assert create_quantizer("dynamic", model).optimize().predict(frame, imgsz=64, conf=0.0)[0] is not None
assert create_pruner(model, {{"sparsity": 0.5}}).optimize().predict(frame, imgsz=64, conf=0.0)[0] is not None
slim = create_pruner(model, {{"method": "structured", "physical": True}}).optimize()
assert sum(p.numel() for p in slim.model.parameters()) < sum(p.numel() for p in model.model.parameters())
assert create_distiller(model, {{"teacher": YOLO11Model("yolo11n", device="cpu", nc=1, seed=1,
                                                          compute_dtype=torch.float32)}}).optimize(data, epochs=1, name="kd",
                                                                                                  **kw)
assert create_quantizer("qat", model, {{"epochs": 1}}).optimize(data=data, **kw).predictor.quant_mode == "dynamic"
for name in ("yolo11n-seg", "yolo11n-pose", "yolo11n-obb"):
    out = YOLO11Model(name, device="cpu", nc=1).train(data, epochs=1, name=name, **kw)
    assert out["status"] == "completed" and out["skipped_steps"] == 0, out
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml", "PIL", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_optimizes_and_trains_every_task_without_jax_opencv_yaml_or_pil():
    """Dynamic int8, magnitude and physical pruning, distillation, QAT and
    segment, pose and OBB training, with jax, cv2, yaml and PIL blocked."""
    subprocess.run([sys.executable, "-I", "-c", _OPTIMIZE_CODE.format(repo=str(REPO))], check=True, timeout=300,
                   env=TORCH_SUBPROCESS_ENV)


_PARALLEL_CODE = """
import datetime, sys, tempfile
for name in ("jax", "yolo_infer_tpu", "cv2", "yaml", "PIL"):
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as td
import yolo_infer_tpu_torch.parallel
from yolo_infer_tpu_torch.core.predictor import Predictor
from yolo_infer_tpu_torch.core.train_step import init_train_state, make_optimizer, make_train_step
from yolo_infer_tpu_torch.core.trainer import MultiChipTrainer, create_trainer
from yolo_infer_tpu_torch.models.yolo11 import build_model
from yolo_infer_tpu_torch.parallel.dryrun import dryrun_multichip
from yolo_infer_tpu_torch.parallel.mesh import create_mesh, shard_batch
assert isinstance(create_trainer("yolo11n", multi_gpu=True, device="cpu", device_ids=[0]), MultiChipTrainer)
td.init_process_group("gloo", store=td.FileStore(tempfile.mkdtemp() + "/store", 1), rank=0, world_size=1,
                      timeout=datetime.timedelta(seconds=120))
mesh = create_mesh()
model, spec = build_model("detect", "n", 2, seed=0)
tx = make_optimizer(0.01, total_steps=2, warmup_steps=0)
rng = np.random.default_rng(0)
batch = {{"images": torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)),
         "boxes": torch.tensor([[[4.0, 4.0, 20.0, 24.0]]] * 2), "classes": torch.zeros((2, 1), dtype=torch.int32),
         "mask": torch.ones((2, 1), dtype=torch.bool)}}
ts, m = make_train_step(spec, tx, compute_dtype=torch.float32, mesh=mesh)(init_train_state(model, tx),
                                                                          shard_batch(batch, mesh))
assert np.isfinite(float(m["loss"])) and int(ts.skipped) == 0
out = Predictor(model, spec, device="cpu", mesh=mesh).predict_raw(batch["images"], 0.0, 0.5, 32)
assert out["num"].shape == (2,)
assert np.isfinite(dryrun_multichip(1, device="cpu"))
td.destroy_process_group()
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml", "PIL", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_parallel_runs_without_jax_or_the_jax_package():
    """`yolo_infer_tpu_torch.parallel` and the meshed trainer, step, predictor
    and dry run in a gloo group of one, with jax, yolo_infer_tpu, cv2, yaml
    and PIL blocked."""
    subprocess.run([sys.executable, "-I", "-c", _PARALLEL_CODE.format(repo=str(REPO))], check=True, timeout=300,
                   env=TORCH_SUBPROCESS_ENV)


_FORMATS_CODE = """
import hashlib, json, sys, tempfile
from pathlib import Path
for name in ("jax", "cv2", "PIL", "yolo_infer_tpu"):
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
import numpy as np
from yolo_infer_tpu_torch.data.loader import load_image, save_image
fixtures = Path({repo!r}) / "tests" / "torch_formats"
manifest = json.loads((fixtures / "manifest.json").read_text())
for name, entry in manifest["files"].items():
    img = load_image(fixtures / name, rgb=False)
    assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"], name
frame = np.random.default_rng(0).integers(0, 256, (24, 40, 3), dtype=np.uint8)
with tempfile.TemporaryDirectory() as tmp:
    for suffix in (".bmp", ".tif", ".webp", ".jpg", ".png"):
        save_image(Path(tmp) / ("f" + suffix), frame)
        back = load_image(Path(tmp) / ("f" + suffix))
        assert back.shape == frame.shape and (suffix == ".jpg" or np.array_equal(back, frame)), suffix
assert not any(m.split(".")[0] in ("jax", "cv2", "PIL", "yolo_infer_tpu") for m in sys.modules
               if sys.modules[m] is not None)
"""


def test_port_reads_and_writes_every_image_format_without_opencv_or_pil():
    """Every committed fixture of `tests/torch_formats/` (lossy, alpha and
    animated WebP among them) decodes to its manifest's hash, and the port's
    writers round-trip, with jax, cv2, PIL and the JAX package blocked."""
    subprocess.run([sys.executable, "-I", "-c", _FORMATS_CODE.format(repo=str(REPO))], check=True, timeout=300,
                   env=TORCH_SUBPROCESS_ENV)


_SCRIPTS_CODE = """
import contextlib, io, json, os, sys, tempfile
from pathlib import Path
for name in ("jax", "yolo_infer_tpu", "cv2", "yaml", "PIL", "flax", "msgpack", "safetensors"):
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
from yolo_infer_tpu_torch.scripts import benchmark, export_dynamic, train
os.chdir(tempfile.mkdtemp())


def run(module, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main([*argv, "--device", "cpu"]) == 0
    return out.getvalue()


assert "compression" in run(export_dynamic, "yolo11n", "--output", "n_int8.msgpack")
assert list(json.loads(run(benchmark, "yolo11n", "--imgsz", "64", "--batch", "1", "--runs", "1", "--int8"))) == [
    "bf16", "int8_dynamic", "speedup"]
import numpy as np
from yolo_infer_tpu_torch.data.loader import create_dataset_config, save_image
for split in ("train", "val"):
    Path("labels", split).mkdir(parents=True)
    for i in range(2):
        save_image(Path("images", split, f"{{i}}.png"), np.full((64, 64, 3), 90 + 60 * i, np.uint8))
        Path("labels", split, f"{{i}}.txt").write_text("0 0.5 0.5 0.4 0.4\\n")
data = create_dataset_config("data.yaml", str(Path("images/train").resolve()), str(Path("images/val").resolve()),
                             {{0: "box"}})
try:
    run(train, "n_int8.msgpack", "--data", str(data), "--epochs", "1", "--batch", "2", "--imgsz", "64")
    raise AssertionError("the int8 file trained")
except ValueError as exc:
    assert "fused deploy checkpoint, int8" in str(exc), exc
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml", "PIL", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_scripts_run_without_jax_opencv_yaml_or_pil():
    """`yolo_infer_tpu_torch.scripts`: export_dynamic, benchmark with
    --int8 and train's refusal of the int8 file, with jax, the JAX package,
    cv2, yaml and PIL blocked (their imports are inside `main`)."""
    subprocess.run([sys.executable, "-I", "-c", _SCRIPTS_CODE.format(repo=str(REPO))], check=True, timeout=300,
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
    assert {"1", "3", "4.1", "4.2", "4.3", "5", "6", "8", "10", "11"} <= items
    cited = []
    for path in sorted((REPO / "yolo_infer_tpu_torch").rglob("*.py")):
        text = path.read_text()
        for m in re.finditer(r"Queue\s+1\s+items?\s+([\d.]+(?:\s+and\s+[\d.]+)?)", text):
            cited += [(path.name, n.rstrip(".")) for n in re.split(r"\s+and\s+", m.group(1))]
        cited += [(path.name, n) for n in re.findall(r"_NOT_PORTED\.format\((\d+)\)", text)]
    assert len(cited) >= 8
    missing = [c for c in cited if c[1] not in items]
    assert not missing, f"pointers to no item of ROADMAP Queue 1: {missing}"
